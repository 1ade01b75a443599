"""Counts of datagrams a UDP socket lost, and the buffers the kernel granted.

A datagram that arrives at a full receive buffer is dropped by the kernel
before the program sees it. Three counts of such losses, from the most
specific to the least:

- `SO_RXQ_OVFL`: with the option set, every datagram a `recvmsg` /
  `recvmmsg` returns carries, as a control message, the socket's own drop
  count when the datagram was queued (the kernel sends it only once the
  count is above 0). The native transport and `SimClient` read it.
- `SO_MEMINFO`: the socket's drop count read at any time with
  `getsockopt` (Linux 4.12+); the server's asyncio socket reads it.
- `/proc/net/snmp` `Udp: RcvbufErrors` and `InErrors`: the machine's
  counts over every UDP socket, labelled system-wide wherever they appear.

`granted_buffers` reads back SO_RCVBUF and SO_SNDBUF: the kernel caps what
a program asks for at rmem_max / wmem_max (and Linux reports twice the
granted size, its bookkeeping overhead included). `request_buffers` asks,
reads back, and where the kernel granted less asks again with
SO_RCVBUFFORCE / SO_SNDBUFFORCE, which pass the cap for a privileged
process (CAP_NET_ADMIN) and are refused otherwise.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Optional, Sequence, Tuple

# Linux values, for Pythons whose socket module does not name them.
SO_RXQ_OVFL = getattr(socket, "SO_RXQ_OVFL", 40)
SO_MEMINFO = getattr(socket, "SO_MEMINFO", 55)
SO_SNDBUFFORCE = getattr(socket, "SO_SNDBUFFORCE", 32)
SO_RCVBUFFORCE = getattr(socket, "SO_RCVBUFFORCE", 33)
_SK_MEMINFO_VARS = 9
_SK_MEMINFO_DROPS = 8
# Room for one SO_RXQ_OVFL control message (a uint32) on a recvmsg.
ANC_BUFSIZE = socket.CMSG_SPACE(4)
SNMP_PATH = "/proc/net/snmp"


def enable_rxq_ovfl(sock: socket.socket) -> bool:
    """Ask the kernel to attach the drop count to received datagrams."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, SO_RXQ_OVFL, 1)
        return True
    except OSError:
        return False


def rxq_ovfl(ancdata: Sequence[Tuple[int, int, bytes]]) -> Optional[int]:
    """The drop count in a recvmsg's control messages, or None (absent:
    no drop before this datagram was queued)."""
    for level, kind, data in ancdata:
        if level == socket.SOL_SOCKET and kind == SO_RXQ_OVFL and len(data) >= 4:
            return struct.unpack("I", data[:4])[0]
    return None


def socket_drops(sock: socket.socket) -> Optional[int]:
    """The socket's own drop count via SO_MEMINFO; None where the kernel
    does not give it."""
    try:
        raw = sock.getsockopt(socket.SOL_SOCKET, SO_MEMINFO,
                              4 * _SK_MEMINFO_VARS)
    except OSError:
        return None
    if len(raw) < 4 * _SK_MEMINFO_VARS:
        return None
    return struct.unpack(f"{_SK_MEMINFO_VARS}I",
                         raw[:4 * _SK_MEMINFO_VARS])[_SK_MEMINFO_DROPS]


def granted_buffers(sock: socket.socket) -> Tuple[int, int]:
    """(SO_RCVBUF, SO_SNDBUF) as the kernel reports them."""
    return (sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF),
            sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF))


def request_buffers(sock: socket.socket, rcvbuf: int, sndbuf: int
                    ) -> Tuple[int, int]:
    """Ask for receive and send buffers of the given sizes (past the
    kernel's cap where the process may); returns the granted sizes."""
    for opt, force, size in ((socket.SO_RCVBUF, SO_RCVBUFFORCE, rcvbuf),
                             (socket.SO_SNDBUF, SO_SNDBUFFORCE, sndbuf)):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, int(size))
            if sock.getsockopt(socket.SOL_SOCKET, opt) < size:
                sock.setsockopt(socket.SOL_SOCKET, force, int(size))
        except OSError:
            pass  # an unprivileged process keeps what the kernel granted
    return granted_buffers(sock)


def snmp_counters(path: Optional[str] = None) -> Dict[str, int]:
    """The machine's /proc/net/snmp counters as {"Udp.RcvbufErrors": n,
    "Ip.InDiscards": n, ...} (empty where the file is missing or
    unreadable)."""
    try:
        with open(path or SNMP_PATH) as f:
            lines = f.read().splitlines()
    except OSError:
        return {}
    out: Dict[str, int] = {}
    try:
        for head, vals in zip(lines[::2], lines[1::2]):
            name, _, keys = head.partition(":")
            out.update({f"{name}.{k}": int(v) for k, v in zip(
                keys.split(), vals.partition(":")[2].split())})
    except ValueError:
        return {}
    return out


class SystemUdpDrops:
    """The machine's UDP receive-buffer and input errors since this object
    was made (`Udp: RcvbufErrors`, `InErrors`): every UDP socket of the
    machine counts, this program's and its clients' alike."""

    KEYS = ("RcvbufErrors", "InErrors")

    def __init__(self) -> None:
        self._start = snmp_counters()

    def since_start(self) -> Dict[str, object]:
        now = snmp_counters()
        out: Dict[str, object] = {"scope": "system-wide"}
        for k in self.KEYS:
            key = f"Udp.{k}"
            out[k] = (now[key] - self._start.get(key, 0)) if key in now \
                else None
        return out
