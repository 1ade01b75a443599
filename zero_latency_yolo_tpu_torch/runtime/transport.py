"""Native UDP transport: C++ recvmmsg intake feeding the asyncio server.

A copy of the JAX package's `runtime/transport.py`, on the port's codec
library (`protocol/native.py`, built from `native/`).

Opt-in via `network.use_native_transport` (config). A drain thread blocks in
the C++ batch-receive (GIL released by ctypes for the call), then hands each
batch to the event loop in one call_soon_threadsafe — per-datagram Python
overhead collapses to per-batch overhead at high packet rates, replacing the
reference's recvfrom-per-loop thread (src/network/reliable_udp.cpp:465-539).

The v2 path additionally does ZLTY validation (header + CRC) and ACK
generation inside the C call (reference ACK-all semantics,
reliable_udp.cpp:602-605): the ACK leaves in one sendmmsg from the drain
thread without ever crossing into Python, and the loop thread receives
pre-parsed headers — no second CRC pass over JPEG payloads. Result bursts go
out through `send_many` (one sendmmsg per engine batch instead of one
sendto per client).

Falls back cleanly: if libzlcodec.so lacks the UDP symbols, the server keeps
its asyncio datagram endpoint.
"""

from __future__ import annotations

import ctypes
import errno
import socket
import struct
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..protocol import native as _codec
from ..utils.logging import get_logger

log = get_logger("transport")

# Each slot must hold the largest ZLTY datagram (MAX_PACKET_SIZE —
# IMPORTED, not duplicated: recvmmsg silently truncates to iov_len, so a
# raised protocol limit with a stale literal here would blackhole every
# large frame as a CRC/length bad_packet with no size error anywhere).
from ..protocol import MAX_PACKET_SIZE as _MAX_PACKET_SIZE

MAX_PKTS = 64
ARENA_CAP = MAX_PKTS * _MAX_PACKET_SIZE  # 4 MB arena

Addr = Tuple[str, int]
# (data, addr, header-or-None, already_acked); header = (type, seq, ts).
Datagram = Tuple[bytes, Addr, Optional[Tuple[int, int, int]], bool]


class _ZlPacketDesc(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_uint32),
                ("length", ctypes.c_uint32),
                ("ip_be", ctypes.c_uint32),
                ("port_be", ctypes.c_uint16),
                ("_pad", ctypes.c_uint16)]


class _ZlPacketDesc2(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_uint32),
                ("length", ctypes.c_uint32),
                ("ip_be", ctypes.c_uint32),
                ("port_be", ctypes.c_uint16),
                ("flags", ctypes.c_uint8),
                ("type", ctypes.c_uint8),
                ("sequence", ctypes.c_uint32),
                ("_pad", ctypes.c_uint32),
                ("timestamp", ctypes.c_uint64)]


class _ZlSendDesc(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_uint32),
                ("length", ctypes.c_uint32),
                ("ip_be", ctypes.c_uint32),
                ("port_be", ctypes.c_uint16),
                ("_pad", ctypes.c_uint16)]


_F_VALID = 1
_F_ACKED = 2


def _bind_udp_symbols(lib: ctypes.CDLL) -> bool:
    try:
        lib.zl_udp_open.restype = ctypes.c_int
        lib.zl_udp_open.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.zl_udp_recv_batch.restype = ctypes.c_int
        lib.zl_udp_recv_batch.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(_ZlPacketDesc), ctypes.c_int, ctypes.c_int]
        lib.zl_udp_send.restype = ctypes.c_int
        lib.zl_udp_send.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_uint32,
                                    ctypes.c_uint16]
        lib.zl_udp_close.restype = None
        lib.zl_udp_close.argtypes = [ctypes.c_int]
        return True
    except AttributeError:
        return False


def _bind_udp_open2_symbol(lib: ctypes.CDLL) -> bool:
    try:
        lib.zl_udp_open2.restype = ctypes.c_int
        lib.zl_udp_open2.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
        return True
    except AttributeError:
        return False


def _bind_udp_open3_symbol(lib: ctypes.CDLL) -> bool:
    try:
        lib.zl_udp_open3.restype = ctypes.c_int
        lib.zl_udp_open3.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
        return True
    except AttributeError:
        return False


def _bind_udp_v2_symbols(lib: ctypes.CDLL) -> bool:
    try:
        lib.zl_udp_recv_batch2.restype = ctypes.c_int
        lib.zl_udp_recv_batch2.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(_ZlPacketDesc2), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
        lib.zl_udp_send_batch.restype = ctypes.c_int
        lib.zl_udp_send_batch.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(_ZlSendDesc),
            ctypes.c_int]
        return True
    except AttributeError:
        return False


HAVE_NATIVE_UDP = _codec._LIB is not None and _bind_udp_symbols(_codec._LIB)
HAVE_NATIVE_UDP_V2 = HAVE_NATIVE_UDP and _bind_udp_v2_symbols(_codec._LIB)
# SO_REUSEPORT host sharding needs the zl_udp_open2 entry point (older .so
# builds lack it; the server falls back to the asyncio endpoint then).
HAVE_NATIVE_UDP_REUSEPORT = (HAVE_NATIVE_UDP
                             and _bind_udp_open2_symbol(_codec._LIB))
# Interface-scoped binds (network.bind_address) need zl_udp_open3.
HAVE_NATIVE_UDP_BIND_ADDR = (HAVE_NATIVE_UDP
                             and _bind_udp_open3_symbol(_codec._LIB))
_OPEN_REUSEPORT = 1  # zl_udp_open2 flags bit 0


def _pack_addr(addr: Addr) -> Tuple[int, int]:
    """(ip_be, port_be), network byte order — the ONE addr packing used for
    descriptors, sends, and the peer-key table (which must agree with the C
    side's zl_peer_known key math)."""
    return (struct.unpack("=I", socket.inet_aton(addr[0]))[0],
            socket.htons(addr[1]))


def _addr_key(addr: Addr) -> int:
    ip_be, port_be = _pack_addr(addr)
    return (ip_be << 16) | port_be


class NativeUdpTransport:
    """asyncio-transport-shaped wrapper over the C++ socket: sendto/close,
    plus a drain thread delivering inbound batches to a callback."""

    def __init__(self, port: int, recv_buffer: int, send_buffer: int,
                 on_batch: Callable[[List[Datagram]], None],
                 reuse_port: bool = False, bind_address: str = "") -> None:
        if not HAVE_NATIVE_UDP:
            raise RuntimeError("native UDP symbols unavailable")
        if reuse_port and not HAVE_NATIVE_UDP_REUSEPORT:
            raise RuntimeError(
                "native codec library lacks zl_udp_open2 (reuse_port "
                "sharding)")
        scoped = bind_address not in ("", "0.0.0.0")
        if scoped and not HAVE_NATIVE_UDP_BIND_ADDR:
            raise RuntimeError(
                "native codec library lacks zl_udp_open3 "
                "(network.bind_address)")
        self._lib = _codec._LIB
        flags = _OPEN_REUSEPORT if reuse_port else 0
        if scoped:
            fd = self._lib.zl_udp_open3(bind_address.encode(), port,
                                        recv_buffer, send_buffer, flags)
        elif reuse_port:
            fd = self._lib.zl_udp_open2(port, recv_buffer, send_buffer,
                                        flags)
        else:
            fd = self._lib.zl_udp_open(port, recv_buffer, send_buffer)
        if fd < 0:
            raise OSError(-fd, f"zl_udp_open({bind_address or '*'}:{port}) "
                               "failed")
        self.fd = fd
        self.port = port
        self.on_batch = on_batch
        self._arena = ctypes.create_string_buffer(ARENA_CAP)
        self._descs = (_ZlPacketDesc * MAX_PKTS)()
        self._descs2 = (_ZlPacketDesc2 * MAX_PKTS)()
        self._send_arena = ctypes.create_string_buffer(ARENA_CAP)
        self._send_descs = (_ZlSendDesc * MAX_PKTS)()
        # Sorted peer-key array for the C ACK filter. Replaced wholesale by
        # set_peers (loop thread); the drain thread reads the current
        # reference each iteration — assignment is atomic under the GIL.
        self._peers = (ctypes.c_uint64 * 0)()
        self.dropped = 0  # packets skipped by send_many on send errors
        # Set when the drain thread gave up on a permanent recv failure:
        # tx still works but nothing is ever read — the server surfaces
        # this instead of letting clients silently time out.
        self.rx_dead = False
        self._running = True
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="zlt-native-udp", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- peers
    def set_peers(self, addrs: Iterable[Addr]) -> None:
        """Install the known-client set for inline ACK generation."""
        keys = sorted(_addr_key(a) for a in addrs)
        self._peers = (ctypes.c_uint64 * len(keys))(*keys)

    # ---------------------------------------------------------------- sends
    def sendto(self, data: bytes, addr: Addr) -> int:
        """Single send; returns bytes sent or -errno (callers that count
        tx must check — see send_many's honest-counter contract)."""
        ip_be, port_be = _pack_addr(addr)
        return int(self._lib.zl_udp_send(self.fd, data, len(data),
                                         ip_be, port_be))

    def send_many(self, items: Sequence[Tuple[bytes, Addr]]
                  ) -> Tuple[int, int]:
        """Burst-send result packets: one sendmmsg per call (falls back to
        per-packet sendto when v2 symbols are absent). Returns
        (packets_sent, bytes_sent) — only what actually left the socket, so
        the caller's tx counters stay honest under partial sends."""
        if not HAVE_NATIVE_UDP_V2:
            sent = nbytes = 0
            for data, addr in items:
                if self.sendto(data, addr) >= 0:
                    sent += 1
                    nbytes += len(data)
                else:
                    self.dropped += 1
            return sent, nbytes
        sent_total = 0
        bytes_total = 0
        i = 0
        while i < len(items):
            chunk = items[i:i + MAX_PKTS]
            off = 0
            n = 0
            for data, addr in chunk:
                if off + len(data) > ARENA_CAP:
                    break
                ctypes.memmove(ctypes.addressof(self._send_arena) + off,
                               data, len(data))
                d = self._send_descs[n]
                d.offset = off
                d.length = len(data)
                d.ip_be, d.port_be = _pack_addr(addr)
                off += len(data)
                n += 1
            if n == 0:  # single oversized packet: fall back
                if self.sendto(*chunk[0]) >= 0:
                    sent_total += 1
                    bytes_total += len(chunk[0][0])
                else:
                    self.dropped += 1
                i += 1
                continue
            r = self._lib.zl_udp_send_batch(self.fd, self._send_arena,
                                            self._send_descs, n)
            if r == n:
                sent_total += r
                bytes_total += sum(len(d) for d, _ in chunk[:n])
                i += n
                continue
            # Partial/failed burst: the message at index max(r, 0) hit a
            # synchronous error or backpressure. Give that ONE message a
            # single-send retry, then move on — one unreachable client must
            # not drop results for healthy clients sharing the burst (the
            # old code advanced past the whole chunk, silently dropping the
            # unsent tail).
            r = max(r, 0)
            sent_total += r
            bytes_total += sum(len(d) for d, _ in chunk[:r])
            data, addr = items[i + r]
            rc = self.sendto(data, addr)
            if rc >= 0:
                sent_total += 1
                bytes_total += len(data)
            else:
                self.dropped += 1
            i += r + 1
        return sent_total, bytes_total

    def close(self) -> None:
        if self.fd < 0:
            return  # idempotent: a second close must not touch a reused fd
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                # The drain thread is wedged in on_batch (handler stuck on
                # a lock?). Closing the fd now would race its poll/recvmmsg
                # against a NUMBER THE KERNEL MAY REUSE — a later socket
                # with the same fd would have its datagrams consumed by
                # this zombie loop. Leak one fd instead; say so loudly.
                log.warning("native drain thread still running after 2s; "
                            "leaking fd %d instead of closing it under "
                            "the live loop", self.fd)
                self.fd = -1  # never re-enter; the fd is deliberately leaked
                return
        self._lib.zl_udp_close(self.fd)
        self.fd = -1

    # ----------------------------------------------------------------- recv
    def _drain_loop(self) -> None:
        # ONE loop for both .so generations (review r5): v1/v2 differ only
        # in the recv call and descriptor-to-Datagram conversion — the C
        # side unified zl_recv_prologue for the same reason (udp.cpp); a
        # future fix to the error/batch policy applied to one duplicated
        # loop and missed in the other would silently split intake
        # behavior between .so builds.
        v2 = HAVE_NATIVE_UDP_V2
        arena = self._arena
        descs = self._descs2 if v2 else self._descs
        base = ctypes.addressof(arena)
        consec_errs = 0
        while self._running:
            if v2:
                peers = self._peers  # snapshot: set_peers swaps the array
                n = self._lib.zl_udp_recv_batch2(
                    self.fd, arena, ARENA_CAP, descs, MAX_PKTS, 100,
                    peers, len(peers), 1)
            else:
                n = self._lib.zl_udp_recv_batch(
                    self.fd, arena, ARENA_CAP, descs, MAX_PKTS, 100)
            if n < 0:
                consec_errs += 1
                if self._recv_error(n, consec_errs):
                    return
                continue
            consec_errs = 0
            if n == 0:
                continue
            batch: List[Datagram] = []
            for i in range(n):
                d = descs[i]
                # Copy just this datagram out of the arena (arena.raw
                # would copy the whole 4 MB buffer per batch).
                data = ctypes.string_at(base + d.offset, d.length)
                ip = socket.inet_ntoa(struct.pack("=I", d.ip_be))
                addr = (ip, socket.ntohs(d.port_be))
                if v2 and d.flags & _F_VALID:
                    hdr = (d.type, d.sequence, d.timestamp)
                    batch.append((data, addr, hdr,
                                  bool(d.flags & _F_ACKED)))
                else:
                    batch.append((data, addr, None, False))
            try:
                self.on_batch(batch)
            except Exception:  # noqa: BLE001
                log.exception("native batch handler failed")

    _PERMANENT_ERRNOS = (errno.EBADF, errno.ENOTSOCK, errno.EINVAL)

    def _recv_error(self, n: int, consec: int) -> bool:
        """Shared error policy for the drain loops. Returns True when the
        loop should EXIT: EBADF/ENOTSOCK/EINVAL are not transient (the fd
        is gone or reused as something else — spinning logs ~8.6M
        lines/day AND the zombie poll interferes with the fd's new owner),
        and 500 consecutive failures (~5 s at the 10 ms backoff) means
        nothing is recovering either. Sets rx_dead so the server can
        SURFACE a one-sided outage (tx keeps working while nothing is ever
        read) instead of clients silently timing out."""
        log.warning("native recv error: errno=%d", -n)
        if -n in self._PERMANENT_ERRNOS or consec >= 500:
            log.error("native recv failure persists (errno=%d, %d "
                      "consecutive); drain thread exiting — transport is "
                      "RX-DEAD (restart the server/shard)", -n, consec)
            self.rx_dead = True
            return True
        time.sleep(0.01)  # no busy-spin while transient errors clear
        return False
