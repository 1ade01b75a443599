"""Counts for every lost datagram: the port's socket statistics.

A datagram that meets a full receive buffer is dropped by the kernel before
any program sees it. The server reports, in /statusz `transport`, the
buffers the kernel granted its socket (SO_RCVBUF, SO_SNDBUF read back), the
socket's own overflow count (the native transport's SO_RXQ_OVFL, the asyncio
socket's SO_MEMINFO), and the machine's `Udp: RcvbufErrors` / `InErrors`
since its bind, labelled system-wide; `SimClient` counts its own receive
socket's overflows (SO_RXQ_OVFL). Overflows are made here for real: a
socket with a small buffer that nobody reads while datagrams arrive.
"""

import json
import os
import socket
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_server import (  # noqa: E402
    ServerHarness, _http, _poll, free_port, sim_config)
from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient  # noqa: E402
from zero_latency_yolo_tpu_torch.utils import netstats  # noqa: E402

SNMP = """Ip: Forwarding DefaultTTL InReceives
Ip: 1 64 100
Udp: InDatagrams NoPorts InErrors OutDatagrams RcvbufErrors SndbufErrors
Udp: {ind} 0 {ine} 50 {rcv} 0
UdpLite: InDatagrams NoPorts InErrors
UdpLite: 0 0 0
"""


def _write_snmp(path, ind=10, ine=2, rcv=1):
    path.write_text(SNMP.format(ind=ind, ine=ine, rcv=rcv))


def _overflow(rx: socket.socket, n: int = 300, size: int = 1200) -> int:
    """Send n datagrams to rx, which nobody reads; returns n."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _ in range(n):
            tx.sendto(b"\0" * size, rx.getsockname())
    finally:
        tx.close()
    return n


def _small_socket():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    s.bind(("127.0.0.1", 0))
    return s


def test_snmp_counters_and_the_system_wide_delta(tmp_path, monkeypatch):
    path = tmp_path / "snmp"
    _write_snmp(path, ind=10, ine=2, rcv=1)
    got = netstats.snmp_counters(str(path))
    assert got["Udp.InDatagrams"] == 10 and got["Udp.InErrors"] == 2
    assert got["Udp.RcvbufErrors"] == 1 and got["Ip.InReceives"] == 100
    assert got["UdpLite.InErrors"] == 0
    assert netstats.snmp_counters(str(tmp_path / "missing")) == {}
    monkeypatch.setattr(netstats, "SNMP_PATH", str(path))
    drops = netstats.SystemUdpDrops()
    _write_snmp(path, ind=40, ine=9, rcv=6)
    assert drops.since_start() == {"scope": "system-wide",
                                   "RcvbufErrors": 5, "InErrors": 7}
    monkeypatch.setattr(netstats, "SNMP_PATH", str(tmp_path / "missing"))
    assert netstats.SystemUdpDrops().since_start() == {
        "scope": "system-wide", "RcvbufErrors": None, "InErrors": None}


def test_request_buffers_passes_the_cap_when_privileged():
    """64 MiB is above the kernel's rmem_max / wmem_max here; a privileged
    process gets it with SO_RCVBUFFORCE / SO_SNDBUFFORCE, another keeps the
    capped size (and no error)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rcv, snd = netstats.request_buffers(s, 64 << 20, 64 << 20)
        assert (rcv, snd) == netstats.granted_buffers(s)
        if os.geteuid() == 0:
            assert rcv >= 64 << 20 and snd >= 64 << 20
        assert rcv > 0 and snd > 0
    finally:
        s.close()


def test_rxq_ovfl_parses_its_control_message():
    data = (7).to_bytes(4, "little")
    assert netstats.rxq_ovfl([(socket.SOL_SOCKET, netstats.SO_RXQ_OVFL,
                               data)]) == 7
    assert netstats.rxq_ovfl([]) is None
    assert netstats.rxq_ovfl([(socket.IPPROTO_IP, 1, data)]) is None


def test_a_real_overflow_is_counted_both_ways():
    """A 4 KiB socket nobody reads while 300 datagrams of 1200 B arrive:
    SO_MEMINFO's count and the SO_RXQ_OVFL carried by the datagrams read
    afterwards both equal the datagrams that never arrived."""
    rx = _small_socket()
    try:
        assert netstats.enable_rxq_ovfl(rx)
        rcv, snd = netstats.granted_buffers(rx)
        assert rcv > 0 and snd > 0
        sent = _overflow(rx)
        rx.setblocking(False)
        got, seen = 0, 0
        while True:
            try:
                _, anc, _, _ = rx.recvmsg(65536, netstats.ANC_BUFSIZE)
            except BlockingIOError:
                break
            got += 1
            seen = max(seen, netstats.rxq_ovfl(anc) or 0)
        dropped = sent - got
        assert dropped > 0
        if netstats.socket_drops(rx) is not None:
            assert netstats.socket_drops(rx) == dropped
        # The count rides on datagrams queued after the drops.
        _overflow(rx, n=1)
        time.sleep(0.05)
        _, anc, _, _ = rx.recvmsg(65536, netstats.ANC_BUFSIZE)
        assert netstats.rxq_ovfl(anc) == dropped
        assert seen <= dropped
    finally:
        rx.close()


def test_sim_client_counts_its_receive_overflows():
    """SimClient's receive socket: a small buffer, datagrams arriving while
    its receiver does not run, then the receiver drains them: rx_overflows
    counts the ones the kernel dropped; socket_stats reports the buffers."""
    c = SimClient(("127.0.0.1", free_port()), screen_width=96,
                  screen_height=64)
    try:
        assert c.rx_overflows == 0
        c.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        _overflow(c.sock)
        c.start_receiver()
        # The count rides on a datagram queued after the drops: send one
        # until the receiver has made room for it and read it.
        assert _poll(lambda: _overflow(c.sock, n=1) and time.sleep(0.05)
                     or (c.rx_overflows or 0) > 0, timeout=10)
        st = c.socket_stats()
        assert st["rcvbuf"] > 0 and st["sndbuf"] > 0
        assert st["rx_overflows"] == c.rx_overflows
    finally:
        c.stop()
    assert c.socket_stats()["rcvbuf"] is None  # closed


@pytest.fixture
def server_on(tmp_path, monkeypatch):
    """A simulation-mode server on either transport, its /statusz port, and
    a stub /proc/net/snmp (rewritten by the test)."""
    snmp = tmp_path / "snmp"
    _write_snmp(snmp)
    monkeypatch.setattr(netstats, "SNMP_PATH", str(snmp))
    made = []

    def make(native: bool):
        web = free_port(socket.SOCK_STREAM)
        h = ServerHarness(DetectionServer(sim_config(
            web_port=web, network={"use_native_transport": native,
                                   "recv_buffer_size": 1 << 20,
                                   "send_buffer_size": 1 << 19}),
            device="cpu"))
        made.append(h)
        return h.start(), web, snmp
    yield make
    for h in made:
        h.stop()


@pytest.mark.parametrize("native", [False, True])
def test_statusz_reports_buffers_and_overflows(server_on, native):
    from zero_latency_yolo_tpu_torch.runtime.transport import (
        HAVE_NATIVE_UDP_STATS)
    if native and not HAVE_NATIVE_UDP_STATS:
        pytest.skip("native codec library not built on this host")
    server, web, snmp = server_on(native)
    assert (type(server._transport).__name__ == "NativeUdpTransport") == native
    _write_snmp(snmp, ind=99, ine=12, rcv=8)
    data = _http(web, b"GET /statusz HTTP/1.1\r\nHost: x\r\n\r\n")
    st = json.loads(data.split(b"\r\n\r\n", 1)[1])["transport"]
    # Linux reports twice the granted size; a privileged server passes the
    # kernel's cap (request_buffers).
    if os.geteuid() == 0:
        assert st["rcvbuf"] >= 1 << 20 and st["sndbuf"] >= 1 << 19
    assert st["rcvbuf"] > 0 and st["sndbuf"] > 0
    assert st["rx_overflows"] == 0
    assert st["rx_overflows_source"] == ("SO_RXQ_OVFL" if native
                                         else "SO_MEMINFO")
    assert st["system_udp"] == {"scope": "system-wide", "RcvbufErrors": 7,
                                "InErrors": 10}
    assert "kernel_drops" in st


def test_native_transport_counts_its_overflows():
    """The native recvmmsg intake: while its batch handler is blocked the
    socket's small buffer overflows; the datagrams received after carry
    the drop count, and rx_overflows reads it."""
    from zero_latency_yolo_tpu_torch.runtime.transport import (
        HAVE_NATIVE_UDP_STATS, NativeUdpTransport)
    if not HAVE_NATIVE_UDP_STATS:
        pytest.skip("native codec library not built on this host")
    release = threading.Event()
    got = []

    def on_batch(batch):
        got.extend(batch)
        release.wait(5)
    t = NativeUdpTransport(free_port(), 4096, 4096, on_batch)
    try:
        assert t.rx_overflows == 0
        rcv, snd = t.buffer_sizes()
        assert rcv > 0 and snd > 0
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            tx.sendto(b"first", ("127.0.0.1", t.port))
            assert _poll(lambda: len(got) == 1, timeout=5)
            for _ in range(300):
                tx.sendto(b"\0" * 1200, ("127.0.0.1", t.port))
            release.set()
            lasts = []

            def last_seen():
                tx.sendto(b"last", ("127.0.0.1", t.port))
                lasts.append(1)
                time.sleep(0.05)
                return got[-1][0] == b"last"
            assert _poll(last_seen, timeout=10)
        finally:
            tx.close()
            rx.close()
        # Every datagram sent is received or dropped; the drops all came
        # before the last one, which was read.
        sent = 301 + len(lasts)
        assert t.rx_overflows == sent - len(got) > 0
    finally:
        release.set()
        t.close()
