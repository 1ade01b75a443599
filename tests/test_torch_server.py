"""The PyTorch port's UDP server over loopback, on the CPU.

The simulation-mode cases of tests/test_server_e2e.py, run on the port's
DetectionServer (device="cpu", its device frame cache on the CPU by
default) and driven by the port's SimClient; then the slice as a whole
against the JAX server on the same params and frames, each server driven by
the other package's client, without the device cache and with it on both
sides; then the repairs of the engine surface the server reads. Ports are
found free at run time (test files run in parallel).
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from zero_latency_yolo_tpu_torch.config import ServerConfig
from zero_latency_yolo_tpu_torch.protocol import (
    AckPacket, CommandPacket, CommandType, ConfigUpdatePacket,
    HeartbeatPacket, parse_packet,
)
from zero_latency_yolo_tpu_torch.runtime.server import (
    REL_WND_INIT, REL_WND_MAX, ClientSession, DetectionServer, PendingPacket,
)
from zero_latency_yolo_tpu_torch.runtime.simulator import (
    FaultInjector, SimClient, synthetic_frame,
)
import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)

REPO = Path(__file__).resolve().parent.parent
WAIT = 20.0  # seconds a test waits for the server; generous under load


def free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sim_config(**over) -> ServerConfig:
    d = {
        "model_path": "/nonexistent/model.npz",  # => simulation mode
        "port": free_port(), "web_port": 0, "max_clients": 4,
        "max_queue_size": 8,
        "network": {"timeout_ms": 5000},
        "detection": {"enable_tracking": True, "max_tracking_age_ms": 500},
        "tpu": {"batch_window_ms": 1.0, "frame_buckets": [[128, 128]],
                "batch_buckets": [1, 2, 4]},
    }
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            d[k] = {**d[k], **v}
        else:
            d[k] = v
    return ServerConfig.from_dict(d)


class ServerHarness:
    """A server on its own event loop thread."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)

    def run(self, coro, timeout=WAIT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def start(self, warmup=False):
        self.thread.start()
        self.run(self.server.start(warmup=warmup), timeout=300)
        return self.server

    def stop(self):
        self.run(self.server.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


@pytest.fixture(scope="module")
def harness():
    h = ServerHarness(DetectionServer(sim_config(), device="cpu"))
    server = h.start()
    assert server.engine.simulation
    yield server
    h.stop()


@pytest.fixture
def fresh():
    """A server of its own, stopped after the test: fresh(**config)."""
    made = []

    def make(use_device_cache=True, **over):
        h = ServerHarness(DetectionServer(sim_config(**over), device="cpu",
                                          use_device_cache=use_device_cache))
        made.append(h)
        return h.start()
    yield make
    for h in made:
        h.stop()


def _client(port, cls=SimClient, **kw):
    return cls(("127.0.0.1", port), screen_width=96, screen_height=64, **kw)


def _poll(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _http(port, raw: bytes) -> bytes:
    sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
    sock.settimeout(WAIT)
    sock.sendall(raw)
    data = b""
    try:
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    except OSError:
        pass
    sock.close()
    return data


# ------------------------------------------------------- simulation mode

def test_handshake(harness):
    c = _client(harness.port)
    try:
        pkt = c.connect()
        assert pkt.info.max_clients == 4
        assert pkt.info.protocol_version == 1
        assert harness.client_count() >= 1
    finally:
        c.stop()


def test_raw_frame_to_detection_result(harness):
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        fid = c.send_raw_frame(synthetic_frame(96, 64, seed=1))
        results = c.wait_results(1, timeout=WAIT)
        assert results, "no detection result received"
        assert results[0].frame_id == fid
        assert len(results[0].detections) <= 32
        for d in results[0].detections:  # tracking on
            assert d.track_id > 0
    finally:
        c.stop()


def test_roi_update_dropped_without_cache(fresh):
    """Without the device frame cache (use_device_cache=False, as in the
    JAX server) a JPEG keyframe is served from host memory and an ROI
    update, which patches the cached frame, is dropped."""
    harness = fresh(use_device_cache=False)
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        kf = c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=2))
        assert [r.frame_id for r in c.wait_results(1, timeout=WAIT)] == [kf]
        served = harness.engine.inference_count.value
        c.send_roi_update(synthetic_frame(32, 16, seed=3), x=8, y=8)
        time.sleep(0.3)
        assert harness.engine.inference_count.value == served
        assert harness.status()["frame_cache"] is None
    finally:
        c.stop()


def test_jpeg_and_roi_stream(harness):
    """The default server (device frame cache on) serves a JPEG keyframe
    and the ROI update after it; the cache holds the client's frame."""
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        kf_id = c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=2))
        roi_id = c.send_roi_update(synthetic_frame(32, 16, seed=3), x=8, y=8)
        # Per-client supersede semantics: when both frames land in the same
        # batch window, the older one is dropped — but the NEWEST frame must
        # always be answered.
        deadline = time.monotonic() + WAIT
        got = []
        while time.monotonic() < deadline:
            got = [r.frame_id for r in c.wait_results(1, timeout=1.0)]
            if roi_id in got:
                break
        assert roi_id in got, f"newest frame unanswered; got {got}"
        assert set(got) <= {kf_id, roi_id}
        cid = max(harness._sessions.keys())
        assert harness.device_cache.has_frame(cid)
        fc = harness.status()["frame_cache"]
        assert fc["slots_total"] == 4 and fc["slots_used"] >= 1
        assert fc["writes_flushed"] >= 1 and fc["cache_rejects"] == 0
    finally:
        c.stop()


def test_eviction_does_not_leak_cache_slots(harness):
    """Client churn with frames still in the decode queue must not leak
    device-cache slots (cleanup is ordered through the decode worker): after
    max_clients churn cycles, a new client still connects and serves."""
    for i in range(6):  # > max_clients=4 churn rounds
        c = _client(harness.port)
        c.connect()
        c.start_receiver()
        c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=i))
        c.stop()  # DISCONNECT with the keyframe possibly still queued
        time.sleep(0.05)
    cache = harness.device_cache
    assert _poll(lambda: len(cache._free) == cache.num_slots)
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=99))
        assert len(c.wait_results(1, timeout=WAIT)) == 1
    finally:
        c.stop()
    assert _poll(lambda: len(cache._free) == cache.num_slots)


def test_request_keyframe_recovery(fresh):
    """A shed-frozen cache slot => the server sends COMMAND(REQUEST_KEYFRAME);
    the client re-anchors with an immediate keyframe instead of waiting out
    its keyframe cadence, and the slot unfreezes."""
    from zero_latency_yolo_tpu_torch.runtime.simulator import StreamDriver
    server = fresh(tpu={"batch_buckets": [1, 2]})
    server.device_cache.warm()
    server.device_cache._max_pending = 0  # every pending ROI write sheds
    c = _client(server.port)
    stream = StreamDriver(c, keyframe_interval=1000)  # cadence never fires
    try:
        c.connect()
        c.start_receiver()
        frame = synthetic_frame(96, 64, seed=1)
        assert stream.push(frame) is not None      # keyframe primes the slot
        assert c.wait_results(1, timeout=WAIT)
        frame2 = frame.copy()
        frame2[8:24, 8:24] = 255                   # small change => ROI path
        stream.push(frame2)
        assert stream.roi_sent == 1
        # The shed freezes the slot; the server must command a keyframe.
        assert _poll(lambda: c.keyframe_requested)
        assert c.keyframe_requests_seen >= 1
        assert _poll(lambda: server.keyframe_requests.value >= 1)
        # Next capture re-anchors as a keyframe (flag consumed by push).
        kf_before = stream.keyframes_sent
        assert stream.push(frame2) is not None
        assert stream.keyframes_sent == kf_before + 1
        assert _poll(lambda: server.device_cache.frozen_clients() == [])
    finally:
        c.stop()


def test_stop_stream_releases_the_cache_slot(harness):
    """STOP_STREAM frees the client's cache slot while its session stays;
    DISCONNECT frees the rest: /statusz's frame_cache.slots_used follows."""
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        c.send_raw_frame(synthetic_frame(96, 64, seed=5))
        assert c.wait_results(1, timeout=WAIT)
        cid = max(harness._sessions.keys())
        assert harness.device_cache.slot(cid) is not None
        c.send_command(CommandType.STOP_STREAM)
        assert _poll(lambda: harness.device_cache.slot(cid) is None)
        assert cid in harness._sessions
    finally:
        c.stop()
    assert _poll(lambda: harness.status()["frame_cache"]["slots_used"] == 0)


def test_heartbeat_echo(harness):
    c = _client(harness.port)
    try:
        c.connect()
        c.heartbeat(ping=123)
        deadline = time.monotonic() + WAIT
        got = False
        c.sock.settimeout(0.5)
        while time.monotonic() < deadline and not got:
            try:
                data, _ = c.sock.recvfrom(65536)
            except OSError:
                continue
            try:
                pkt = parse_packet(data)
            except Exception:
                continue
            if isinstance(pkt, HeartbeatPacket):
                assert pkt.ping == 123
                got = True
        assert got
    finally:
        c.stop()


def test_server_full(fresh):
    server = fresh(max_clients=2)
    clients = []
    try:
        for _ in range(2):
            c = _client(server.port)
            c.connect()
            clients.append(c)
        extra = _client(server.port)
        clients.append(extra)
        with pytest.raises((ConnectionRefusedError, TimeoutError)):
            extra.connect()
    finally:
        for c in clients:
            c.stop()


def test_corrupt_packets_counted_not_fatal(harness):
    before = harness.bad_packets.value
    c = _client(harness.port, faults=FaultInjector(corrupt=1.0))
    try:
        c.sock.sendto(b"garbage-not-a-packet", ("127.0.0.1", harness.port))
        c.heartbeat()  # corrupted by the injector
        assert _poll(lambda: harness.bad_packets.value >= before + 1)
        c2 = _client(harness.port)
        try:
            c2.connect()  # still serves a clean client
        finally:
            c2.stop()
    finally:
        c.stop()


def test_frame_from_unknown_client_answered_with_nak(harness):
    c = _client(harness.port)  # never connects
    try:
        naks = harness.unknown_sender_naks.value
        served = harness.engine.inference_count.value
        c.send_raw_frame(synthetic_frame(96, 64))
        assert _poll(lambda: harness.unknown_sender_naks.value == naks + 1)
        assert harness.engine.inference_count.value == served
    finally:
        c.stop()


def test_frames_from_unknown_senders_are_counted(harness):
    """Every frame from a sender without a session is counted as refused
    (frames_unknown_sender), though the NAK that answers it is
    rate-limited to one a second."""
    c = _client(harness.port)  # never connects
    try:
        naks = harness.unknown_sender_naks.value
        refused = harness.frames_unknown_sender.value
        for seed in range(3):
            c.send_raw_frame(synthetic_frame(96, 64, seed=seed))
        assert _poll(lambda: harness.frames_unknown_sender.value
                     == refused + 3)
        assert harness.unknown_sender_naks.value == naks + 1
        st = harness.status()["transport"]
        assert st["frames_unknown_sender"] == refused + 3
    finally:
        c.stop()


def test_stop_counts_held_frames_and_logs_its_last_counts(caplog):
    """Frames a stopping server still holds (queued for the batcher, or for
    a decode worker) are counted as drops, and stop() logs the process's
    frame counts as its last line, which a fleet's accounting reads."""
    import logging
    server = DetectionServer(sim_config(worker_threads=2), device="cpu")
    for fid in (1, 2):
        server.batcher.submit(_frame_request(1, fid))
    server._decode_queues[0].put_nowait(("__cleanup__", 7))
    server._decode_queues[1].put_nowait((object(), 3, 0, 96, 64, True,
                                         b"", None))
    with caplog.at_level(logging.INFO):
        asyncio.run(server.stop())
    assert server.engine.frames_dropped.value == 3
    assert server.batcher.queue_depth() == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("server stopped: ")]
    assert len(lines) == 1
    counts = json.loads(lines[0][len("server stopped: "):])
    assert counts == {**server.frame_counts(), "rx_overflows": None}
    assert counts["pid"] == os.getpid() and counts["dropped"] == 3


def test_stop_reads_the_socket_empty_before_closing_it():
    """stop() waits until the UDP socket holds no datagram before closing
    it (a datagram queued there at the close would vanish uncounted), and
    _rx_pending reads the next datagram's size from the socket."""
    server = DetectionServer(sim_config(), device="cpu")
    assert server._rx_pending() is None  # no transport
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx, \
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        rx.bind(("127.0.0.1", 0))

        class Transport:  # the native transport's surface stop() reads
            fd = rx.fileno()
            rx_overflows = None

            def buffer_sizes(self):
                return None

            def close(self):
                pass
        server._transport = Transport()
        assert server._rx_pending() == 0
        tx.sendto(b"x" * 100, rx.getsockname())
        assert _poll(lambda: server._rx_pending() == 100)
        reads = iter([100, 100, 0])
        server._rx_pending = lambda: next(reads)
        asyncio.run(server.stop())
        assert next(reads, "empty") == "empty"


def test_multi_stream_batching(harness):
    clients = []
    try:
        for _ in range(2):
            c = _client(harness.port)
            c.connect()
            c.start_receiver()
            clients.append(c)
        for step in range(5):
            for c in clients:
                c.send_raw_frame(synthetic_frame(96, 64, seed=step))
            time.sleep(0.01)
        for c in clients:
            assert len(c.wait_results(3, timeout=WAIT)) >= 3
    finally:
        for c in clients:
            c.stop()


def test_status_snapshot(harness):
    import gc

    from zero_latency_yolo_tpu_torch.utils.gcstats import LATENCY_THRESHOLDS
    c = _client(harness.port)
    try:
        c.connect()
    finally:
        c.stop()
    st = harness.status()
    assert st["server"] == "zero_latency_yolo_tpu_torch"
    assert st["transport"]["packets_received"] > 0
    assert st["engine"]["simulation"] == "true"
    assert st["engine"]["device"] == "cpu"
    assert st["engine"]["errors"] == "0"
    hg = st["host_gc"]
    assert hg["thresholds"] == list(LATENCY_THRESHOLDS)
    assert gc.get_threshold() == LATENCY_THRESHOLDS
    assert hg["frozen"] > 0 and hg["pause_total_ms"] >= 0.0


def test_config_update_applies_thresholds(harness):
    c = _client(harness.port)
    c.connect()
    try:
        c._send(ConfigUpdatePacket(settings={
            "confidence_threshold": 0.61, "nms_threshold": 0.37,
            "bogus_key": 1}).serialize())
        assert _poll(lambda: harness.config.confidence_threshold == 0.61)
        assert harness.config.nms_threshold == 0.37
        for bad in ("nope", float("nan"), float("inf"), 2.5, -0.1):
            c._send(ConfigUpdatePacket(
                settings={"confidence_threshold": bad}).serialize())
        time.sleep(0.5)
        assert harness.config.confidence_threshold == 0.61
    finally:
        c.stop()


def test_config_update_refusal_is_echoed(harness):
    """A refused CONFIG_UPDATE answers with an ERROR carrying the reason:
    a min_serve_size above the model size, and an adaptive SLO, which needs
    a warmed serve-size ladder (this server's config has none)."""
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        for settings, word in (({"min_serve_size": 99999}, "min_serve_size"),
                               ({"adaptive_slo_ms": 5.0}, "adaptive_slo_ms")):
            c._send(ConfigUpdatePacket(settings=settings).serialize())

            def seen():
                with c._lock:
                    return [e.message for e in c.errors if word in e.message]
            assert _poll(lambda: bool(seen())), f"{word} refusal not echoed"
        assert "raise-only" in seen()[0] or "refused" in seen()[0]
    finally:
        c.stop()


def test_stream_control_pause_resume_stop(harness):
    """PAUSE sheds frames at ingest with the session kept; RESUME answers
    with a REQUEST_KEYFRAME; STOP releases the tracker state; START revives
    the stream."""
    c = _client(harness.port)
    try:
        c.connect()
        c.start_receiver()
        c.send_raw_frame(synthetic_frame(96, 64, seed=11))
        assert c.wait_results(1, timeout=WAIT)
        cid = harness._by_addr[("127.0.0.1", c.sock.getsockname()[1])]

        c.pause_stream()
        assert _poll(lambda: harness._sessions[cid].paused)
        base = harness.frames_paused.value
        n_results = len(c.wait_results(0, timeout=0))
        c.send_raw_frame(synthetic_frame(96, 64, seed=12))
        c.send_raw_frame(synthetic_frame(96, 64, seed=13))
        assert _poll(lambda: harness.frames_paused.value >= base + 2)
        time.sleep(0.25)
        assert len(c.wait_results(0, timeout=0)) == n_results
        assert cid in harness._sessions

        kf_seen = c.keyframe_requests_seen
        c.resume_stream()
        assert _poll(lambda: not harness._sessions[cid].paused)
        assert _poll(lambda: c.keyframe_requests_seen > kf_seen)
        c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=14))
        assert _poll(lambda: len(c.wait_results(0, timeout=0)) > n_results)

        c.stop_stream()
        assert _poll(lambda: harness._sessions[cid].paused)
        kf_seen = c.keyframe_requests_seen
        c.start_stream()
        assert _poll(lambda: c.keyframe_requests_seen > kf_seen)
        n_results = len(c.wait_results(0, timeout=0))
        c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=15))
        assert _poll(lambda: len(c.wait_results(0, timeout=0)) > n_results)
        assert harness.status()["frames_paused"] >= 2
    finally:
        c.stop()


def test_karn_rtt_sampling_and_backoff(harness):
    s = ClientSession(client_id=1, addr=("127.0.0.1", 1))
    s.pending[7] = PendingPacket(data=b"x", addr=s.addr,
                                 sent_at=time.monotonic() - 0.3)
    harness._handle_ack(AckPacket(acked_sequence=7), s)
    assert s.srtt is not None and 0.25 < s.srtt < 0.4
    srtt = s.srtt
    s.pending[8] = PendingPacket(data=b"x", addr=s.addr,
                                 sent_at=time.monotonic(), retries=1)
    harness._handle_ack(AckPacket(acked_sequence=8), s)
    assert 8 not in s.pending and s.srtt == srtt
    s.rto = 0.2
    assert [min(s.rto * (1 << r), 2.0) for r in range(5)] == [
        0.2, 0.4, 0.8, 1.6, 2.0]


def test_reliable_inflight_window(harness):
    s = ClientSession(client_id=999, addr=("127.0.0.1", 9))
    shed0 = harness.reliable_shed.value
    for _ in range(50):
        harness._send_reliable(CommandPacket(
            command_type=CommandType.REQUEST_KEYFRAME).serialize(), s)
    assert len(s.pending) == int(REL_WND_INIT)
    assert harness.reliable_shed.value - shed0 == 50 - int(REL_WND_INIT)
    now = time.monotonic()
    s.backoff_window(now)
    assert s.cwnd == REL_WND_INIT / 2
    s.backoff_window(now + s.rto / 2)
    assert s.cwnd == REL_WND_INIT / 2
    for k in (2, 4, 8):
        s.backoff_window(now + k * s.rto)
    assert s.cwnd == 1.0
    for seq in list(s.pending):
        harness._handle_ack(AckPacket(acked_sequence=seq), s)
    assert s.cwnd > 1.0 and not s.pending
    s.cwnd = REL_WND_MAX
    s.pending[123456] = PendingPacket(data=b"x", addr=s.addr,
                                      sent_at=time.monotonic())
    s.ack_pending(123456)
    assert s.cwnd == REL_WND_MAX


def test_reliable_window_backoff_once_per_tick(harness):
    s = ClientSession(client_id=998, addr=("127.0.0.1", 8))
    old = time.monotonic() - 10.0
    for seq in (1, 2, 3):
        s.pending[seq] = PendingPacket(data=b"zlt", addr=s.addr, sent_at=old)
    now = time.monotonic()
    for seq in list(s.pending):
        p = s.pending[seq]
        p.retries += 1
        p.sent_at = now
        s.backoff_window(now)
    assert s.cwnd == REL_WND_INIT / 2
    t0 = time.perf_counter()
    s.cwnd = 1.0
    for _ in range(1000):
        harness._send_reliable(
            CommandPacket(command_type=CommandType.PING).serialize(), s)
    assert time.perf_counter() - t0 < 1.0
    assert len(s.pending) == 3


def test_shed_keyframe_request_does_not_burn_rate_limit(harness):
    s = ClientSession(client_id=997, addr=("127.0.0.1", 7))
    s.cwnd = 1.0
    s.pending[1] = PendingPacket(data=b"x", addr=s.addr,
                                 sent_at=time.monotonic())
    harness._sessions[997] = s
    try:
        kf0 = harness.keyframe_requests.value
        shed0 = harness.reliable_shed.value
        harness._send_keyframe_requests([997])
        assert harness.keyframe_requests.value == kf0
        assert harness.reliable_shed.value == shed0 + 1
        assert s.last_kf_request == 0.0
        s.ack_pending(1)
        harness._send_keyframe_requests([997])
        assert harness.keyframe_requests.value == kf0 + 1
        assert s.last_kf_request > 0.0
    finally:
        harness._sessions.pop(997, None)


def test_http_header_line_cap(fresh):
    web = free_port(socket.SOCK_STREAM)
    fresh(web_port=web)
    assert _http(web, b"GET /statusz HTTP/1.1\r\nHost: x\r\n\r\n"
                 ).startswith(b"HTTP/1.1 200")
    junk = b"".join(b"X-Junk-%d: y\r\n" % i for i in range(200))
    assert _http(web, b"GET /statusz HTTP/1.1\r\n" + junk) == b""


def test_statusz_and_profilez_over_http(fresh, tmp_path):
    """GET /statusz answers with the engine's status; GET /profilez with the
    capture status (the profiler is wired)."""
    web = free_port(socket.SOCK_STREAM)
    fresh(web_port=web, logging={"log_file": str(tmp_path / "s.log")})
    data = _http(web, b"GET /statusz HTTP/1.1\r\nHost: x\r\n\r\n")
    assert data.startswith(b"HTTP/1.1 200")
    st = json.loads(data.split(b"\r\n\r\n", 1)[1])
    assert st["engine"]["engine"] == "torch-cuda"
    data = _http(web, b"GET /profilez HTTP/1.1\r\nHost: x\r\n\r\n")
    assert data.startswith(b"HTTP/1.1 200")
    assert set(json.loads(data.split(b"\r\n\r\n", 1)[1])) == {
        "capturing", "last"}


def _http_json(port, method, path):
    data = _http(port, f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                       "Content-Length: 0\r\n\r\n".encode())
    head, body = data.split(b"\r\n\r\n", 1)
    return int(head.split()[1]), json.loads(body)


def test_profilez_routes_on_the_port_server(fresh, tmp_path):
    """The cases of tests/test_web.py's /profilez test on the port's server
    with its real capture: GET reports status; POST in range captures a
    Chrome trace under the log directory's torch-trace/; out of range or
    malformed 400; a POST while a capture runs 409."""
    web = free_port(socket.SOCK_STREAM)
    fresh(web_port=web, logging={"log_file": str(tmp_path / "s.log")})
    code, st = _http_json(web, "GET", "/profilez")
    assert code == 200 and st["capturing"] is False
    code, out = _http_json(web, "POST", "/profilez?seconds=0.1")
    assert code == 200 and out["ok"] and out["seconds"] == 0.1
    assert Path(out["dir"]).parent == tmp_path / "torch-trace"
    names = [f["name"] for f in out["files"]]
    assert names == ["trace.json"] and out["files"][0]["size"] > 0
    assert json.loads((Path(out["dir"]) / "trace.json").read_text())
    code, st = _http_json(web, "GET", "/profilez")
    assert code == 200 and st["last"]["dir"] == out["dir"]
    for bad in ("99", "0.001", "abc", "nan"):
        assert _http_json(web, "POST", f"/profilez?seconds={bad}")[0] == 400
    long = threading.Thread(
        target=lambda: _http_json(web, "POST", "/profilez?seconds=1.5"))
    long.start()
    try:
        assert _poll(lambda: _http_json(web, "GET", "/profilez")[1][
            "capturing"])
        code, out = _http_json(web, "POST", "/profilez?seconds=0.1")
        assert code == 409 and "in flight" in out["error"]
    finally:
        long.join(timeout=WAIT)


def test_profilez_capture_overlapping_engine_calls(tmp_path, monkeypatch):
    """A capture while the batcher serves a real model on the CPU: the
    profiler starts and stops only while no engine call runs (the batcher's
    device_gate), the trace holds the step's operators, and every frame
    sent during the capture is served."""
    import torch.profiler as tp
    cfg = sim_config(web_port=0, logging={"log_file": str(tmp_path / "s.log")},
                     tpu={"frame_buckets": [[96, 96]], "batch_buckets": [1, 2],
                          "batch_window_ms": 1.0})
    engine = _pico_engine()
    inside, events = [0], []
    for name in ("dispatch", "complete_many"):
        real = getattr(engine, name)

        def wrapped(*a, _real=real, **k):
            inside[0] += 1
            try:
                time.sleep(0.002)  # widen the window a stop could hit
                return _real(*a, **k)
            finally:
                inside[0] -= 1
        setattr(engine, name, wrapped)

    class Watched(tp.profile):
        def start(self):
            events.append(("start", inside[0]))
            return super().start()

        def stop(self):
            events.append(("stop", inside[0]))
            return super().stop()
    monkeypatch.setattr(tp, "profile", Watched)
    h = ServerHarness(DetectionServer(cfg, engine=engine, device="cpu",
                                      use_device_cache=False))
    server = h.start()
    c = _client(server.port)
    try:
        c.connect()
        c.start_receiver()
        from zero_latency_yolo_tpu_torch.utils import profiling
        result = {}
        t = threading.Thread(target=lambda: result.update(
            server.management.profile_fn(0.6)))
        t.start()
        sent = 0
        while t.is_alive() and sent < 400:
            c.send_raw_frame(synthetic_frame(96, 64, seed=sent))
            sent += 1
            time.sleep(0.01)
        t.join(timeout=WAIT)
        assert result.get("ok"), result
        got = c.wait_results(1, timeout=WAIT)
        assert got
        assert _poll(lambda: server.engine.inference_count.value
                     + server.engine.frames_dropped.value >= sent)
        assert [e[0] for e in events] == ["start", "stop"]
        assert all(n == 0 for _, n in events), events
        trace = (Path(result["dir"]) / "trace.json").read_text()
        assert "aten::conv2d" in trace
        assert profiling.capture_status()["capturing"] is False
    finally:
        c.stop()
        h.stop()


def test_bind_address_scopes_udp_and_web(fresh):
    web = free_port(socket.SOCK_STREAM)
    server = fresh(web_port=web, max_clients=2,
                   network={"bind_address": "127.0.0.1",
                            "web_bind_address": "127.0.0.1"})
    c = _client(server.port)
    try:
        c.connect()
        c.start_receiver()
        c.send_raw_frame(synthetic_frame(96, 64))
        assert c.wait_results(1, timeout=WAIT)
        data = _http(web, b"GET /statusz HTTP/1.1\r\nHost: x\r\n\r\n")
        assert data.startswith(b"HTTP/1.1 200")
        assert json.loads(data.split(b"\r\n\r\n", 1)[1])["clients"] == 1
    finally:
        c.stop()


def test_web_auth_token_e2e(fresh, tmp_path):
    web = free_port(socket.SOCK_STREAM)
    fresh(web_port=web, model_path=str(tmp_path / "missing.npz"),
          network={"web_auth_token": "hunter2hunter2"})
    assert _http(web, b"GET /statusz HTTP/1.1\r\nHost: x\r\n\r\n"
                 ).startswith(b"HTTP/1.1 200")
    body = b"not-really-weights"
    post = (b"POST /api/models/upload?name=e2e.npz HTTP/1.1\r\n"
            b"Host: x\r\nContent-Length: %d\r\n" % len(body))
    assert _http(web, post + b"\r\n" + body).startswith(b"HTTP/1.1 401")
    assert _http(web, post + b"Authorization: Bearer wrong\r\n\r\n" + body
                 ).startswith(b"HTTP/1.1 401")
    ok = _http(web, post + b"Authorization: bearer hunter2hunter2\r\n\r\n"
               + body)
    assert ok.startswith(b"HTTP/1.1 200"), ok[:200]
    ok2 = _http(web, post + b"Authorization: hunter2hunter2\r\n\r\n" + body)
    assert ok2.startswith(b"HTTP/1.1 200"), ok2[:200]
    bad = _http(web, post + b"Authorization: Bearer \xff\xfe\xfd\r\n\r\n"
                + body)
    assert bad.startswith(b"HTTP/1.1 401"), bad[:200]
    assert (tmp_path / "e2e.npz").read_bytes() == body


def test_allow_client_config_off_locks_global_thresholds(fresh):
    server = fresh(max_clients=2, confidence_threshold=0.5,
                   network={"allow_client_config": False})
    c = _client(server.port)
    try:
        c.connect()
        c.start_receiver()
        c.send_command(CommandType.SET_CONFIG,
                       b'{"confidence_threshold": 0.99}')
        assert _poll(lambda: c.errors_seen >= 1)
        assert server.engine.config.confidence_threshold == 0.5
        before = c.errors_seen
        c._send(ConfigUpdatePacket(
            settings={"confidence_threshold": 0.99}).serialize())
        assert _poll(lambda: c.errors_seen > before)
        assert server.engine.config.confidence_threshold == 0.5
        c.send_command(CommandType.GET_CONFIG)

        def echo():
            with c._lock:
                return [p for p in c.commands
                        if p.command_type == CommandType.GET_CONFIG]
        assert _poll(lambda: bool(echo())), "GET_CONFIG must stay read-open"
        body = json.loads(echo()[0].command_data)
        assert body["confidence_threshold"] == 0.5
        assert body["serve_size"] == server.engine.model_size
    finally:
        c.stop()


def test_stop_start_restart_accepts_clients():
    h = ServerHarness(DetectionServer(sim_config(max_clients=2),
                                      device="cpu"))
    server = h.start()
    try:
        c = _client(server.port)
        c.connect()
        c.stop()
        h.run(server.stop())
        assert server._draining
        h.run(server.start())
        assert not server._draining
        assert server._gc_tracker._installed
        c2 = _client(server.port)
        assert c2.connect().info.max_clients == 2
        c2.stop()
    finally:
        h.stop()


def test_cleanup_enqueue_nonblocking_when_queue_full():
    server = DetectionServer(sim_config(worker_threads=1), device="cpu")
    q = server._decode_queues[0]
    while not q.full():
        q.put_nowait(("__cleanup__", 0))
    calls = []

    class FakeLoop:
        def call_later(self, delay, fn, *args):
            calls.append((delay, fn, args))

    server._loop = FakeLoop()
    server._running = True
    t0 = time.perf_counter()
    server._enqueue_cleanup(42)
    assert time.perf_counter() - t0 < 0.5
    assert calls and calls[0][2] == ("__cleanup__", 42)
    q.get_nowait()
    calls[0][1](*calls[0][2])
    items = []
    while not q.empty():
        items.append(q.get_nowait())
    assert items[-1] == ("__cleanup__", 42)


def test_monitor_survives_poisoned_status(monkeypatch):
    server = DetectionServer(sim_config(), device="cpu")
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        raise KeyError("pipeline_p99_ms")

    server.engine.status = poisoned

    async def run():
        orig_sleep = asyncio.sleep
        ticks = {"n": 0}
        me = asyncio.current_task()

        async def fast_sleep(_t):
            if asyncio.current_task() is me:
                ticks["n"] += 1
                if ticks["n"] > 3:
                    raise asyncio.CancelledError
            await orig_sleep(0)

        monkeypatch.setattr(asyncio, "sleep", fast_sleep)
        try:
            await server._monitor_loop()
        except asyncio.CancelledError:
            pass

    asyncio.run(run())
    assert calls["n"] == 3


def test_sharded_decode_workers_preserve_per_client_order(fresh):
    server = fresh(max_clients=6, worker_threads=3)
    assert len(server._decode_queues) == 3
    clients = []
    try:
        for _ in range(3):
            c = _client(server.port)
            c.connect()
            c.start_receiver()
            clients.append(c)
        sent = [[c.send_jpeg_keyframe(synthetic_frame(96, 64, seed=10 + i)),
                 c.send_raw_frame(synthetic_frame(96, 64, seed=20 + i))]
                for i, c in enumerate(clients)]
        for c, fids in zip(clients, sent):
            def got():
                return [r.frame_id for r in c.wait_results(0, timeout=0)]
            assert _poll(lambda: fids[-1] in got())
            # Results of one client come back in the order it sent them.
            assert got() == sorted(got()) and set(got()) <= set(fids)
    finally:
        for c in clients:
            c.stop()


# ------------------------------------------------------ entry points

def test_use_device_cache_refused():
    """No longer refused: the default server builds the device frame cache
    (as the JAX server does), one slot a client at the largest frame bucket
    on the server's device; use_device_cache=False builds none."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    cfg = sim_config(tpu={"frame_buckets": [[64, 128], [128, 96]]})
    server = DetectionServer(cfg, device="cpu")
    cache = server.device_cache
    assert isinstance(cache, DeviceFrameCache)
    assert server.batcher.device_cache is cache
    assert tuple(cache._cache.shape) == (cfg.max_clients, 128, 128, 3)
    assert cache._cache.device.type == "cpu"
    assert server.status()["frame_cache"]["slots_total"] == cfg.max_clients
    off = DetectionServer(sim_config(), device="cpu", use_device_cache=False)
    assert off.device_cache is None and off.batcher.device_cache is None
    assert off.status()["frame_cache"] is None


def test_cuda_without_a_device_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionServer(sim_config())
    from zero_latency_yolo_tpu_torch.runtime import server as srv
    with pytest.raises(SystemExit, match="no CUDA device"):
        srv.main(["--config", "/nonexistent/server.json"])


def test_module_entry_serves_one_frame(tmp_path):
    """`python -m zero_latency_yolo_tpu_torch --config F --device cpu` boots
    in a subprocess and answers one frame."""
    cfg = sim_config(logging={"enable_logging": False})
    path = tmp_path / "server.json"
    cfg.save(str(path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch",
         "--config", str(path), "--device", "cpu"],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    c = _client(cfg.network.port)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                c.connect()
                break
            except (TimeoutError, ConnectionRefusedError, OSError):
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "server did not boot"
        c.start_receiver()
        fid = c.send_raw_frame(synthetic_frame(96, 64, seed=3))
        res = c.wait_results(1, timeout=WAIT)
        assert res and res[0].frame_id == fid
    finally:
        c.stop()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


# --------------------------------------- the slice against the JAX server

PARITY_CONFIG = {
    "confidence_threshold": 0.25, "web_port": 0,
    "detection": {"model_width": 64, "model_height": 64,
                  "enable_tracking": True},
    "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
            "batch_window_ms": 1.0, "pre_nms_topk": 64,
            "frame_buckets": [[96, 96]], "batch_buckets": [1, 2]},
}


# The ROI update of `_exchange`: the rect (y, x, h, w) of the frame sent.
ROI_RECT = (8, 16, 32, 48)


def _exchange(client, frames, kinds):
    """Send each frame (raw, JPEG keyframe, or an ROI update of the frame's
    ROI_RECT) after the previous result arrived; returns the results in
    order."""
    out = []
    y, x, h, w = ROI_RECT
    for frame, kind in zip(frames, kinds):
        if kind == "roi":
            fid = client.send_roi_update(
                np.ascontiguousarray(frame[y:y + h, x:x + w]), x=x, y=y)
        else:
            send = (client.send_jpeg_keyframe if kind == "jpeg"
                    else client.send_raw_frame)
            fid = send(frame)
        got = client.wait_results(len(out) + 1, timeout=120)
        assert len(got) == len(out) + 1 and got[-1].frame_id == fid, (
            f"frame {fid} unanswered")
        out.append(got[-1])
    return out


class FrameClock:
    """Stands in for the `time` module of a game adapter: its monotonic
    clock advances 1/60 s a call (the adapter reads it once a result), so
    the tracker's Kalman steps see the same dt in both servers however long
    each one took to answer."""

    def __init__(self):
        self.calls = 0

    def monotonic(self) -> float:
        self.calls += 1
        return 1000.0 + self.calls / 60.0

    def time(self) -> float:
        return time.time()


def test_server_matches_jax_server(tmp_path, monkeypatch):
    """The same yolov8p params (64 px, f32, frame bucket 96x96, batch
    buckets 1/2, tracking on) behind the JAX server and behind the port's
    server on the CPU, both without the device cache; each server is driven
    by the other package's SimClient with the same raw and JPEG frames, one
    at a time, its tracker on a 60 fps clock (FrameClock). Counts, classes
    and track ids equal; boxes and confidences within 1e-3 (the gate of
    tests/test_model_parity.py:54-63)."""
    _servers_agree(tmp_path, monkeypatch, False, ["raw", "jpeg"] * 4)


def test_cached_server_matches_jax_cached_server(tmp_path, monkeypatch):
    """As test_server_matches_jax_server with the device frame cache on in
    both servers (their default), and ROI updates among the frames: raw
    keyframe, ROI, JPEG keyframe, ROI, ... Each result is the step on the
    cached frame (the last keyframe with the ROIs pasted since), gathered
    into the cache's bucket."""
    _servers_agree(tmp_path, monkeypatch, True, ["raw", "roi", "jpeg", "roi"] * 2)


def _servers_agree(tmp_path, monkeypatch, use_cache, kinds):
    jax = pytest.importorskip("jax")
    pytest.importorskip("cv2")
    from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig
    from zero_latency_yolo_tpu.models import get_spec, init_params, save_params
    from zero_latency_yolo_tpu.runtime import adapters as jax_adapters
    from zero_latency_yolo_tpu.runtime.server import (
        DetectionServer as JaxServer)
    from zero_latency_yolo_tpu.runtime.simulator import SimClient as JaxClient
    from zero_latency_yolo_tpu_torch.runtime import adapters
    clocks = [FrameClock(), FrameClock()]
    monkeypatch.setattr(jax_adapters, "time", clocks[0])
    monkeypatch.setattr(adapters, "time", clocks[1])

    model = tmp_path / "pico.npz"
    save_params(init_params(jax.random.PRNGKey(0), get_spec("yolov8p", 4),
                            folded=True), str(model))
    d = {**PARITY_CONFIG, "model_path": str(model)}
    jax_server = JaxServer(JaxConfig.from_dict({**d, "port": free_port()}),
                           use_device_cache=use_cache)
    port_server = DetectionServer(
        ServerConfig.from_dict({**d, "port": free_port()}), device="cpu",
        use_device_cache=use_cache)
    assert (jax_server.device_cache is None) == (not use_cache)
    assert (port_server.device_cache is None) == (not use_cache)
    assert not jax_server.engine.simulation
    assert not port_server.engine.simulation
    harnesses = [ServerHarness(jax_server), ServerHarness(port_server)]
    for h in harnesses:
        h.start(warmup=True)
    frames = [synthetic_frame(96, 64, seed=i, t=0.3 * i) for i in range(8)]
    c_jax = _client(jax_server.port, cls=SimClient)     # port client
    c_port = _client(port_server.port, cls=JaxClient)   # JAX client
    try:
        for c in (c_jax, c_port):
            c.connect()
            c.start_receiver()
        want = _exchange(c_jax, frames, kinds)
        got = _exchange(c_port, frames, kinds)
    finally:
        for c in (c_jax, c_port):
            c.stop()
        for h in harnesses:
            h.stop()
    assert sum(len(r.detections) for r in want) > 0, "vacuous: no detections"
    assert clocks[0].calls == clocks[1].calls == len(frames)
    for n, (g, w) in enumerate(zip(got, want)):
        assert len(g.detections) == len(w.detections), f"frame {n} count"
        gd = np.array([[x.x, x.y, x.width, x.height, x.confidence]
                       for x in g.detections]).reshape(-1, 5)
        wd = np.array([[x.x, x.y, x.width, x.height, x.confidence]
                       for x in w.detections]).reshape(-1, 5)
        assert [x.class_id for x in g.detections] == [
            x.class_id for x in w.detections], f"frame {n} classes"
        assert [x.track_id for x in g.detections] == [
            x.track_id for x in w.detections], f"frame {n} track ids"
        assert all(x.track_id > 0 for x in g.detections)
        np.testing.assert_allclose(gd, wd, atol=1e-3, rtol=0,
                                   err_msg=f"frame {n} boxes/confidences")


# ------------------------------------------- repairs of the engine surface

def _pico_engine(**tpu):
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec
    from zero_latency_yolo_tpu_torch.models.yolov8 import init_params
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                "pre_nms_topk": 64, "frame_buckets": [[96, 96]],
                "batch_buckets": [1, 2], **tpu}})
    params = init_params(0, get_spec("yolov8p", 4), folded=True)
    return InferenceEngine(cfg, params=params, device="cpu")


def _frame_request(cid, fid, w=96, h=64):
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    return InferenceRequest(client_id=cid, frame_id=fid, timestamp=fid,
                            width=w, height=h,
                            data=synthetic_frame(w, h, seed=fid))


def test_pending_batch_readiness_fields():
    """A dispatched batch carries the JAX PendingBatch fields the batcher
    reads (ready_at, serve_size, is_real_device), and the batcher's _ready
    follows the batch's CUDA event: False while it is pending, True once it
    has completed; a CPU batch is ready when dispatch returns."""
    from zero_latency_yolo_tpu_torch.runtime.scheduler import (
        ContinuousBatcher)
    eng = _pico_engine()
    p = eng.dispatch([_frame_request(1, 1)])
    assert p.is_real_device and p.ready_at is None
    assert p.serve_size == eng.model_size and p.event is None
    assert ContinuousBatcher._ready(p)

    class Event:
        done = False

        def query(self):
            return self.done
    p.event = Event()
    assert not ContinuousBatcher._ready(p)
    p.event.done = True
    assert ContinuousBatcher._ready(p)
    assert len(eng.complete(p)) == 1


def test_oversized_sheds_are_counted_apart():
    """The engine counts oversized sheds in frames_oversized as well as
    frames_dropped, and counts errors; the server's rate control and the
    batcher read both."""
    eng = _pico_engine()
    before = eng.frames_dropped.value
    p = eng.dispatch([_frame_request(1, 1, w=200, h=64),
                      _frame_request(2, 2)])
    assert len(eng.complete(p)) == 1
    assert eng.frames_dropped.value == before + 1
    assert eng.frames_oversized.value == 1
    assert eng.error_count.value == 0
    st = eng.status()
    assert st["oversized"] == "1" and st["errors"] == "0"


def test_socket_buffers_sized_from_config(harness):
    """The asyncio socket gets network.recv_buffer_size (the kernel caps it
    at rmem_max and reports twice what it granted)."""
    try:
        rmem_max = int(Path("/proc/sys/net/core/rmem_max").read_text())
    except OSError:
        pytest.skip("no /proc/sys/net/core/rmem_max")
    sock = harness._transport.get_extra_info("socket")
    want = min(harness.config.network.recv_buffer_size, rmem_max)
    assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) >= want


def test_kernel_drops_are_counted():
    """udp_kernel_drops reads the drops of the sockets bound to a port: a
    socket nobody reads, flooded past its receive buffer, shows them; the
    serving socket's count appears in /statusz."""
    from zero_latency_yolo_tpu_torch.runtime.server import udp_kernel_drops
    if not Path("/proc/net/udp").exists():
        pytest.skip("no /proc/net/udp")
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    rx.bind(("127.0.0.1", 0))
    port = rx.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert udp_kernel_drops(port) == 0
        for _ in range(200):
            tx.sendto(b"x" * 1024, ("127.0.0.1", port))
        assert _poll(lambda: udp_kernel_drops(port) > 0)
    finally:
        rx.close()
        tx.close()
    assert udp_kernel_drops(port) is None  # no socket bound there now


def test_native_transport_serves(fresh):
    """network.use_native_transport: the recvmmsg intake on the port's
    codec library serves the handshake, frames and heartbeats."""
    from zero_latency_yolo_tpu_torch.runtime.transport import (
        HAVE_NATIVE_UDP, NativeUdpTransport)
    if not HAVE_NATIVE_UDP:
        pytest.skip("native codec library not built on this host")
    server = fresh(network={"use_native_transport": True})
    assert isinstance(server._transport, NativeUdpTransport)
    c = _client(server.port)
    try:
        c.connect()
        c.start_receiver()
        fids = [c.send_raw_frame(synthetic_frame(96, 64, seed=s))
                for s in range(3)]
        assert _poll(lambda: fids[-1] in [
            r.frame_id for r in c.wait_results(0, timeout=0)])
        assert server.status()["transport"]["rx_dead"] is False
    finally:
        c.stop()
