"""Two wire faults of the port, repaired, each a deliberate difference from
the JAX package (whose copies keep them):

- a JPEG whose marker is preceded by 0xFF fill bytes (legal, ITU T.81
  B.1.1.2) is read: `runtime/frames.py` `_jpeg_sof_dims` skips them;
- a client's accuracy floor (min_serve_size, per-session state) survives a
  re-handshake: `SimClient` records the floor it asked for in SET_CONFIG and
  asks for it again, alone, once `reconnect` sees the new SERVER_INFO, so a
  floor-416 client whose server restarts on the same port is served at 416
  again, never at the 320 rung. The global settings it sent (thresholds,
  SLO) are not replayed onto the new server.
"""

import asyncio
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from zero_latency_yolo_tpu.runtime import frames as jax_frames
from zero_latency_yolo_tpu_torch.config import ServerConfig
from zero_latency_yolo_tpu_torch.runtime import frames
from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
from zero_latency_yolo_tpu_torch.runtime.simulator import (SimClient,
                                                           synthetic_frame)

SOI = b"\xff\xd8"
APP0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
# SOF0: 8-bit, 120 rows, 160 columns, 3 components.
SOF0 = (b"\xff\xc0\x00\x11\x08\x00\x78\x00\xa0\x03"
        b"\x01\x22\x00\x02\x11\x01\x03\x11\x01")
EOI = b"\xff\xd9"


@pytest.mark.parametrize("fill", [0, 1, 5])
def test_sof_scan_skips_fill_bytes(fill):
    data = SOI + APP0 + b"\xff" * fill + SOF0 + EOI
    assert frames._jpeg_sof_dims(data) == (120, 160)


def test_fill_bytes_alone_are_still_refused():
    for data in (SOI + b"\xff" * 40, SOI + APP0 + b"\xff" * 3,
                 SOI + b"\xff" * 3 + b"\xc0\x00"):
        with pytest.raises(frames.FrameDecodeError, match="no parseable SOF"):
            frames._jpeg_sof_dims(data)


def test_the_jax_scan_refuses_fill_bytes():
    """The deliberate difference: the JAX package's copy, unchanged, reads
    the fill byte as the marker."""
    assert jax_frames._jpeg_sof_dims(SOI + APP0 + SOF0 + EOI) == (120, 160)
    with pytest.raises(jax_frames.FrameDecodeError):
        jax_frames._jpeg_sof_dims(SOI + APP0 + b"\xff" + SOF0 + EOI)


def test_a_fill_byte_jpeg_decodes_through_frames():
    pytest.importorskip("cv2")
    px = synthetic_frame(160, 120, seed=3)
    jpeg = frames.encode_jpeg(px, 90)
    at = jpeg.index(b"\xff\xc0")
    filled = jpeg[:at] + b"\xff" * 3 + jpeg[at:]
    want = frames.decode_frame_payload(jpeg, 160, 120).pixels
    got = frames.decode_frame_payload(filled, 160, 120).pixels
    assert got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the floor across a re-handshake
# ---------------------------------------------------------------------------

def _free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Server:
    """A simulation-mode server (yolov8n at 416 with a 320 rung, the
    policy stepped down to 320) on its own event loop thread."""

    def __init__(self, port: int, web_port: int):
        cfg = ServerConfig.from_dict({
            "model_path": "/nonexistent/model.npz",  # => simulation mode
            "port": port, "web_port": web_port, "max_clients": 4,
            "network": {"timeout_ms": 5000},
            "detection": {"model_width": 416, "model_height": 416},
            "tpu": {"batch_window_ms": 1.0, "frame_buckets": [[128, 128]],
                    "batch_buckets": [1, 2, 4], "serve_sizes": [416, 320],
                    "trace_sample_every": 1},
        })
        self.server = DetectionServer(cfg, device="cpu")
        self.server.engine._serve_size = 320  # downshifted
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self._run(self.server.start(warmup=False))

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(20)

    def stop(self):
        self._run(self.server.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)

    def served_sizes(self):
        return [t["serve_size"] for t in self.server._traces]


def _statusz(web_port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{web_port}/statusz",
                                timeout=5) as r:
        return json.loads(r.read())


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _restart_with_a_floored_client(settings, warm_first):
    """A client sends SET_CONFIG `settings` (with min_serve_size 416) to a
    server (its serve-size ladder warm if `warm_first`), which then
    restarts on the same port, cold; the client re-handshakes. Returns the
    second server, still running, after three frames served there (the
    caller stops it), and the client's recorded floor."""
    port, web = _free_port(), _free_port(socket.SOCK_STREAM)
    first = _Server(port, web)
    if warm_first:
        first.server.engine._warmed_sizes = (416, 320)
    frame = synthetic_frame(128, 128, seed=1)
    c = SimClient(("127.0.0.1", port), screen_width=128, screen_height=128)
    second = None
    try:
        c.connect()
        c.start_receiver()
        c.set_config(**settings)
        assert _wait(lambda: [s.min_serve_size for s in
                              first.server._sessions.values()] == [416])
        c.send_raw_frame(frame)
        assert c.wait_results(1, timeout=10)
        # (the trace is recorded just after the send)
        assert _wait(lambda: first.served_sizes() == [416])

        # The server restarts on the same port: its stop() sends the drain
        # notice, the client re-handshakes with the new one.
        first.stop()
        first = None
        assert _wait(lambda: c.server_disconnected, 5)
        second = _Server(port, web)
        assert c.reconnect(timeout=5.0)
        assert _wait(lambda: [s.min_serve_size for s in
                              second.server._sessions.values()] == [416])
        st = _statusz(web)
        assert len(st["sessions"]) == 1
        assert (st["clients_floored"], st["max_client_floor"]) == (1, 416)
        for i in range(3):
            # One at a time: a client's newer frame supersedes a queued one.
            c.send_raw_frame(frame)
            assert _wait(lambda: len(second.served_sizes()) > i)
        sizes = second.served_sizes()
        assert len(sizes) >= 3 and min(sizes) == 416, sizes
        return second, c.sent_floor
    except BaseException:
        if second is not None:
            second.stop()
        raise
    finally:
        c.stop()
        if first is not None:
            first.stop()


def test_floor_survives_a_server_restart():
    second, floor = _restart_with_a_floored_client(
        {"min_serve_size": 416}, warm_first=False)
    second.stop()
    assert floor == 416


def test_reconnect_replays_only_the_floor():
    """The floor went with global settings the first server took (its
    ladder warm): the restarted server, whose ladder is cold and would
    refuse the SLO, still gets the floor, and keeps its own thresholds and
    SLO."""
    second, floor = _restart_with_a_floored_client(
        {"min_serve_size": 416, "adaptive_slo_ms": 30.0,
         "confidence_threshold": 0.9}, warm_first=True)
    try:
        eng = second.server.engine
        assert floor == 416
        assert eng.config.confidence_threshold == ServerConfig(
        ).confidence_threshold
        assert eng.adaptive_slo_ms == 0.0
        assert eng._staged_slo is None
    finally:
        second.stop()
