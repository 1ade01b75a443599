"""The serving core's span recorder (`utils/profiling.py` `SPANS`) on the
CPU: inert while no profiler runs, armed by a profiler started on another
thread, nested under each step's root, blind to other threads, a ring
that keeps the newest, the steps whose root began disarmed dropped, and
the capture's `spans.json`."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import (  # noqa: E402
    get_spec, init_params)
from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime.engine import (  # noqa: E402
    InferenceEngine, InferenceRequest)
from zero_latency_yolo_tpu_torch.runtime.scheduler import (  # noqa: E402
    ContinuousBatcher)
from zero_latency_yolo_tpu_torch.utils import profiling  # noqa: E402
from zero_latency_yolo_tpu_torch.utils.profiling import (  # noqa: E402
    LIVE, SPAN_NAMES, SPANS, Span, SpanRecorder)

CLIENTS = (1, 2, 3)


def _core():
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                "pre_nms_topk": 64, "batch_buckets": [1, 2, 4],
                "frame_buckets": [[96, 96]]}})
    eng = InferenceEngine(cfg, params=init_params(0, get_spec("yolov8p", 4),
                                                  folded=True), device="cpu")
    cache = DeviceFrameCache(4, 96, 96, device="cpu")
    return eng, cache


class Feed:
    """Keyframes, region writes and cached requests of three clients into
    a running batcher; remembers each request's enqueue_t."""

    def __init__(self, cache, batcher):
        self.cache, self.batcher = cache, batcher
        self.rng = np.random.default_rng(0)
        self.enqueued = {}
        self.results = []
        self.frame = 0

    def send(self, rounds, pause=0.01):
        for _ in range(rounds):
            self.frame += 1
            for c in CLIENTS:
                if self.frame % 5 == 1:
                    assert self.cache.write_keyframe(c, self.rng.integers(
                        0, 256, (64, 96, 3), np.uint8))
                else:
                    assert self.cache.write_roi(c, self.rng.integers(
                        0, 256, (8, 16, 3), np.uint8), 4 * c, 8)
                r = InferenceRequest(client_id=c, frame_id=self.frame,
                                     timestamp=self.frame, width=96,
                                     height=64, data=None)
                self.enqueued[(c, self.frame)] = r.enqueue_t
                self.batcher.submit(r)
            time.sleep(pause)

    def settle(self, timeout=20.0):
        """Wait until each client's newest frame has its result (a newer
        frame supersedes the older ones still queued)."""
        want = {(c, self.frame) for c in CLIENTS}
        deadline = time.monotonic() + timeout
        while not want <= {(r.client_id, r.frame_id) for r in self.results}:
            assert time.monotonic() < deadline, "results did not arrive"
            time.sleep(0.01)


@pytest.fixture
def serving():
    eng, cache = _core()
    got = []
    b = ContinuousBatcher(eng, got.extend, max_batch=4, batch_window_ms=2.0,
                          device_cache=cache)
    SPANS.clear()
    feed = Feed(cache, b)
    feed.results = got
    b.start()
    try:
        yield eng, cache, b, feed
    finally:
        b.stop()
        SPANS.clear()


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _by_seq(snap):
    return {int(s): i for i, s in enumerate(snap["seq"])}


class FakeEvent:
    """A CUDA event's two calls the recorder's reading makes, at a fixed
    device time (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_disarmed_serving_leaves_the_recorder_empty(serving):
    eng, cache, b, feed = serving
    assert not profiling.armed()
    feed.send(12)
    feed.settle()
    assert feed.results and cache.writes_flushed > 0
    assert SPANS.steps == 0 and not SPANS.cpu
    assert LIVE.marks is None
    snap = SPANS.snapshot()
    assert all(len(v) == 0 for v in snap.values())


def test_armed_spans_nest_under_their_steps(serving):
    """A profiler started on this thread arms the batcher thread's sites:
    each step's spans carry its id and nest (the phases in engine.launch;
    the wait for the lock, the flush and the launch under the root); each
    wait is the root's start less enqueue_t; the flush attributes add up
    to the cache's counters; the root samples the batcher's CPU clock."""
    eng, cache, b, feed = serving
    feed.send(2)
    feed.settle()
    w0, b0 = cache.writes_flushed, cache.bytes_flushed
    seen = {}
    prof = _profiler()
    prof.start()
    try:
        checker = threading.Thread(
            target=lambda: seen.update(flag=profiling.armed()))
        checker.start()
        checker.join(timeout=10)
        deadline = time.monotonic() + 30
        while SPANS.steps < 4 and time.monotonic() < deadline:
            feed.send(1)
        feed.settle()
    finally:
        prof.stop()
    assert seen == {"flag": True}
    assert cache.writes_flushed > w0
    snap = SPANS.snapshot()
    pos = _by_seq(snap)
    names = [SPAN_NAMES[n] for n in snap["name"]]
    roots = {int(snap["step"][i]): i for i, n in enumerate(names)
             if n == "batcher.step"}
    assert len(roots) >= 4 and SPANS.steps == len(roots)
    for i, n in enumerate(names):
        step = int(snap["step"][i])
        assert step in roots, n
        assert snap["t1"][i] >= snap["t0"][i]
        if n == "batcher.step":
            assert snap["parent"][i] == -1
            assert snap["a"][i] in (1, 2, 4) and 1 <= snap["b"][i] <= 3
            continue
        parent = pos[int(snap["parent"][i])]
        assert snap["step"][parent] == step
        want = "engine.launch" if n.startswith("step.") else "batcher.step"
        assert names[parent] == want, (n, names[parent])
        assert snap["t0"][parent] <= snap["t0"][i]
        assert snap["t1"][i] <= snap["t1"][parent]
    per_step = {}
    for i, n in enumerate(names):
        per_step.setdefault(int(snap["step"][i]), []).append(n)
    for step, got in per_step.items():
        assert got == ["batcher.step", "cache.lock_wait"] + (
            ["cache.flush"] if "cache.flush" in got else []) + [
            "engine.launch", "step.preprocess", "step.model",
            "step.post"], (step, got)
    flush = [i for i, n in enumerate(names) if n == "cache.flush"]
    assert flush
    assert int(snap["a"][flush].sum()) == cache.writes_flushed - w0
    assert int(snap["b"][flush].sum()) == cache.bytes_flushed - b0
    assert len(snap["wait_s"]) == int(snap["b"][list(roots.values())].sum())
    for c, f, step, wait in zip(snap["wait_client"], snap["wait_frame"],
                                snap["wait_step"], snap["wait_s"]):
        root_t0 = snap["t0"][roots[int(step)]]
        assert wait == root_t0 - feed.enqueued[(int(c), int(f))]
    served = {(r.client_id, r.frame_id) for r in feed.results}
    assert {(int(c), int(f)) for c, f in zip(snap["wait_client"],
                                            snap["wait_frame"])} <= served
    cpu = SPANS.cpu_samples()
    assert len(cpu["t"]) >= 1 and len(set(cpu["thread"].tolist())) == 1
    assert cpu["thread"][0] == b._thread.ident


def test_other_threads_record_nothing_into_a_step(serving):
    """While a step is open on one thread, a flush, a lock and a launch on
    another thread record nothing: each site sees its own thread's step."""
    eng, cache, b, feed = serving
    b.stop()
    rec = SpanRecorder(capacity=8)
    token = rec.step_begin(1, [])
    mine = LIVE.marks
    assert mine == []
    assert cache.write_keyframe(1, np.zeros((64, 96, 3), np.uint8))

    def elsewhere():
        assert LIVE.marks is None
        cache.dispatch_with(eng.gather_from_cache, [1])
        cache.run_locked(lambda c: None)
    worker = threading.Thread(target=elsewhere)
    worker.start()
    worker.join(timeout=30)
    assert mine == []
    rec.step_end(token)
    assert LIVE.marks is None and rec.steps == 1


def test_ring_wraps_and_keeps_the_newest():
    class Req:
        def __init__(self, c, f):
            self.client_id, self.frame_id = c, f
            self.enqueue_t = time.perf_counter()

    rec = SpanRecorder(capacity=4)
    with pytest.raises(ValueError):
        SpanRecorder(capacity=6)
    for step in range(6):
        token = rec.step_begin(4, [Req(1, step), Req(2, step)])
        assert token is not None and LIVE.marks == []
        assert rec.step_begin(4, []) is None  # one step a thread
        t = time.perf_counter()
        LIVE.marks.extend([(Span.LAUNCH, t), (Span.MODEL, t),
                           (~Span.LAUNCH, t)])
        rec.step_end(token)
        assert LIVE.marks is None
    assert rec.steps == 6
    snap = rec.snapshot()
    # The model phase was never ended by a mark of its own: left open, it
    # is skipped; the launch that holds it is kept.
    assert [SPAN_NAMES[n] for n in snap["name"]] == (
        ["batcher.step", "engine.launch"] * 4)
    assert list(snap["step"]) == [2, 2, 3, 3, 4, 4, 5, 5]
    assert list(snap["wait_step"]) == [2, 2, 3, 3, 4, 4, 5, 5]
    assert list(snap["wait_frame"]) == [2, 2, 3, 3, 4, 4, 5, 5]
    since = rec.snapshot(snap["t0"][4])
    assert list(since["step"]) == [4, 4, 5, 5]
    rec.clear()
    assert rec.steps == 0 and len(rec.snapshot()["t0"]) == 0


def test_a_step_begun_disarmed_is_dropped(serving):
    """The profiler starts inside a step whose root began disarmed: that
    step records nothing; the next step, begun armed, is recorded."""
    eng, cache, b, feed = serving
    b.stop()
    for c in CLIENTS:
        assert cache.write_keyframe(c, np.zeros((64, 96, 3), np.uint8))
    prof = _profiler()
    real = eng.gather_from_cache

    def gather_and_arm(*args):
        prof.start()
        return real(*args)
    eng.gather_from_cache = gather_and_arm

    def reqs(frame):
        return [InferenceRequest(client_id=c, frame_id=frame,
                                 timestamp=frame, width=96, height=64,
                                 data=None) for c in CLIENTS]
    try:
        first = b._dispatch(reqs(1))
        assert profiling.armed()
        eng.gather_from_cache = real
        eng.complete_many(first)
        assert SPANS.steps == 0 and LIVE.marks is None
        second = b._dispatch(reqs(2))
        eng.complete_many(second)
    finally:
        prof.stop()
    snap = SPANS.snapshot()
    assert SPANS.steps == 1 and set(snap["step"].tolist()) == {0}
    assert set(snap["wait_frame"].tolist()) == {2}
    assert "step.model" in {SPAN_NAMES[n] for n in snap["name"]}


def test_capture_exports_the_spans(serving, tmp_path):
    """`capture` writes the recorder's spans of its window as spans.json
    (Chrome-trace X events on the host clock, the device intervals on a
    track of their own) beside trace.json."""
    eng, cache, b, feed = serving
    sender = threading.Thread(target=feed.send, args=(40,))
    sender.start()
    try:
        out = profiling.capture(0.3, str(tmp_path), gate=b.device_gate)
    finally:
        sender.join(timeout=30)
    assert out["ok"]
    assert [f["name"] for f in out["files"]] == ["spans.json", "trace.json"]
    doc = json.loads((Path(out["dir"]) / "spans.json").read_text())
    events = doc["traceEvents"]
    meta = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    assert meta == {1: "serving core (host)", 2: "device.step"}
    spans = [e for e in events if e["ph"] == "X"]
    assert {"batcher.step", "cache.lock_wait", "engine.launch",
            "step.model"} <= {e["name"] for e in spans}
    assert all(e["tid"] == 1 and e["dur"] >= 0 for e in spans)
    roots = [e for e in spans if e["name"] == "batcher.step"]
    assert all({"rows", "frames", "step"} <= set(e["args"]) for e in roots)
    # A device interval: its events read against the calibration event,
    # stamped at host time 1.0 s.
    rec = SpanRecorder(capacity=8)
    token = rec.step_begin(1, [])
    LIVE.marks.append((Span.DEVICE_STEP, FakeEvent(2.5)))
    rec.step_end(token[:3] + (FakeEvent(0.5), (None, FakeEvent(0.0), 1.0))
                 + token[5:])
    dev = [e for e in rec.chrome_events() if e["ph"] == "X"
           and e["name"] == "device.step"]
    assert [(e["tid"], e["args"]["parent"]) for e in dev] == [(2, 0)]
    assert dev[0]["ts"] == pytest.approx(1.0005e6)
    assert dev[0]["dur"] == pytest.approx(2000.0)


@pytest.mark.cuda
def test_device_step_on_the_host_clock_on_the_card():
    """On a CUDA device, under a profiler of the device alone (as the
    benchmark's traced window runs one), the batcher thread's steps are
    recorded, and each step's device interval lies on the host clock
    after its root began and before its completion ended."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                "pre_nms_topk": 64, "batch_buckets": [1, 2, 4],
                "frame_buckets": [[96, 96]]}})
    eng = InferenceEngine(cfg, params=init_params(
        0, get_spec("yolov8p", 4), folded=True), device="cuda")
    cache = DeviceFrameCache(4, 96, 96, device="cuda")
    got = []
    b = ContinuousBatcher(eng, got.extend, max_batch=4, batch_window_ms=2.0,
                          device_cache=cache)
    feed = Feed(cache, b)
    feed.results = got
    SPANS.clear()
    b.start()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        feed.send(3)
        feed.settle()
        with b.device_gate:
            prof.start()
        deadline = time.monotonic() + 60
        while SPANS.steps < 6 and time.monotonic() < deadline:
            feed.send(1)
        feed.settle()
        with b.device_gate:
            prof.stop()
    finally:
        b.stop()
    snap = SPANS.snapshot()
    SPANS.clear()
    names = np.array([SPAN_NAMES[n] for n in snap["name"]])
    roots = {int(s): i for i, s in enumerate(snap["step"])
             if names[i] == "batcher.step"}
    launch_end = {int(s): snap["t1"][i] for i, s in enumerate(snap["step"])
                  if names[i] == "engine.launch"}
    dev = np.flatnonzero(names == "device.step")
    assert len(roots) >= 6 and len(dev) == len(launch_end) == len(roots)
    for i in dev:
        step = int(snap["step"][i])
        assert snap["parent"][i] == snap["seq"][roots[step]]
        # The start event is recorded at the root, the completion event
        # just before the launch ends: the device reaches each after.
        assert snap["t0"][roots[step]] - 1e-4 <= snap["t0"][i]
        assert launch_end[step] - 1e-3 <= snap["t1"][i]
        assert snap["t0"][i] < snap["t1"][i] < time.perf_counter()
