"""The metrics that read the program's own spans (`portbench/spans.py`)
read known values from a synthetic traced window, and nothing from an
untraced one or from a program without the recorder."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run
from zero_latency_yolo_tpu_torch.utils import profiling
from zero_latency_yolo_tpu_torch.utils.profiling import (LIVE, Span,
                                                        SpanRecorder)

ROOT = Path(run.__file__).resolve().parent
NEW = ("step_launch_ms.tail", "step_preprocess_ms.tail",
       "step_model_ms.tail", "step_post_ms.tail", "batcher_offcpu_share.tail",
       "cache_lock_wait_ms.tail", "cache_flush_ms.tail",
       "cache_flush_us_per_write.tail", "step_queue_wait_ms.tail",
       "step_device_ms.tail", "device_stepless_share.tail")


class FakeEvent:
    """A CUDA event's two calls the recorder's reading makes, at a device
    time in seconds."""

    def __init__(self, s):
        self.s = s

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.s - self.s) * 1e3


class Clock:
    """The host clocks the recorder reads: perf_counter set by the test,
    and a thread CPU clock that runs at 60% of it."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def thread_time_ns(self):
        return int(round(self.t * 0.6e9))


class Req:
    def __init__(self, frame, enqueue_t):
        self.client_id, self.frame_id, self.enqueue_t = 1, frame, enqueue_t


def _step(rec, clock, step, t, launch_ms, flush_ms, writes, wait_ms,
          device):
    """One recorded step at host time t (s): the wait for the lock 0.1 ms,
    the flush, the launch (preprocess 1, model launch_ms - 3, post 1 ms),
    one served request (client 1, frame `step`) that waited wait_ms, and
    its device interval `device` (s, s), read against a calibration event
    at device time 0 stamped at host time 0."""
    ms = 1e-3
    clock.t = t
    token = rec.step_begin(4, [Req(step, t - wait_ms * ms)])
    marks = LIVE.marks
    marks += [(Span.LOCK_WAIT, t), (~Span.LOCK_WAIT, t + 0.1 * ms)]
    if flush_ms:
        marks += [(Span.FLUSH, t + 0.1 * ms),
                  (~Span.FLUSH, t + (0.1 + flush_ms) * ms, writes,
                   1000 * writes)]
    t1 = t + (0.3 + flush_ms) * ms
    marks += [(Span.LAUNCH, t1), (Span.PREPROCESS, t1),
              (Span.MODEL, t1 + 1 * ms), (Span.POST, t1 + (launch_ms - 2) * ms),
              (~Span.POST, t1 + (launch_ms - 1) * ms),
              (Span.DEVICE_STEP, FakeEvent(device[1])),
              (~Span.LAUNCH, t1 + launch_ms * ms)]
    clock.t = t + 0.05
    rec.step_end(token[:3] + (FakeEvent(device[0]),
                              (None, FakeEvent(0.0), 0.0)) + token[5:])


@pytest.fixture
def window(monkeypatch):
    rec = SpanRecorder(capacity=256)
    clock = Clock()
    monkeypatch.setattr(profiling, "SPANS", rec)
    monkeypatch.setattr(profiling, "time", clock)
    # Step 0 begins before the window (left out); steps 1-3 inside it;
    # step 4 after the profiler's stop (left out). Each root samples the
    # CPU clock (0.5 s apart or more).
    _step(rec, clock, 0, 9.0, 50.0, 9.0, 9, 90.0, (9.0, 10.2))
    _step(rec, clock, 1, 10.0, 10.0, 2.0, 4, 5.0, (10.2, 10.4))
    _step(rec, clock, 2, 10.5, 20.0, 0.0, 0, 15.0, (10.5, 10.6))
    _step(rec, clock, 3, 11.0, 30.0, 6.0, 8, 25.0, (11.0, 11.2))
    _step(rec, clock, 4, 12.5, 50.0, 9.0, 9, 90.0, (12.5, 12.6))
    served = [(1, 1), (1, 2), (1, 3), (1, 0), (1, 4)]
    return SimpleNamespace(trace_t0=10.0, trace_t1=12.0, served=served)


def read(name, win):
    return run.read_metric(name, win)


def test_the_new_metrics_read_known_values(window):
    assert read("step_launch_ms.tail", window) == pytest.approx(20.0)
    assert read("step_preprocess_ms.tail", window) == pytest.approx(1.0)
    assert read("step_model_ms.tail", window) == pytest.approx(17.0)
    assert read("step_post_ms.tail", window) == pytest.approx(1.0)
    # The CPU clock runs at 60% of the wall clock (samples at 10.0-11.0).
    assert read("batcher_offcpu_share.tail", window) == pytest.approx(40.0)
    assert read("cache_lock_wait_ms.tail", window) == pytest.approx(0.1)
    # Per step 2, 0 and 6 ms: the step without writes counts as 0.
    assert read("cache_flush_ms.tail", window) == pytest.approx(2.0)
    # 8 ms over 12 writes.
    assert read("cache_flush_us_per_write.tail",
                window) == pytest.approx(8000.0 / 12)
    assert read("step_queue_wait_ms.tail", window) == pytest.approx(15.0)
    assert read("step_device_ms.tail", window) == pytest.approx(200.0)
    # Covered: 10.0-10.4 (step 0's interval runs into the window), 10.5-
    # 10.6 and 11.0-11.2, 0.7 s of 2 s.
    assert read("device_stepless_share.tail",
                window) == pytest.approx(65.0)


def test_a_frame_not_served_leaves_the_queue_wait(window):
    window.served = [(1, 1), (1, 3)]
    assert read("step_queue_wait_ms.tail", window) == pytest.approx(15.0)
    window.served = [(1, 3)]
    assert read("step_queue_wait_ms.tail", window) == pytest.approx(25.0)


def test_nothing_to_read(window, monkeypatch):
    """Untraced (no trace_t0), no recorded step in the window, or a program
    without the recorder: every new metric is None."""
    untraced = SimpleNamespace(served=window.served)
    empty = SimpleNamespace(trace_t0=20.0, trace_t1=21.0, served=[])
    for win in (untraced, empty):
        assert [read(n, win) for n in NEW] == [None] * len(NEW)
    monkeypatch.delattr(profiling, "SPANS")
    assert [read(n, window) for n in NEW] == [None] * len(NEW)


def test_the_new_metrics_are_declared():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert (ROOT / "metrics" / f"{name}.py").exists()
        assert declared[name]["moves"] == "served_fps"
        assert declared[name]["workloads"] == ["s640-knee80", "n416-knee80"]
