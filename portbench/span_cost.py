"""The span recorder's host cost (`zero_latency_yolo_tpu_torch/utils/
profiling.py` `SPANS`) on the b32 cached step of `n416-knee80`'s program:
its cache, engine and batcher as the cell builds them, without the
harness's wrappers, on a CUDA device. One JSON line:

    python -m portbench.span_cost

- `disarmed_sites_us`: what a disarmed step runs of the recorder (the
  root's `armed()` and five reads of `LIVE.marks`), timed a million times;
- `loop_us`: 2,000 steps back to back with no profiler running; a step
  writes a 64x64 region into each of 32 slots, dispatches them through
  the batcher and completes the step before it (two in flight);
- `armed`: 2,000 such steps under a profiler of the device (as the
  traced window runs one), in blocks of 50 with the recorder on and off
  in turns (off: the batcher's `armed` reads False); each side's mean
  host us a step and the blocks' paired difference, on less off;
- `replay_us`: a recorded step's own work alone under the profiler,
  20,000 times: the root with 32 requests and its timing event, the
  cached step's marks, the completion event made timing, the end (less
  the untimed completion event a disarmed step records too);
  `replay_in_loop_us`: the same work timed once after each of 500 steps
  (recorder off), where the step has just run through the caches;
- `cpu_clock_read_us`, `cpu_clock_tick_us`: one read of the thread's CPU
  clock (a root samples it at most every 0.25 s), and the smallest step
  the clock was seen to take.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
from zero_latency_yolo_tpu_torch.runtime import scheduler
from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
from zero_latency_yolo_tpu_torch.utils import profiling
from zero_latency_yolo_tpu_torch.utils.profiling import (LIVE, SPANS, Span,
                                                        SpanRecorder)

from . import run, serving

ROOT = Path(__file__).resolve().parent
BATCH, STEPS, BLOCK, REPLAY = 32, 2000, 50, 20000


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


class Loop:
    """The cached step of BATCH clients, back to back, two in flight."""

    def __init__(self, engine) -> None:
        self.engine = engine
        h, w = max(engine.config.tpu.frame_buckets)
        self.cache = DeviceFrameCache(BATCH, h, w, device=str(engine.device))
        self.batcher = scheduler.ContinuousBatcher(
            engine, lambda results: None, max_batch=BATCH,
            batch_window_ms=engine.config.tpu.batch_window_ms,
            device_cache=self.cache, max_inflight=2)
        engine.warmup(None, [(h, w)], self.cache)
        rng = np.random.default_rng(0)
        self.clients = list(range(1, BATCH + 1))
        self.size = (min(h, 600), min(w, 800))
        for c in self.clients:
            if not self.cache.write_keyframe(c, rng.integers(
                    0, 256, self.size + (3,), np.uint8)):
                raise RuntimeError(f"the cache refused client {c}")
        self.regions = [rng.integers(0, 256, (64, 64, 3), np.uint8)
                        for _ in range(16)]
        self.frame = 0
        self.inflight = []

    def step(self) -> float:
        self.frame += 1
        for c in self.clients:
            y = (self.frame * 7 + c * 13) % (self.size[0] - 64)
            x = (self.frame * 11 + c * 5) % (self.size[1] - 64)
            self.cache.write_roi(c, self.regions[(c + self.frame) % 16], x, y)
        reqs = [InferenceRequest(client_id=c, frame_id=self.frame,
                                 timestamp=self.frame, width=self.size[1],
                                 height=self.size[0], data=None)
                for c in self.clients]
        t0 = time.perf_counter()
        with self.batcher.device_gate:
            self.inflight.extend(self.batcher._dispatch(reqs))
        if len(self.inflight) > 1:
            done, self.inflight = self.inflight[:-1], self.inflight[-1:]
            with self.batcher.device_gate:
                self.engine.complete_many(done)
        return time.perf_counter() - t0

    def run(self, steps: int, after=None) -> float:
        """Mean host seconds a step over `steps` steps; with `after`, the
        mean seconds of a call of it after each step instead."""
        t = []
        for _ in range(steps):
            host = self.step()
            if after is not None:
                t0 = time.perf_counter()
                after()
                host = time.perf_counter() - t0
            t.append(host)
        self.engine.complete_many(self.inflight)
        self.inflight = []
        return float(np.mean(t))


def disarmed_sites_us(n: int = 1_000_000) -> float:
    armed = profiling.armed
    t = time.perf_counter()
    for _ in range(n):
        if armed():
            pass
        for _site in range(5):
            marks = LIVE.marks
            if marks is not None:
                pass
    looped = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        for _site in range(5):
            pass
    return (looped - (time.perf_counter() - t)) / n * 1e6


def replay(device):
    """A recorded step's own host work, and the untimed event that a
    disarmed step records instead of its timing completion event."""
    reqs = [InferenceRequest(client_id=c, frame_id=1, timestamp=1,
                             width=800, height=600, data=None)
            for c in range(1, BATCH + 1)]
    rec, pc = SpanRecorder(), time.perf_counter

    def recorded():
        token = rec.step_begin(BATCH, reqs, device)
        marks = LIVE.marks
        marks.append((Span.LOCK_WAIT, pc()))
        marks.append((~Span.LOCK_WAIT, pc()))
        marks.append((Span.FLUSH, pc()))
        marks.append((~Span.FLUSH, pc(), BATCH, BATCH * 64 * 64 * 3))
        marks.append((Span.LAUNCH, pc()))
        for code in (Span.PREPROCESS, Span.MODEL, Span.POST, ~Span.POST):
            marks.append((code, pc()))
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((Span.DEVICE_STEP, event))
        marks.append((~Span.LAUNCH, pc()))
        rec.step_end(token)

    def untimed():
        torch.cuda.Event(enable_timing=False).record()
    return recorded, untimed


def replay_us(device, n: int = REPLAY) -> float:
    """A recorded step's own host work, less the untimed event."""
    out = []
    for fn in replay(device):
        fn()
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize(device)
    return out[0] - out[1]


def cpu_clock() -> dict:
    t, n = time.perf_counter(), 2000
    for _ in range(n):
        time.thread_time_ns()
    read = (time.perf_counter() - t) / n * 1e6
    steps, last, end = [], time.thread_time_ns(), time.perf_counter() + 0.5
    while time.perf_counter() < end:
        now = time.thread_time_ns()
        if now != last:
            steps.append(now - last)
            last = now
    return {"cpu_clock_read_us": read,
            "cpu_clock_tick_us": min(steps) / 1e3 if steps else None}


def main() -> int:
    cfg = run.load_json(ROOT / "configs" / "yolov8n-416.json")
    engine = serving.build_engine(
        serving.server_config(cfg, BATCH, ROOT), "cuda")
    if BATCH not in engine.config.tpu.batch_buckets:
        raise SystemExit(f"b{BATCH} is not a batch bucket")
    loop = Loop(engine)
    prof = _profiler()
    prof.start()  # load the profiler's tracing once, outside the phases
    prof.stop()
    loop.run(200)
    out = {"device": torch.cuda.get_device_name(0),
           "power_limit": run.power_label(), "batch": BATCH,
           "disarmed_sites_us": disarmed_sites_us(),
           "loop_us": loop.run(STEPS) * 1e6}
    real_armed = scheduler.armed
    sides = {"on": [], "off": []}
    prof = _profiler()
    prof.start()
    try:
        for k in range(STEPS // BLOCK // 2):
            for side in (("on", "off") if k % 2 == 0 else ("off", "on")):
                scheduler.armed = (real_armed if side == "on"
                                   else (lambda: False))
                sides[side].append(loop.run(BLOCK) * 1e6)
        scheduler.armed = real_armed
        n0 = SPANS.steps
        loop.run(10)
        recorded = SPANS.steps - n0
        out["replay_us"] = replay_us(engine.device)
        scheduler.armed = lambda: False
        recorded_fn, untimed_fn = replay(engine.device)
        out["replay_in_loop_us"] = (loop.run(500, recorded_fn)
                                    - loop.run(500, untimed_fn)) * 1e6
    finally:
        scheduler.armed = real_armed
        prof.stop()
    d = [a - b for a, b in zip(sides["on"], sides["off"])]
    out["armed"] = {
        "on_us": statistics.mean(sides["on"]),
        "off_us": statistics.mean(sides["off"]),
        "on_less_off_us": statistics.mean(d),
        "stderr_us": statistics.stdev(d) / len(d) ** 0.5,
        "on_less_off_median_us": statistics.median(d),
        "blocks": len(d), "recorded_of_10": recorded}
    out.update(cpu_clock())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
