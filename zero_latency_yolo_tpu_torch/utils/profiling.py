"""Profiling and tracing helpers on torch.profiler.

The PyTorch counterpart of the JAX package's `utils/profiling.py`:

- `trace(dir)` captures a torch.profiler trace of the enclosed block (the
  calling thread's CPU operators, and on a CUDA device every kernel and
  copy) as a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing);
- `capture(seconds)` is the bounded, single-flight capture of whatever the
  process is doing, behind the server's `POST /profilez`; `capture_status`
  behind `GET /profilez`;
- `annotate(name)` names a host-side phase on the same timeline
  (`torch.profiler.record_function`);
- `SPANS`, the serving core's span recorder, armed exactly while a
  torch.profiler session runs (`armed()`): the phases of each batcher step
  on the host clock (`time.perf_counter`), and each step's device interval
  from CUDA events set on that clock. `capture` writes the spans of its
  window as `spans.json` beside `trace.json`.

Starting or stopping torch.profiler while another thread is inside a
PyTorch operator can crash the process (a segmentation fault in the
profiler's stop, seen on an H100 while the batcher thread was inside an
operator). `capture` therefore takes a `gate`: a lock that every engine
call of the serving thread holds (`runtime/scheduler.py`
`ContinuousBatcher.device_gate`), so the profiler starts and stops only
between those calls, while the capture window itself runs unlocked.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import operator
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def _profile(host_ops: str):
    """A profiler of every kernel and copy of a CUDA device, from every
    thread, and of CPU operators: of no thread ("none"; with no CUDA device,
    of the starting thread), of the starting thread ("self"), or of every
    thread ("all", where this PyTorch offers `profile_all_threads`)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host_ops != "none" or not cuda:
        acts.append(ProfilerActivity.CPU)
    config = None
    if host_ops == "all":
        try:
            from torch._C._profiler import _ExperimentalConfig
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
    return profile(activities=acts, experimental_config=config)


@contextlib.contextmanager
def trace(log_dir: str = "logs/torch-trace"):
    """Capture a profiler trace of the enclosed block into
    `log_dir/trace.json`."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _profile("self")
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# torch.profiler is process-global (one profile at a time), so on-demand
# captures are single-flight across every caller in the process.
_capture_lock = threading.Lock()
_last_capture: Dict = {}
_capture_ids = itertools.count()


def capture(seconds: float, log_dir: str = "logs/torch-trace",
            min_s: float = 0.05, max_s: float = 30.0, gate=None) -> Dict:
    """Bounded on-demand capture of the live process: its operators, and on
    a CUDA device its kernels and copies. Blocks for `seconds`; meant to run
    on a worker thread (the /profilez route), never the event loop. `gate`,
    a lock every engine call of the serving thread holds, is held while the
    profiler starts and while it stops. On a CUDA device the capture
    records every thread's kernels and copies, and no CPU operators: the
    profiler's stop holds the GIL while it gathers its events (up to a
    quarter of a second under a loaded server on an H100 with the device
    timeline alone), and with every thread's operators too a loaded
    server's socket overflowed (PERF.md). Without a CUDA device it
    records every thread's CPU operators. The profiler arms the span
    recorder (`SPANS`) for the window: its spans are written as
    `spans.json`, Chrome-trace events on the host clock beside the
    profiler's `trace.json`. Returns {ok, dir, seconds, files: [{name,
    size}], captured_at,
    cost_ms: {start, stop, export}} (the capture's own cost: the time the
    gate was held to start and to stop, and the export), or {error} when
    the window is out of range, a capture is already in flight, or the
    profiler fails."""
    seconds = float(seconds)
    if not (min_s <= seconds <= max_s):
        return {"error": f"seconds must be in [{min_s}, {max_s}]"}
    if not _capture_lock.acquire(blocking=False):
        return {"error": "a profile capture is already in flight"}
    try:
        gate = gate if gate is not None else contextlib.nullcontext()
        out_dir = os.path.join(log_dir, "{}-{:04d}".format(
            time.strftime("%Y%m%d-%H%M%S", time.gmtime()), next(_capture_ids)))
        os.makedirs(out_dir, exist_ok=True)
        prof = _profile("none" if torch.cuda.is_available() else "all")
        t0 = time.perf_counter()
        try:
            with gate:
                prof.start()
        except Exception as e:  # noqa: BLE001 — reported, not raised
            return {"error": f"profiler failed to start: {e}"}
        t1 = time.perf_counter()
        try:
            time.sleep(seconds)
        finally:
            t2 = time.perf_counter()
            with gate:
                prof.stop()
        t3 = time.perf_counter()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        with open(os.path.join(out_dir, "spans.json"), "w") as f:
            json.dump({"traceEvents": SPANS.chrome_events(t0, t3),
                       "displayTimeUnit": "ms"}, f)
        cost = {"start": (t1 - t0) * 1e3, "stop": (t3 - t2) * 1e3,
                "export": (time.perf_counter() - t3) * 1e3}
        files = []
        for root, _dirs, names in os.walk(out_dir):
            for name in names:
                p = os.path.join(root, name)
                files.append({"name": os.path.relpath(p, out_dir),
                              "size": os.path.getsize(p)})
        result = {"ok": True, "dir": out_dir, "seconds": seconds,
                  "files": sorted(files, key=lambda f: f["name"]),
                  "captured_at": time.time(), "cost_ms": cost}
        _last_capture.clear()
        _last_capture.update(result)
        return result
    finally:
        _capture_lock.release()


def capture_status() -> Dict:
    """Non-blocking view: is a capture running, and the last result."""
    running = not _capture_lock.acquire(blocking=False)
    if not running:
        _capture_lock.release()
    return {"capturing": running, "last": dict(_last_capture) or None}


def kernel_rows(events: Iterable[Tuple[str, float, int]], steps: int
                ) -> List[Tuple[float, int, str]]:
    """Device events summed by name, per step: `events` yields (name,
    microseconds, launches) — one event of a Chrome trace (launches 1), or
    one row of torch.profiler's `key_averages()` (its total and count).
    Returns one (ms a step, launches a step, name) per name, the largest
    time first. `bench_host.step_profile` and `trace_analyze` both sum
    through this."""
    total: Dict[str, List[float]] = {}
    for name, us, n in events:
        acc = total.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += n
    return sorted(((us / 1e3 / steps, int(n) // steps, name)
                   for name, (us, n) in total.items()), reverse=True)


def annotate(name: str):
    """Named range visible in the trace timeline."""
    return torch.profiler.record_function(name)


# --------------------------------------------------------------- span recorder
def armed() -> bool:
    """True exactly while a torch.profiler session runs in this process,
    read the same on every thread: torch.autograd.profiler's process-global
    flag. (`torch._C._autograd._profiler_enabled()` is thread-local: it
    reads False on every thread but the one that started the profiler.)"""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """The recorder's span names, by id (`SPAN_NAMES[id]`). A site marks a
    span's start `(id, t)` and its end `(~id, t)` on `time.perf_counter`;
    the flush's end carries its two attributes, `(~id, t, writes, bytes)`.
    The step's phases follow one another: a phase's start ends the phase
    before it."""
    STEP = 0          # batcher.step: one dispatched group; rows, frames
    LOCK_WAIT = 1     # cache.lock_wait: acquiring the frame cache's lock
    FLUSH = 2         # cache.flush: queued writes applied; writes, bytes
    LAUNCH = 3        # engine.launch: the step's host launch
    PREPROCESS = 4    # step.preprocess: the letterbox
    MODEL = 5         # step.model: forward_decoded[_levels]
    POST = 6          # step.post: postprocess_batch[_levels] + pack
    DEVICE_STEP = 7   # device.step: the step's device interval; its mark
    #                   is (id, the completion's timing CUDA event)


SPAN_NAMES = ("batcher.step", "cache.lock_wait", "cache.flush",
              "engine.launch", "step.preprocess", "step.model", "step.post",
              "device.step")
# The two integer attributes of the spans that carry them.
SPAN_ATTRS = {Span.STEP: ("rows", "frames"), Span.FLUSH: ("writes", "bytes")}
_PHASES = (Span.PREPROCESS, Span.MODEL, Span.POST)
# An armed root this long after the previous one calibrates the device
# clock again: the device is idle by then (the batcher completes what is in
# flight when its queues run dry), so the synchronise costs nothing.
RECALIBRATE_S = 0.25
# An armed root samples its thread's CPU clock at most this often: a read
# is a system call, and on some hosts the clock ticks at 10 ms.
CPU_SAMPLE_S = 0.25
_WAIT_KEY = operator.attrgetter("client_id", "frame_id", "enqueue_t")


class _Live(threading.local):
    """The calling thread's recorded step: `marks`, the list its sites
    append their marks to, or None where this thread records no step (every
    thread while no profiler runs)."""
    marks: Optional[list] = None


# Each site reads `LIVE.marks` and, where it is None, does nothing else.
LIVE = _Live()


class SpanRecorder:
    """Spans of the serving core's steps, recorded only while a profiler
    session runs (`armed()`), in a preallocated ring that keeps the newest
    `capacity` steps (about eight spans a step).

    A step is recorded when its root (`step_begin`, the batcher's dispatch
    of one group) begins armed: the root opens `LIVE.marks` on its thread,
    and the sites the step runs through on that thread append their marks
    to it; `step_end` closes it and stores the step whole. A step whose
    root began disarmed is not recorded, even where the profiler starts
    during it. Other threads see no open step.

    On the hot path a step costs its marks (a tuple appended a site), a
    block of (client, frame, `enqueue_t`) rows for its requests, and on a
    CUDA device one timing event recorded at the root, with the completion
    event `_launched` records made timing too; a root samples the thread's
    CPU clock at most every `CPU_SAMPLE_S`. Everything else waits for
    `snapshot`: the spans' columns, each request's wait from its
    `enqueue_t` to its step's root, and each step's device interval
    (`device.step`), its two events read against a calibration event
    stamped on the host clock after a synchronise. A span left open (an
    exception, an early return) is skipped."""

    def __init__(self, capacity: int = 1 << 13) -> None:
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._ring: List[Optional[Tuple]] = [None] * capacity
        self.cpu: deque = deque(maxlen=capacity)
        self.clear()

    def clear(self) -> None:
        """Forget every step and CPU sample (the ring stays allocated)."""
        self._ring[:] = [None] * self.capacity
        self.steps = 0       # steps stored; the newest `capacity` are kept
        self.cpu.clear()     # (perf_counter, thread CPU ns, thread id)
        self._cpu_t = float("-inf")
        self._calib = None   # (device, CUDA event, its perf_counter stamp)
        self._last_root = float("-inf")

    # ------------------------------------------------------------ writing
    def step_begin(self, rows: int, requests, device=None) -> Optional[Tuple]:
        """Open a step on this thread (armed callers only); returns its
        token for `step_end`, or None where this thread has a step open.
        On a CUDA `device`, records the step's timing start event,
        calibrating the device clock first when it is due."""
        if LIVE.marks is not None:
            return None
        t = time.perf_counter()
        cuda = getattr(device, "type", None) == "cuda"
        if cuda and (self._calib is None or self._calib[0] != device
                     or t - self._last_root > RECALIBRATE_S):
            # The event is created at its first record: record it once
            # before the synchronise, so that the stamp is taken next to the
            # record the device timestamps (seen 0.1 ms apart otherwise).
            stream = torch.cuda.current_stream(device)
            calib = torch.cuda.Event(enable_timing=True)
            calib.record(stream)
            torch.cuda.synchronize(device)
            calib.record(stream)
            self._calib = (device, calib, time.perf_counter())
            t = time.perf_counter()
        self._last_root = t
        if t - self._cpu_t >= CPU_SAMPLE_S:
            self._cpu_t = t
            self.cpu.append((t, time.thread_time_ns(), threading.get_ident()))
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        marks: list = []
        LIVE.marks = marks
        return (t, int(rows), list(map(_WAIT_KEY, requests)), start,
                self._calib, marks)

    def step_end(self, token: Tuple) -> None:
        """Close the step `token` and store it."""
        t1 = time.perf_counter()
        LIVE.marks = None
        step = self.steps
        self._ring[step & self._mask] = (step, t1) + token
        self.steps = step + 1

    # ------------------------------------------------------------ reading
    def snapshot(self, since: float = float("-inf")) -> Dict[str, np.ndarray]:
        """The closed spans of the stored steps whose root began at or
        after `since`, oldest first, as columns (seq, name, t0, t1, parent:
        the enclosing span's seq or -1, step, a, b), and their requests'
        waits (wait_client, wait_frame, wait_step, wait_s). A device
        interval is read once its completion event has completed."""
        cols: Dict[str, list] = {k: [] for k in (
            "name", "t0", "t1", "parent", "step", "a", "b")}
        waits: Dict[str, list] = {k: [] for k in (
            "wait_client", "wait_frame", "wait_step", "wait_s")}

        def add(name, t0, parent, step, t1=float("nan"), a=0, b=0) -> int:
            for k, v in zip(cols, (name, t0, t1, parent, step, a, b)):
                cols[k].append(v)
            return len(cols["name"]) - 1

        n = self.steps
        for i in range(max(n - self.capacity, 0), n):
            got = self._ring[i & self._mask]
            if got is None or got[0] != i or got[2] < since:
                continue
            step, t1, t0, rows, reqs, start, calib, marks = got
            root = add(Span.STEP, t0, -1, step, t1, rows, len(reqs))
            stack = [(Span.STEP, root)]
            stop = None
            for m in marks:
                code, t = m[0], m[1]
                if code == Span.DEVICE_STEP:
                    stop = t
                elif code >= 0:
                    if code in _PHASES and stack[-1][0] in _PHASES:
                        cols["t1"][stack.pop()[1]] = t
                    stack.append((code, add(code, t, stack[-1][1], step)))
                else:
                    while len(stack) > 1:
                        name, j = stack.pop()
                        if name == ~code:
                            cols["t1"][j] = t
                            if len(m) > 2:
                                cols["a"][j], cols["b"][j] = m[2], m[3]
                            break
            if start is not None and calib is not None and stop is not None:
                try:
                    if stop.query():
                        ev, stamp = calib[1], calib[2]
                        add(Span.DEVICE_STEP,
                            stamp + ev.elapsed_time(start) * 1e-3, root,
                            step, stamp + ev.elapsed_time(stop) * 1e-3)
                except RuntimeError:  # events of another device or context
                    pass
            for c, f, enq in reqs:
                for k, v in zip(waits, (c, f, step, t0 - enq)):
                    waits[k].append(v)
        out = {"seq": np.arange(len(cols["name"]), dtype=np.int64)}
        for k, v in cols.items():
            out[k] = np.array(v, dtype=np.float64 if k in ("t0", "t1")
                              else np.int64)
        keep = ~np.isnan(out["t1"])
        out = {k: v[keep] for k, v in out.items()}
        for k, v in waits.items():
            out[k] = np.array(v, dtype=np.float64 if k == "wait_s"
                              else np.int64)
        return out

    def cpu_samples(self) -> Dict[str, np.ndarray]:
        """The roots' samples of their thread's CPU clock: columns t
        (perf_counter), cpu_ns and thread."""
        got = list(self.cpu)
        return {k: np.array([g[i] for g in got],
                            dtype=np.float64 if k == "t" else np.int64)
                for i, k in enumerate(("t", "cpu_ns", "thread"))}

    def chrome_events(self, t0: float = float("-inf"),
                      t1: float = float("inf")) -> List[Dict]:
        """The closed spans that start in [t0, t1) as Chrome-trace "X"
        events on the host clock (microseconds of `time.perf_counter`): the
        host spans on one track, `device.step` on a track of its own."""
        snap = self.snapshot(t0)
        pid = os.getpid()
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": label}}
                  for tid, label in ((1, "serving core (host)"),
                                     (2, "device.step"))]
        sel = (snap["t0"] >= t0) & (snap["t0"] < t1)
        for s, name, a0, a1, parent, step, a, b in zip(
                *(snap[k][sel] for k in ("seq", "name", "t0", "t1", "parent",
                                         "step", "a", "b"))):
            args = {"step": int(step), "seq": int(s), "parent": int(parent)}
            for key, v in zip(SPAN_ATTRS.get(int(name), ()), (a, b)):
                args[key] = int(v)
            events.append({"ph": "X", "name": SPAN_NAMES[name], "pid": pid,
                           "tid": 2 if name == Span.DEVICE_STEP else 1,
                           "ts": a0 * 1e6, "dur": (a1 - a0) * 1e6,
                           "args": args})
        return events


# The process's recorder: the profiler that arms it is process-global too.
SPANS = SpanRecorder()
