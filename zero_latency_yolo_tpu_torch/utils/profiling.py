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
- `device_host_split` runs a callable and reports host dispatch time
  against device time (CUDA events on a CUDA device, the wall clock on the
  CPU).

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
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Tuple

import torch


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
    records every thread's CPU operators. Returns {ok, dir, seconds, files: [{name, size}], captured_at,
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


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def device_host_split(fn: Callable[[], object], iters: int = 10
                      ) -> Dict[str, float]:
    """Host dispatch time against total time of fn(), averaged over
    `iters` calls after one warm-up. Where fn's output tensors lie on a
    CUDA device, device_ms is the CUDA events' time around the call; on
    the CPU the call's work is host work, and device_ms is the total time
    less the dispatch time (about 0)."""
    out = fn()
    device = next((t.device for t in _tensors(out) if t.is_cuda), None)
    cuda = device is not None
    dispatch_ms = total_ms = device_ms = 0.0
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        dispatch_ms += (t1 - t0) * 1e3
        total_ms += (t2 - t0) * 1e3
        device_ms += (start.elapsed_time(end) if cuda
                      else (t2 - t1) * 1e3)
    return {"host_dispatch_ms": dispatch_ms / iters,
            "total_ms": total_ms / iters,
            "device_ms": device_ms / iters}
