"""Device-step timing by the pipeline method: the port's copy of the JAX
package's `utils/bench_util.py`.

Dispatch N steps back to back (the device runs them in stream order), read
back only the LAST output, and difference two pipeline lengths so the
constant cost of that one readback cancels:

    step = (T(N2) - T(N1)) / (N2 - N1)

On the card a step returns before the device is done; the readback (a copy
of the last output to the host) is the one synchronization, so the
difference times the device's lane (or the host's dispatch, whichever is
slower), with no sleep and no other sync. One implementation, so that the
train step bench and the serving-step measurements cannot drift.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def _readback(out) -> None:
    """Copy `out` to the host: a tensor's `.cpu()` waits for the device."""
    if hasattr(out, "cpu"):
        out.cpu()
    else:
        np.asarray(out)


def cached_step_runner(engine, batch: int, bucket_hw: Tuple[int, int],
                       frame_h: int, frame_w: int,
                       frames: Optional[np.ndarray] = None,
                       conv1x1: str = "kernel") -> Callable[[], object]:
    """run_once() of the cached serving step the batcher dispatches: the
    engine's `get_step_cached` (1x1 route `conv1x1`) over a frame cache of
    `frames` (default: seeded noise) on the engine's device, with the
    packed (3, B) slots/heights/widths tensor."""
    import torch
    bh, bw = bucket_hw
    if frames is None:
        frames = np.random.default_rng(0).integers(
            0, 256, (batch, bh, bw, 3), dtype=np.uint8)
    step = engine.get_step_cached(batch, (bh, bw), conv1x1=conv1x1)
    cache = torch.from_numpy(np.ascontiguousarray(frames)).to(engine.device)
    shw = torch.from_numpy(np.stack([
        np.arange(batch, dtype=np.int32) % len(frames),
        np.full((batch,), frame_h, np.int32),
        np.full((batch,), frame_w, np.int32)])).to(engine.device)
    p, cw = engine._params, engine._class_weights
    conf = engine.config.confidence_threshold
    iou = engine.config.nms_threshold

    def run_once():
        return step(p, cache, shw, cw, conf, iou)

    return run_once


def measure_cached_step(engine, batch: int, bucket_hw: Tuple[int, int],
                        frame_h: int, frame_w: int,
                        frames: Optional[np.ndarray] = None,
                        **pipeline_kw) -> Tuple[float, float]:
    """Time the cached serving step (`cached_step_runner`) by the pipeline
    method below. Returns (step_seconds, readback_seconds)."""
    return pipeline_step_seconds(
        cached_step_runner(engine, batch, bucket_hw, frame_h, frame_w,
                           frames), **pipeline_kw)


def pipeline_step_seconds(run_once: Callable[[], object],
                          n1: int = 10, n2: int = 50,
                          repeats: int = 2) -> Tuple[float, float]:
    """Returns (step_seconds, readback_seconds).

    run_once() must dispatch one device step and return its output (a
    tensor, whose copy to the host is the single readback). The first
    call here builds and warms; callers need not warm up."""
    _readback(run_once())

    def pipeline(n: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = run_once()
        _readback(out)
        return time.perf_counter() - t0

    pipeline(3)
    t1 = min(pipeline(n1) for _ in range(repeats))
    t2 = min(pipeline(n2) for _ in range(repeats))
    step_s = max((t2 - t1) / (n2 - n1), 1e-6)
    rtt_s = max(t1 - n1 * step_s, 0.0)
    return step_s, rtt_s


def smoke() -> bool:
    """ZLT_BENCH_SMOKE=1: the tools' CPU mechanics sizes (yolov8p, 64-96 px)
    and short pipelines."""
    return os.environ.get("ZLT_BENCH_SMOKE") == "1"


def pipeline_kw() -> Dict[str, int]:
    """The pipeline lengths the tools time with: the method's defaults, or
    (2, 6, 1 repeat) in smoke mode, where only the mechanics are checked."""
    return dict(n1=2, n2=6, repeats=1) if smoke() else {}


def device_label(device) -> str:
    """The device a measurement ran on, for its JSON: a CUDA device's name
    and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (a card may be set below its maximum
    power and then runs slower), else torch's name for the device
    ("cpu"). The one place the card's label is read: a number without it
    is not kept, so a failed query raises."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_params(variant: str, num_classes: int = 4):
    """The tools' model: the port's `init_params` (seed 0, folded), a NumPy
    tree of `variant`'s widths."""
    from ..models.yolov8 import get_spec, init_params
    return init_params(0, get_spec(variant, num_classes), folded=True)


def serving_config_dict(variant: str, size: int, batches: Sequence[int],
                        bucket_hw: Tuple[int, int], dtype: str = "bfloat16",
                        topk: int = 256, **tpu) -> dict:
    """The tools' serving config as a dict (the JAX scripts' dict, which
    the JAX package's `ServerConfig.from_dict` reads too): 4 classes,
    confidence 0.5, NMS 0.45, the letterbox_mxu preprocess, one frame
    bucket, `tpu` keys added."""
    return {
        "confidence_threshold": 0.5, "nms_threshold": 0.45,
        "detection": {"model_width": size, "model_height": size},
        "tpu": {"variant": variant, "num_classes": 4, "dtype": dtype,
                "batch_buckets": sorted(set(batches)),
                "pre_nms_topk": topk, "frame_buckets": [list(bucket_hw)],
                "preprocess": "letterbox_mxu", **tpu},
    }


def serving_config(*args, **kwargs):
    """`serving_config_dict` as the port's ServerConfig."""
    from ..config import ServerConfig
    return ServerConfig.from_dict(serving_config_dict(*args, **kwargs))


def event_ms(fn: Callable[[], object], iters: int = 20,
             warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls on the current CUDA
    device (CUDA events). The calls are queued behind a spin of the GPU
    (torch.cuda._sleep) long enough for the host to enqueue them all, so
    the host's launch overhead does not show as idle time between the
    launches the events bracket."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_ms + 1.0, 2000.0) * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn: Callable[[], object], device, iters: int = 20) -> float:
    """One call's time: `event_ms` on a CUDA device; on the CPU the mean
    host-clock time of `iters` calls after one warm-up (a CPU time, not a
    device's)."""
    import torch
    if torch.device(device).type == "cuda":
        return event_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


class Sweep:
    """The rows of an A/B sweep. `row(label, fn)` runs one row: a row that
    raises is printed as FAILED on stderr and the sweep goes on, keeping
    the rows that ran (the JAX scripts' stance); `exit_code()` is then 1,
    so that no failure hides behind the rows that ran."""

    def __init__(self) -> None:
        self.failed: Dict[str, str] = {}  # label -> the error

    def row(self, label: str, fn: Callable[[], object]):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — one row must not end the sweep
            self.failed[label] = f"{type(e).__name__}: {e}"
            print(f"# {label} FAILED: {self.failed[label]}",
                  file=sys.stderr, flush=True)
            return None

    def exit_code(self) -> int:
        if self.failed:
            print(f"# {len(self.failed)} row(s) FAILED: {list(self.failed)}",
                  file=sys.stderr, flush=True)
        return 1 if self.failed else 0


__all__ = ["Sweep", "cached_step_runner", "call_ms", "device_label",
           "event_ms", "measure_cached_step", "pipeline_kw",
           "pipeline_step_seconds", "seeded_params", "serving_config",
           "serving_config_dict",
           "smoke"]
