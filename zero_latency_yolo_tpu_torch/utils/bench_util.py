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

import time
from typing import Callable, Optional, Tuple

import numpy as np


def _readback(out) -> None:
    """Copy `out` to the host: a tensor's `.cpu()` waits for the device."""
    if hasattr(out, "cpu"):
        out.cpu()
    else:
        np.asarray(out)


def measure_cached_step(engine, batch: int, bucket_hw: Tuple[int, int],
                        frame_h: int, frame_w: int,
                        frames: Optional[np.ndarray] = None
                        ) -> Tuple[float, float]:
    """Time the cached serving step the batcher dispatches: the engine's
    `get_step_cached` over a frame cache on the engine's device, with the
    packed (3, B) slots/heights/widths tensor, by the pipeline method
    below. Returns (step_seconds, readback_seconds)."""
    import torch
    bh, bw = bucket_hw
    if frames is None:
        frames = np.random.default_rng(0).integers(
            0, 256, (batch, bh, bw, 3), dtype=np.uint8)
    step = engine.get_step_cached(batch, (bh, bw))
    cache = torch.from_numpy(np.ascontiguousarray(frames)).to(engine.device)
    shw = torch.from_numpy(np.stack([
        np.arange(batch, dtype=np.int32),
        np.full((batch,), frame_h, np.int32),
        np.full((batch,), frame_w, np.int32)])).to(engine.device)
    p, cw = engine._params, engine._class_weights
    conf = engine.config.confidence_threshold
    iou = engine.config.nms_threshold

    def run_once():
        return step(p, cache, shw, cw, conf, iou)

    return pipeline_step_seconds(run_once)


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


__all__ = ["measure_cached_step", "pipeline_step_seconds"]
