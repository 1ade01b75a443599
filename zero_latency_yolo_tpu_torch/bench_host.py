#!/usr/bin/env python3
"""Host cost of the port's serving step on one NVIDIA GPU: the host time a
kernel wrapper call takes to return, and the step's host and wall time per
batch bucket. The eager step is bound by the host, so a wrapper that does
more per call can slow the step even where device time falls.

    python3 zero_latency_yolo_tpu_torch/bench_host.py [--root DIR] [--label L]

`--root` imports `zero_latency_yolo_tpu_torch` (and reads the deployed
config and weights, and `chip_smoke.py`'s frames) from DIR instead of this
checkout, so two commits can be compared on one card: unpack the other
with `git archive` and run the two in turns, each in its own process. The
script uses only what every version of the port has had: `InferenceEngine`
with `get_step` and its placed parameters, the wrappers
`conv1x1_bias_act(x, w, b, act)` and `bias_silu(y, b)`, `ops/nms.py`
`_nms_and_compact` and `_compact_one`, and `chip_smoke.synthetic_frame`.

Prints one JSON line:
- `wrapper_us`: host microseconds a call takes to return, mean over
  `--reps` calls, averaged over every 1x1 block of the model
  (`conv1x1_bias_act`, x of 1352 rows: batch 8 at 13x13) and over every
  other conv block's bias (`bias_silu` on an (8, 26, 26, C) map). Right
  after each block the same is timed for `F.silu(y + b)` on a fixed
  (8, 26, 26, 64) map, two PyTorch launches that no version of the port
  changes: the host's own speed at that moment. `per_control` is the mean
  of each wrapper's time over the control's beside it, the figure to
  compare between runs, which a busier host moves less;
- `step`: per batch bucket (608x800 frames), the median and mean over
  `--steps` steps of the host time until the step returns (`host_ms`) and
  of the time until the device has finished it (`wall_ms`);
- `profile_b8`: the batch-8 step on the game frames of `chip_smoke.py`
  (`synthetic_frame(800, 600, seed=s)`, s = 0..7) under torch.profiler
  (`step_profile`): CUDA kernels launched a step, device busy time, and
  the device time and kernel count of the NMS stage (everything
  `ops/nms.py` `_nms_and_compact` launches before `_compact_one`: in every
  version of the port, the IoU, same-class and suppression work).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

BUCKET = (608, 800)
STAGE, COMPACT = "zlt_nms_and_compact", "zlt_compact"


def step_profile(torch, fn, iters: int = 5, nms_stages: int = 1) -> dict:
    """Device time of fn(), one serving step, by kernel (torch.profiler, CUDA
    activity), per step over `iters` steps: `wall_ms`, `busy_ms` (kernels
    and copies), `kernels` (kernel launches, copies and memsets not
    counted), `nms_stage_ms` and `nms_stage_kernels`, and `rows`, one
    (device ms, launches, name) per kernel name, the largest first.
    `nms_stages`: the NMS stages one call of fn runs (a serving mesh's
    step runs one a data row); the stage numbers are per call.

    The NMS stage is read from the profiler's tree of host ranges: for the
    duration of the profile, `_nms_and_compact` and `_compact_one` of the
    port's `ops/nms.py` run inside named ranges, and the stage is every
    kernel launched inside the first before the second begins."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from zero_latency_yolo_tpu_torch.ops import nms as nms_ops

    def ranged(name, f):
        def run(*args, **kwargs):
            with record_function(name):
                return f(*args, **kwargs)
        return run

    fn()
    torch.cuda.synchronize()
    saved = nms_ops._nms_and_compact, nms_ops._compact_one
    nms_ops._nms_and_compact = ranged(STAGE, saved[0])
    nms_ops._compact_one = ranged(COMPACT, saved[1])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
    finally:
        nms_ops._nms_and_compact, nms_ops._compact_one = saved
    # The ranges also show on the device's timeline; they are not kernels.
    rows = sorted(((e.self_device_time_total / 1e3 / iters, e.count // iters,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in (STAGE, COMPACT)), reverse=True)

    # Each kernel on the device timeline carries the correlation id of the
    # runtime call that launched it (cudaLaunchKernel and kin), which sits
    # in the host's tree of ranges under the op, or the range, it ran in.
    events = prof.events()
    device = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith(("Memcpy", "Memset"))):
            device.setdefault(e.id, []).append(e)

    def launched(ev):
        found = device.get(ev.id, []) if "Launch" in ev.name else []
        return found + [k for c in ev.cpu_children for k in launched(c)]

    stage_us, stage_kernels, stages = 0.0, 0, 0
    for ev in events:
        if ev.name != STAGE or ev.device_type != DeviceType.CPU:
            continue
        compact = [c for c in ev.cpu_children if c.name == COMPACT]
        if len(compact) != 1:
            raise RuntimeError(f"step_profile: {len(compact)} {COMPACT} "
                               f"ranges in one {STAGE}")
        ks = [k for c in ev.cpu_children
              if c.time_range.start < compact[0].time_range.start
              for k in launched(c)]
        stage_us += sum(k.time_range.end - k.time_range.start for k in ks)
        stage_kernels += len(ks)
        stages += 1
    if stages != iters * nms_stages:
        raise RuntimeError(f"step_profile: {stages} NMS stages in {iters} "
                           f"steps of {nms_stages}")
    return {"wall_ms": wall, "busy_ms": sum(r[0] for r in rows),
            "kernels": sum(n for _, n, key in rows
                           if not key.startswith(("Memcpy", "Memset"))),
            "nms_stage_ms": stage_us / 1e3 / iters,
            "nms_stage_kernels": stage_kernels / iters, "rows": rows}


def host_us(torch, fn, reps: int) -> float:
    """Mean host time of fn() over `reps` calls queued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def conv_blocks(node, out):
    """Every conv block {"b": ..., "w" or "w_mm": ...} of a placed tree."""
    if isinstance(node, list):
        for v in node:
            conv_blocks(v, out)
    elif "b" in node:
        out.append(node)
    else:
        for v in node.values():
            conv_blocks(v, out)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose zero_latency_yolo_tpu_torch to run")
    ap.add_argument("--label", default="", help="name printed with the result")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # This file's own directory is the package; import it only from root.
    sys.path = [str(root)] + [p for p in sys.path[1:]]

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("bench_host: no CUDA device")
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine

    cfg = ServerConfig.load(str(root / "configs" / "examples"
                                / "server-cs16-416.json"),
                            create_if_missing=False)
    cfg.model_path = str(root / cfg.model_path)
    engine = InferenceEngine(cfg, device="cuda")
    if engine.simulation:
        raise SystemExit(f"bench_host: {cfg.model_path} did not load")
    dev, dtype = engine.device, engine.dtype
    engine.warmup()
    g = torch.Generator(device=dev).manual_seed(0)
    blocks = conv_blocks(engine._params, [])

    with torch.inference_mode():
        yc = torch.randn(8, 26, 26, 64, generator=g, device=dev).to(dtype)
        bc = torch.zeros(64, device=dev, dtype=dtype)
        timed = {"conv1x1_bias_act": [], "bias_silu": []}  # (us, control us)
        for p in blocks:
            if "w_mm" in p:
                x = torch.randn(1352, p["w_mm"].shape[0], generator=g,
                                device=dev).to(dtype)
                name, fn = "conv1x1_bias_act", (
                    lambda: conv1x1_cuda.conv1x1_bias_act(x, p["w_mm"],
                                                          p["b"], True))
            else:
                y = torch.randn(8, 26, 26, p["b"].shape[0], generator=g,
                                device=dev).to(dtype)
                name, fn = "bias_silu", lambda: act_cuda.bias_silu(y, p["b"])
            timed[name].append((host_us(torch, fn, args.reps),
                                host_us(torch, lambda: F.silu(yc + bc),
                                        args.reps)))

        step, profile_b8 = {}, None
        rng = np.random.default_rng(0)
        for b in engine.batch_buckets:
            frames = torch.from_numpy(rng.integers(
                0, 256, (b,) + BUCKET + (3,), dtype=np.uint8)).to(dev)
            hs = torch.full((b,), BUCKET[0], dtype=torch.int32, device=dev)
            ws = torch.full((b,), BUCKET[1], dtype=torch.int32, device=dev)
            fn = engine.get_step(b, BUCKET)
            run_args = (engine._params, frames, hs, ws, engine._class_weights,
                        cfg.confidence_threshold, cfg.nms_threshold)
            for _ in range(5):
                fn(*run_args)
            torch.cuda.synchronize()
            host, wall = [], []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                fn(*run_args)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                host.append((t1 - t0) * 1e3)
                wall.append((t2 - t0) * 1e3)
            step[b] = {"host_ms_median": statistics.median(host),
                       "host_ms_mean": statistics.fmean(host),
                       "wall_ms_median": statistics.median(wall),
                       "wall_ms_mean": statistics.fmean(wall)}
            if b == 8:
                from chip_smoke import synthetic_frame
                game = np.zeros((8,) + BUCKET + (3,), np.uint8)
                game[:, :600, :800] = [synthetic_frame(800, 600, seed=s)
                                       for s in range(8)]
                hs = torch.full((8,), 600, dtype=torch.int32, device=dev)
                ws = torch.full((8,), 800, dtype=torch.int32, device=dev)
                game_args = (engine._params, torch.from_numpy(game).to(dev),
                             hs, ws) + run_args[4:]
                profile_b8 = step_profile(torch, lambda: fn(*game_args))
                profile_b8["rows"] = profile_b8["rows"][:20]

    print(json.dumps({
        "label": args.label, "root": str(root),
        "device": torch.cuda.get_device_name(0),
        "wrapper_us": {name: {
            "us": statistics.fmean(u for u, _ in t),
            "control_us": statistics.fmean(c for _, c in t),
            "per_control": statistics.fmean(u / c for u, c in t),
            "blocks": len(t)} for name, t in timed.items()},
        "step": step, "profile_b8": profile_b8}), flush=True)


if __name__ == "__main__":
    main()
