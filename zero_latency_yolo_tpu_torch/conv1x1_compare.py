"""A/B of the 1x1 route on the exact serving step: the hand-written 1x1
kernel (`ops/conv1x1_cuda.py`) against the library (`torch.addmm` of the
bias and the flattened activation with the weight, then `F.silu`, in the
step's dtype) for every k=1 s=1 conv.

    python -m zero_latency_yolo_tpu_torch.conv1x1_compare [--batches 16,32,64]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.conv1x1_compare \\
        --device cpu                                   # CPU mechanics

Measures the cached serving step (`InferenceEngine.get_step_cached`, the
program the ContinuousBatcher dispatches; the route is its `conv1x1`
keyword, no config key and no serving path) by the pipeline method
(`utils/bench_util.py`), yolov8n at 416 in bf16 over 600x800 frames,
interleaved per batch: kernel, library, then the kernel again as the drift
sentinel. Each row also gives the step's launches of each kernel on its
route (the library route launches no 1x1 kernel).

Before the last line, one JSON line per distinct 1x1 call of each batch's
step (M, Cin, Cout and whether SiLU follows; `count` calls of that shape a
step): the kernel's time and the library's on the step's own inputs (CUDA
events on the card; on the CPU a host time), its route plan. The last line
is the JAX package's `scripts/conv1x1_compare.py` object, `{"rows":
[...]}`, with the rows' `conv1x1` the route ("kernel" or "library") and
`relay_rtt_ms` the pipeline's readback time, plus `variant`, `size`,
`dtype` and `device` (the card's name and power limit). A row that fails is
printed FAILED and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .utils.device import require_device

COMBOS = ("kernel", "library", "kernel-repeat")


def record_calls(run_once) -> dict:
    """The 1x1 kernel's calls of one run_once() (a kernel-route step):
    {(M, Cin, Cout, act): [(x, w, b, act), count]}, the first call's
    inputs of each shape."""
    from .models import yolov8 as ym
    calls: dict = {}
    saved = ym.conv1x1_bias_act

    def rec(x, w, b, act=True, **kw):
        key = (int(x.shape[0]), int(x.shape[1]), int(w.shape[1]), bool(act))
        if key in calls:
            calls[key][1] += 1
        else:
            calls[key] = [(x, w, b, bool(act)), 1]
        return saved(x, w, b, act=act, **kw)

    ym.conv1x1_bias_act = rec
    try:
        run_once()
    finally:
        ym.conv1x1_bias_act = saved
    return calls


def call_rows(calls: dict, batch: int, device) -> list:
    """The per-call A/B of each distinct shape: kernel and library ms."""
    import torch
    import torch.nn.functional as F

    from .ops import conv1x1_cuda
    from .utils.bench_util import call_ms
    rows = []
    for (m, cin, cout, act), ((x, w, b, _), count) in calls.items():
        bl = b.to(x.dtype)

        def kernel():
            return conv1x1_cuda.conv1x1_bias_act(x, w, b, act)

        def library():
            y = torch.addmm(bl, x, w)
            return F.silu(y) if act else y
        plan = (conv1x1_cuda.conv1x1_plan(x, w).route if x.is_cuda
                else "plain")
        rows.append({"batch": batch, "m": m, "cin": cin, "cout": cout,
                     "act": act, "count": count, "route": plan,
                     "kernel_ms": call_ms(kernel, device),
                     "library_ms": call_ms(library, device)})
    return rows


def step_launches(run_once) -> dict:
    """Each kernel's launches in one run_once() (ops/launches.py counts)."""
    from .ops.launches import launch_counts
    before = launch_counts()
    run_once()
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


def main(argv=None) -> int:
    from .utils.bench_util import smoke
    sm = smoke()
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--batches", default="2" if sm else "16,32,64")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "conv1x1_compare")
    batches = [int(b) for b in args.batches.split(",")]

    from .runtime.engine import InferenceEngine
    from .utils.bench_util import (Sweep, cached_step_runner, device_label,
                                   pipeline_step_seconds, pipeline_kw,
                                   seeded_params, serving_config)

    variant = "yolov8p" if sm else "yolov8n"
    size = 64 if sm else 416
    bh, bw = (96, 96) if sm else (608, 800)
    h, w = (64, 96) if sm else (600, 800)
    cfg = serving_config(variant, size, batches, (bh, bw), dtype=args.dtype)
    engine = InferenceEngine(cfg, params=seeded_params(variant),
                             device=args.device)
    rng = np.random.default_rng(0)
    sweep = Sweep()
    out = {"rows": [], "variant": variant, "size": size, "dtype": args.dtype,
           "device": device_label(engine.device)}
    for batch in batches:
        frames = rng.integers(0, 256, (batch, bh, bw, 3), dtype=np.uint8)
        runners = {r: cached_step_runner(engine, batch, (bh, bw), h, w,
                                         frames, conv1x1=r)
                   for r in ("kernel", "library")}

        def per_call(batch=batch, run=runners["kernel"]):
            for row in call_rows(record_calls(run), batch, engine.device):
                print(json.dumps(row), flush=True)
        sweep.row(f"b{batch} per-call", per_call)

        def one(tag, batch=batch, runners=runners):
            route = tag.split("-")[0]
            launches = step_launches(runners[route])
            step_s, rtt_s = pipeline_step_seconds(runners[route],
                                                  **pipeline_kw())
            row = {"batch": batch, "conv1x1": route, "tag": tag,
                   "step_ms": round(step_s * 1e3, 3),
                   "fps": round(batch / step_s, 1),
                   "relay_rtt_ms": round(rtt_s * 1e3, 1),
                   "launches": launches}
            out["rows"].append(row)
            print(f"# b{batch} {tag}: {row['step_ms']} ms ({row['fps']} fps, "
                  f"readback {row['relay_rtt_ms']} ms)", file=sys.stderr,
                  flush=True)

        for tag in COMBOS:
            sweep.row(f"b{batch} {tag}", lambda t=tag: one(t))
    print(json.dumps(out), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
