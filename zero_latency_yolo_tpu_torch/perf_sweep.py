"""Serving-layout sweep: baseline against the dot1x1 and space-to-depth
stem layouts, on the exact serving step.

    python -m zero_latency_yolo_tpu_torch.perf_sweep [--batch 64]
        [--size 416] [--variant yolov8n] [--trace NAME] [--device cuda]

Times the cached serving step (`InferenceEngine.get_step_cached`, bf16,
600x800 frames in a 608x800 bucket) of each row by the pipeline method
(`utils/bench_util.py` `pipeline_step_seconds`): baseline, dot1x1
(tpu.dot1x1), s2d (tpu.stem "s2d") and s2d+dot1x1. tpu.dot1x1 has no
effect in the port (every k=1 s=1 conv already runs as the 1x1 kernel), so
its rows are not timed again: each says `"same_route_as"` the row it
equals. `--trace NAME` also traces 30 steps of that row with
`utils/profiling.trace` into `--trace-dir` (read it with `trace_analyze
--analyze-only`).

Prints one JSON object, the JAX package's `scripts/perf_sweep.py` keys
(`metric`, `batch`, `size`, `device`: the card's name and power limit,
`results`); a row that fails has `error`, is printed FAILED, and the tool
exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.device import require_device

SWEEPS = {
    "baseline": {},
    "dot1x1": {"dot1x1": True},
    "s2d": {"stem": "s2d"},
    "s2d+dot1x1": {"stem": "s2d", "dot1x1": True},
}
# Rows that run the same step as another (tpu.dot1x1 changes nothing).
SAME_ROUTE_AS = {"dot1x1": "baseline", "s2d+dot1x1": "s2d"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--variant", default="yolov8n")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--bucket-h", type=int, default=608)
    ap.add_argument("--bucket-w", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--trace", default="",
                    help="also trace this sweep row (e.g. s2d)")
    ap.add_argument("--trace-dir", default=os.path.join("logs", "perf_sweep"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "perf_sweep")

    from .runtime.engine import InferenceEngine
    from .utils.bench_util import (Sweep, cached_step_runner, device_label,
                                   pipeline_kw, pipeline_step_seconds,
                                   seeded_params, serving_config)
    from .utils.profiling import trace

    bh, bw, h, w = args.bucket_h, args.bucket_w, args.height, args.width
    params = seeded_params(args.variant)
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, bh, bw, 3), dtype=np.uint8)
    sweep = Sweep()
    results = {}

    def one(name, over):
        cfg = serving_config(args.variant, args.size, [args.batch], (bh, bw),
                             dtype=args.dtype, **over)
        eng = InferenceEngine(cfg, params=params, device=args.device)
        run_once = cached_step_runner(eng, args.batch, (bh, bw), h, w, frames)
        step_s, _ = pipeline_step_seconds(run_once, **pipeline_kw())
        results[name] = {"step_ms": round(step_s * 1e3, 3),
                         "fps": round(args.batch / step_s, 1)}
        print(f"# {name}: {args.batch / step_s:.0f} fps, step="
              f"{step_s * 1e3:.3f} ms", file=sys.stderr, flush=True)
        if args.trace == name:
            with trace(args.trace_dir):
                for _ in range(30):
                    out = run_once()
                out.cpu()
            print(f"# trace written to {args.trace_dir}", file=sys.stderr)
        return eng

    device = None
    for name, over in SWEEPS.items():
        if name in SAME_ROUTE_AS:
            results[name] = {"same_route_as": SAME_ROUTE_AS[name]}
            continue
        eng = sweep.row(name, lambda n=name, o=over: one(n, o))
        if eng is None:
            results[name] = {"error": sweep.failed[name]}
        else:
            device = eng.device
    print(json.dumps({"metric": "layout_sweep", "batch": args.batch,
                      "size": args.size, "dtype": args.dtype,
                      "device": device_label(device or args.device),
                      "results": results}), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
