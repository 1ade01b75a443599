"""Serving cost over parametric model widths, on the exact serving step.

    python -m zero_latency_yolo_tpu_torch.width_ladder [--batches 32,64]
        [--widths 0.25,0.20,0.15] [--device cuda]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.width_ladder \\
        --device cpu                                   # CPU mechanics

Measures the cached serving step (`InferenceEngine.get_step_cached`, bf16,
416 over 600x800 frames) by the pipeline method (`utils/bench_util.py`) for
yolov8n (width 0.25) against narrower parametric variants
("yolov8-d0.33-w<width>-mc1024", `models/yolov8.py` `get_spec`),
interleaved per batch with the first width repeated last as the drift
sentinel. Serving cost only: the accuracy of a width is
`width_accuracy`'s. Widths snap through _make_divisible(8): 0.25 -> head
channels (64, 128, 256), 0.20 -> (56, 104, 208), 0.15 -> (40, 80, 160).

Prints one JSON object, the JAX package's `scripts/width_ladder.py` keys
(`relay_rtt_ms`: the pipeline's readback time) plus `device`, the card's
name and power limit. A row that fails is printed FAILED and the tool
exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .utils.device import require_device


def variant_name(width: float, smoke: bool) -> str:
    """yolov8n for its own width, else the parametric variant."""
    if not smoke and width == 0.25:
        return "yolov8n"
    return f"yolov8-d0.33-w{width}-mc{256 if smoke else 1024}"


def main(argv=None) -> int:
    from .utils.bench_util import smoke
    sm = smoke()
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--batches", default="2" if sm else "32,64")
    ap.add_argument("--widths", default="0.125,0.10" if sm
                    else "0.25,0.20,0.15")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "width_ladder")
    batches = [int(b) for b in args.batches.split(",")]
    widths = [float(w) for w in args.widths.split(",")]

    from .models.yolov8 import get_spec
    from .runtime.engine import InferenceEngine
    from .utils.bench_util import (Sweep, device_label, measure_cached_step,
                                   pipeline_kw, seeded_params,
                                   serving_config)

    size = 64 if sm else 416
    bh, bw = (96, 96) if sm else (608, 800)
    h, w = (64, 96) if sm else (600, 800)
    engines = {}
    for width in widths:
        variant = variant_name(width, sm)
        cfg = serving_config(variant, size, batches, (bh, bw),
                             dtype=args.dtype)
        engines[width] = InferenceEngine(cfg, params=seeded_params(variant),
                                         device=args.device)
        print(f"# w{width}: head channels "
              f"{get_spec(variant, 4).backbone_channels}", file=sys.stderr)

    sweep = Sweep()
    out = {"rows": [], "dtype": args.dtype,
           "device": device_label(engines[widths[0]].device)}
    for batch in batches:
        frames = np.random.default_rng(0).integers(
            0, 256, (batch, bh, bw, 3), dtype=np.uint8)

        def one(width, tag, batch=batch, frames=frames):
            step_s, rtt_s = measure_cached_step(
                engines[width], batch, (bh, bw), h, w, frames=frames,
                **pipeline_kw())
            row = {"batch": batch, "width": width, "tag": tag,
                   "step_ms": round(step_s * 1e3, 3),
                   "fps": round(batch / step_s, 1),
                   "relay_rtt_ms": round(rtt_s * 1e3, 1)}
            out["rows"].append(row)
            print(f"# b{batch} {tag}: {row['step_ms']} ms ({row['fps']} fps)",
                  file=sys.stderr, flush=True)

        for width, tag in [(wd, f"w{wd}") for wd in widths] + [
                (widths[0], f"w{widths[0]}-repeat")]:
            sweep.row(f"b{batch} {tag}", lambda wd=width, t=tag: one(wd, t))
    print(json.dumps(out), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
