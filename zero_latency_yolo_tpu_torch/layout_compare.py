"""A/B of the serving-layout flags on the exact serving step: tpu.select
("concat" or "perlevel" candidate selection) x tpu.c2f ("slice" or
"split" C2f).

    python -m zero_latency_yolo_tpu_torch.layout_compare [--batches 32,64,128]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.layout_compare \\
        --device cpu                                   # CPU mechanics

Measures the cached serving step (`InferenceEngine.get_step_cached`, the
program the ContinuousBatcher dispatches) of every (select, c2f) combo by
the pipeline method (`utils/bench_util.py`), interleaved per batch, with
the baseline repeated last as the drift sentinel; yolov8n at 416 in bf16
over 600x800 frames unless ZLT_LC_VARIANT / ZLT_LC_SIZE / ZLT_LC_TOPK say
otherwise. Prints one JSON object, the JAX package's
`scripts/layout_compare.py` keys (`relay_rtt_ms`: the pipeline's readback
time) plus `device`, the card's name and power limit. A row that fails is
printed FAILED and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.device import require_device

COMBOS = (
    ("concat", "slice"),     # the shipping layout (baseline)
    ("perlevel", "slice"),
    ("concat", "split"),
    ("perlevel", "split"),
    ("concat", "slice", "repeat"),  # drift sentinel
)


def engines(variant: str, size: int, batches, bucket_hw, topk: int,
            dtype: str, device) -> dict:
    """One engine a (select, c2f) combo, on the same seeded params."""
    from .runtime.engine import InferenceEngine
    from .utils.bench_util import seeded_params, serving_config
    params = seeded_params(variant)
    out = {}
    for combo in COMBOS:
        key = combo[:2]
        if key not in out:
            cfg = serving_config(variant, size, batches, bucket_hw,
                                 dtype=dtype, topk=topk, select=key[0],
                                 c2f=key[1])
            out[key] = InferenceEngine(cfg, params=params, device=device)
    return out


def main(argv=None) -> int:
    from .utils.bench_util import smoke
    sm = smoke()
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--batches", default="2" if sm else "32,64,128")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "layout_compare")
    batches = [int(b) for b in args.batches.split(",")]

    from .utils.bench_util import (Sweep, device_label, measure_cached_step,
                                   pipeline_kw)

    variant = os.environ.get("ZLT_LC_VARIANT", "yolov8p" if sm else "yolov8n")
    size = 64 if sm else int(os.environ.get("ZLT_LC_SIZE", "416"))
    topk = int(os.environ.get("ZLT_LC_TOPK", "256"))
    bh, bw = (96, 96) if sm else (608, 800)
    h, w = (64, 96) if sm else (600, 800)
    engs = engines(variant, size, batches, (bh, bw), topk, args.dtype,
                   args.device)
    rng = np.random.default_rng(0)
    sweep = Sweep()
    out = {"rows": [], "variant": variant, "size": size,
           "pre_nms_topk": topk, "dtype": args.dtype,
           "device": device_label(next(iter(engs.values())).device)}
    for batch in batches:
        frames = rng.integers(0, 256, (batch, bh, bw, 3), dtype=np.uint8)

        def one(combo, batch=batch, frames=frames):
            select, c2f = combo[:2]
            tag = "+".join(combo)
            step_s, rtt_s = measure_cached_step(
                engs[(select, c2f)], batch, (bh, bw), h, w, frames=frames,
                **pipeline_kw())
            row = {"batch": batch, "select": select, "c2f": c2f, "tag": tag,
                   "step_ms": round(step_s * 1e3, 3),
                   "fps": round(batch / step_s, 1),
                   "relay_rtt_ms": round(rtt_s * 1e3, 1)}
            out["rows"].append(row)
            print(f"# b{batch} {tag}: {row['step_ms']} ms ({row['fps']} fps, "
                  f"readback {row['relay_rtt_ms']} ms)", file=sys.stderr,
                  flush=True)

        for combo in COMBOS:
            sweep.row(f"b{batch} {'+'.join(combo)}", lambda c=combo: one(c))
    print(json.dumps(out), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
