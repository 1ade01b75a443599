"""Spatial multi-frame packing proxy: the model's forward at (B, S) against
(B/4, 2S), equal pixels and equal conv FLOPs.

    python -m zero_latency_yolo_tpu_torch.pack_proxy [--device cuda]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.pack_proxy \\
        --device cpu                                   # CPU mechanics

Tiling 2x2 frames into one 2S x 2S plane quadruples each dispatch's
spatial work at identical FLOPs, which could fill a device that small
deep planes (13x13 at stride 32 at 416) underfill. This proxy times only
the conv stack and the decode (`models/yolov8.py` `forward_decoded`, bf16,
the port's seeded `init_params`) at each equal-pixel pair by the pipeline
method (`utils/bench_util.py`, 6 and 24 calls), before any un-tiling is
built: if the packed shape is not faster a frame, packing is moot. Rows:
yolov8n 64@416, 32@416 and 64@320, yolov8s 16@640 (ZLT_PACK_ROWS
"variant:batch:size,..." replaces them).

Prints one JSON object, the JAX package's `scripts/pack_proxy.py` keys
(`pairs` of {variant, batch, size, flat_ms, flat_rtt_ms, packed_ms,
packed_rtt_ms, packed_speedup}, `device`: the card's name and power
limit). A row that fails is printed FAILED and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.device import require_device


def rows_from_env(smoke: bool) -> list:
    env = os.environ.get("ZLT_PACK_ROWS")
    if env:
        return [(v, int(b), int(s)) for v, b, s in
                (r.split(":") for r in env.split(","))]
    if smoke:
        return [("yolov8p", 8, 64)]
    return [("yolov8n", 64, 416), ("yolov8n", 32, 416),
            ("yolov8n", 64, 320), ("yolov8s", 16, 640)]


def forward_runner(variant: str, x_np: np.ndarray, dtype, device):
    """run_once() of `forward_decoded` on x (B, S, S, 3) in [0, 1], with the
    seeded params placed on `device` as the engine places them."""
    import torch

    from .models.weights import params_from_jax, place_params
    from .models.yolov8 import forward_decoded, get_spec
    from .utils.bench_util import seeded_params
    spec = get_spec(variant, 4)
    params = place_params(params_from_jax(seeded_params(variant)),
                          torch.device(device), dtype)
    x = torch.from_numpy(x_np).to(device)

    @torch.inference_mode()
    def run_once():
        return forward_decoded(params, spec, x, dtype=dtype)
    return run_once


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device, "pack_proxy")

    import torch

    from .utils.bench_util import (Sweep, device_label, pipeline_kw,
                                   pipeline_step_seconds, smoke)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    lengths = pipeline_kw() or dict(n1=6, n2=24)
    rng = np.random.default_rng(0)
    sweep = Sweep()
    out = {"pairs": [], "dtype": args.dtype,
           "device": device_label(args.device)}

    def one(variant, batch, size):
        row = {"variant": variant, "batch": batch, "size": size}
        for label, (b, s) in (("flat", (batch, size)),
                              ("packed", (batch // 4, size * 2))):
            x_np = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
            step_s, rtt_s = pipeline_step_seconds(
                forward_runner(variant, x_np, dtype, args.device), **lengths)
            row[label + "_ms"] = round(step_s * 1e3, 3)
            row[label + "_rtt_ms"] = round(rtt_s * 1e3, 1)
            print(f"  {variant} {label} ({b},{s}): {step_s * 1e3:.3f} ms",
                  file=sys.stderr, flush=True)
        row["packed_speedup"] = round(row["flat_ms"] / row["packed_ms"], 3)
        out["pairs"].append(row)

    for variant, batch, size in rows_from_env(smoke()):
        sweep.row(f"{variant} {batch}@{size}",
                  lambda v=variant, b=batch, s=size: one(v, b, s))
    print(json.dumps(out), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
