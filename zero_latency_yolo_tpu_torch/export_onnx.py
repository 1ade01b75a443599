"""Export a trained .npz artifact as an ultralytics-convention .onnx, with
the PyTorch port's `models/ultra.py`.

The reference's deployment flow consumes exactly this artifact shape
(src/inference/onnx_engine.cpp:957-1062): fused Conv+BN initializers named
`model.<idx>...`, input `images`, output `output0` = (1, 4+nc, A) decoded
px boxes + sigmoid class scores. Artifacts fine-tuned by this framework can
therefore be deployed on ANY ONNX Runtime stack — including the reference
server itself — and served by the port (`models/weights.py` `from_onnx`).

    python -m zero_latency_yolo_tpu_torch.export_onnx \
        --weights artifacts/yolov8n_trained_416.npz --variant yolov8n \
        --size 416 --out models/yolov8n_416.onnx [--device cpu]

The port's copy of the JAX package's `scripts/export_onnx.py`, with the same
arguments, JSON line and exit code, except that `--device` (default `cuda`)
takes the place of `--platform`: the twin is traced on that device. Without
a CUDA device and without `--device cpu` it exits with an error. An
unfolded (BN-carrying) tree is folded first (`models/yolov8.py`
`fold_batchnorm`, in NumPy).

Prints one JSON line with the round-trip parity check (the exported file is
read back through models/weights.from_onnx and compared to the source
params; max|diff| must be 0 — the export is a layout transpose, not a
requantization).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True, help="source .npz artifact")
    ap.add_argument("--variant", default=None,
                    help="override the variant introspected from the file")
    ap.add_argument("--classes", type=int, default=None)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--out", required=True, help="output .onnx path")
    ap.add_argument("--device", default="cuda",
                    help="torch device the twin is traced on (default cuda)")
    args = ap.parse_args(argv)

    from .utils.device import require_device
    require_device(args.device, "export_onnx")

    from .models.ultra import export_deployment_onnx
    from .models.weights import (flatten, from_onnx, infer_spec_from_params,
                                 load_params)
    from .models.yolov8 import fold_batchnorm, get_spec

    params = load_params(args.weights)
    introspected = infer_spec_from_params(params)  # the file's own geometry
    if args.variant:
        spec = get_spec(args.variant,
                        args.classes if args.classes is not None
                        else introspected.num_classes)
    else:
        spec = introspected
        if args.classes is not None and args.classes != spec.num_classes:
            raise SystemExit(
                f"--classes {args.classes} contradicts the file's "
                f"introspected {spec.num_classes} classes (pass --variant "
                "too if you mean to force a different spec)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    export_deployment_onnx(params, spec, args.out, args.size,
                           device=args.device)

    # Round-trip gate: the export must read back bit-identical (vs the
    # folded form — the exporter folds BN exactly as the serving path does).
    if any("/bn/" in k for k in flatten(params)):
        params = fold_batchnorm(params)
    back = flatten(from_onnx(args.out))
    src = flatten(params)
    if set(back) != set(src):
        raise SystemExit(f"round-trip key mismatch: "
                         f"{sorted(set(src) ^ set(back))[:5]}")
    max_diff = max(float(np.abs(back[k].astype(np.float32) -
                                src[k].astype(np.float32)).max())
                   for k in src)
    print(json.dumps({
        "out": args.out, "variant": spec.variant, "size": args.size,
        "bytes": os.path.getsize(args.out),
        "roundtrip_max_diff": max_diff,
    }))
    return 0 if max_diff == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
