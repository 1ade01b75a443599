"""Evaluate a weight artifact: AP@0.5, AP@0.5:0.95 and recall on a dataset
or a held-out synthetic seed.

The port's copy of the JAX package's `scripts/eval_artifact.py`, with its
arguments, argument checks and one JSON line, except that `--device`
(default `cuda`) takes the place of `--platform` (default `cpu` there):
without a CUDA device and without `--device cpu` it exits with an error.
The eval is `train/eval.py` `evaluate` in f32: on the card the serving
forward and NMS launch the port's kernels, on the CPU their plain versions.

    python -m zero_latency_yolo_tpu_torch.eval_artifact \
        --weights artifacts/yolov8n_trained_416.npz
    python -m zero_latency_yolo_tpu_torch.eval_artifact --weights my.onnx \
        --data datasets/val --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True, help=".npz/.pt/.onnx artifact")
    ap.add_argument("--data", default=None,
                    help="YOLO-convention eval directory; default is the "
                         "held-out synthetic seed (777, the committed "
                         "artifact gates)")
    ap.add_argument("--size", type=int, default=416)
    # 64 is the measured floor for comparable numbers: 8-image evals invert
    # the shipped-artifact ranking (the JAX package's artifact table).
    ap.add_argument("--images", type=int, default=64,
                    help="synthetic eval-set size / dataset limit (0 = all)")
    ap.add_argument("--task", default="blob",
                    choices=("blob", "crowded", "ood1", "ood2", "ood3"),
                    help="synthetic eval domain when --data is not given: "
                         "blob = the training task's distribution, crowded "
                         "= dense occlusion task, ood1-3 = the held-out "
                         "out-of-distribution domain (train/ood.py) at "
                         "increasing severity")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--topk", type=int, default=0,
                    help="pre-NMS top-k (0 = library default 256)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain version)")
    args = ap.parse_args(argv)

    if args.images < 0:
        # A negative limit with --data would slice away the last N pairs.
        raise SystemExit("--images must be >= 0")
    if args.images <= 0 and not args.data:
        # "0 = all" is a --data semantics; a synthetic task of 0 images
        # would give an empty eval set with degenerate metrics.
        raise SystemExit("--images 0 ('all') requires --data; synthetic "
                         "tasks need an explicit count (>= 64 for "
                         "comparable numbers)")

    from .utils.device import require_device
    require_device(args.device, "eval_artifact")

    from .models.weights import infer_spec_from_params, load_artifact
    from .train.eval import evaluate
    from .train.loop import crowded_batches, synthetic_batches

    try:
        params = load_artifact(args.weights)
    except ValueError as e:
        raise SystemExit(str(e))
    spec = infer_spec_from_params(params)

    if args.data:
        from .train.data import load_yolo_dir
        raw, targets = load_yolo_dir(args.data, args.size,
                                     num_classes=spec.num_classes,
                                     limit=args.images or None)
        images = raw.astype(np.float32) / 255
    elif args.task.startswith("ood"):
        from .train.ood import ood_batches
        images, targets = next(ood_batches(args.images, args.size, seed=777,
                                           level=int(args.task[3])))
    elif args.task == "crowded":
        images, targets = next(crowded_batches(args.images, args.size,
                                               seed=777))
    else:
        images, targets = next(synthetic_batches(args.images, args.size,
                                                 seed=777))

    t0 = time.perf_counter()
    metrics = evaluate(params, spec, images, targets, conf_thresh=args.conf,
                       nms_thresh=args.nms, iou_thresh=args.iou,
                       batch=args.batch, topk=args.topk or None,
                       device=args.device)
    print(json.dumps({
        "weights": args.weights, "variant": spec.variant,
        "num_classes": spec.num_classes, "size": args.size,
        "images": int(len(images)),
        "data": args.data or f"{args.task}-777",
        "mAP": round(metrics["mAP"], 4),
        "mAP50_95": round(metrics["mAP50_95"], 4),
        "recall": round(metrics["recall"], 4),
        "eval_s": round(time.perf_counter() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
