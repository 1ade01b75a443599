"""Width against accuracy for the parametric variants, on synthetic data.

The port's copy of the JAX package's `scripts/width_accuracy.py`: each
candidate width (`yolov8-d0.33-w<width>-mc<mc>`) trained on the synthetic
task with identical data, optimizer and seed, each scored by AP@0.5 on a
held-out seed (991). Directional evidence only: no real dataset ships with
the repo.

    python -m zero_latency_yolo_tpu_torch.width_accuracy --steps 1200

Prints one JSON line per width. `--device` (default `cuda`) takes the place
of `--platform` (default `cpu` there): training runs on the card unless the
caller asks for the CPU, and without a CUDA device and without `--device
cpu` it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="0.25,0.125")
    ap.add_argument("--task", default="crowded", choices=("blob", "crowded"))
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-images", type=int, default=64)
    ap.add_argument("--mc", type=int, default=256,
                    help="max_channels; 256 keeps 64px training tractable "
                         "while preserving the relative width cut")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu trains on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from .utils.device import require_device
    require_device(args.device, "width_accuracy")

    from .models.weights import train_params_to_numpy
    from .models.yolov8 import fold_batchnorm, get_spec
    from .train.eval import evaluate
    from .train.loop import crowded_batches, synthetic_batches, train

    gen = crowded_batches if args.task == "crowded" else synthetic_batches
    # Held-out eval set: a seed the training stream never uses.
    eval_images, eval_targets = next(gen(args.eval_images, args.size,
                                         seed=991))
    for width in (float(w) for w in args.widths.split(",")):
        variant = f"yolov8-d0.33-w{width}-mc{args.mc}"
        spec = get_spec(variant, 4)
        t0 = time.perf_counter()
        state = train(variant=variant, num_classes=4, size=args.size,
                      batch=args.batch, steps=args.steps, lr=args.lr,
                      crowded=(args.task == "crowded"),
                      log_every=max(args.steps // 10, 1), device=args.device)
        params = fold_batchnorm(train_params_to_numpy(state.params))
        metrics = evaluate(params, spec, eval_images, eval_targets,
                           batch=args.batch, device=args.device)
        print(json.dumps({"task": args.task, "width": width,
                          "head_channels": list(spec.backbone_channels),
                          "steps": args.steps,
                          "mAP": round(metrics["mAP"], 4),
                          "recall": round(metrics["recall"], 4),
                          "train_s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
