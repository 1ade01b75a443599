"""Time the train step on the card (or the CPU when asked): ms a step,
steps/s and images/s for a ladder of batch sizes.

The port's copy of the JAX package's `scripts/train_step_bench.py`, with
its arguments and its one JSON line (the same keys), except that
`--device` (default `cuda`) takes the place of `--platform`: without a
CUDA device and without `--device cpu` it exits with an error. The
optimizer is the train loop's chain (`train/optim.py`: the global-norm clip,
then adamw); the JAX script times adamw alone. `--mesh-data` /
`--mesh-model` train on a (data, model) mesh of the CUDA devices
(`train/step.py`; with fewer devices than the mesh it warns and times one
device, and the line's `mesh` is null).

Timing is the pipeline method (`utils/bench_util.py`): train steps chain
their state, so N steps dispatched back to back are the natural pipeline,
and the one readback is the last step's loss.

    python -m zero_latency_yolo_tpu_torch.train_step_bench      # yolov8n@416
    python -m zero_latency_yolo_tpu_torch.train_step_bench --device cpu \
        --variant yolov8p --size 64 --batches 2 --pipeline 3,9
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="yolov8n")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--batches", default="8,16,32")
    ap.add_argument("--assigner", default="center", choices=("tal", "center"))
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--distill-from", default=None,
                    help="also time the distilled step against this teacher")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--pipeline", default="10,50",
                    help="two pipeline lengths for the difference (n1,n2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the step on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from .utils.device import require_device
    require_device(args.device, "train_step_bench")

    import torch

    from .models.weights import (infer_spec_from_params, load_params,
                                 train_params_from_jax)
    from .models.yolov8 import get_spec, init_params
    from .train.loop import synthetic_batches
    from .train.optim import make_optimizer
    from .train.step import init_train_state, make_train_step
    from .utils.bench_util import pipeline_step_seconds

    n1, n2 = (int(x) for x in args.pipeline.split(","))
    spec = get_spec(args.variant, args.classes)
    tx = make_optimizer(1e-3)

    t_tree = t_spec = None
    if args.distill_from:
        t_tree = load_params(args.distill_from)
        t_spec = infer_spec_from_params(t_tree)
        if (t_spec.num_classes, t_spec.reg_max) != (spec.num_classes,
                                                    spec.reg_max):
            raise SystemExit(
                f"--distill-from {args.distill_from} has "
                f"nc={t_spec.num_classes}, reg_max={t_spec.reg_max}; "
                f"student needs nc={spec.num_classes}, reg_max={spec.reg_max}")

    step_fn = make_train_step(spec, tx, (args.size, args.size),
                              ema_decay=0.9998 if args.ema else 0.0,
                              assigner=args.assigner, teacher_spec=t_spec,
                              mesh_data=args.mesh_data,
                              mesh_model=args.mesh_model, device=args.device)
    mesh = step_fn.mesh
    dev = torch.device(args.device) if mesh is None else mesh.devices[0][0]
    t_params = None
    if t_tree is not None:
        t_params = (train_params_from_jax(t_tree, device=dev) if mesh is None
                    else step_fn.shard_teacher(t_tree))

    rows = []
    for batch in (int(b) for b in args.batches.split(",")):
        images_np, targets_np = next(synthetic_batches(batch, args.size))
        images = torch.from_numpy(images_np).to(dev)
        targets = torch.from_numpy(targets_np).to(dev)
        # A fresh state a batch size (the step updates its state in place).
        state_box = [step_fn.shard_state(init_train_state(
            train_params_from_jax(init_params(0, spec, folded=False),
                                  device=dev), tx, ema=args.ema))]

        def run_once():
            extra = () if t_params is None else (t_params,)
            state_box[0], metrics = step_fn(state_box[0], images, targets,
                                            *extra)
            return metrics["loss"]

        step_s, rtt_s = pipeline_step_seconds(run_once, n1=n1, n2=n2,
                                              repeats=2)
        rows.append({"batch": batch,
                     "step_ms": round(step_s * 1e3, 3),
                     "steps_per_s": round(1.0 / step_s, 2),
                     "img_per_s": round(batch / step_s, 1),
                     "rtt_ms": round(rtt_s * 1e3, 1),
                     "final_loss": round(float(run_once()), 4)})

    print(json.dumps({
        "metric": "train_step", "variant": args.variant, "size": args.size,
        "assigner": args.assigner, "ema": bool(args.ema),
        "distill_from": args.distill_from,
        "mesh": (f"{args.mesh_data}x{args.mesh_model}" if mesh is not None
                 else None),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "rows": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
