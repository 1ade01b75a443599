"""The serving step's duration per batch bucket on one device: the card's
own step ladder.

    python -m zero_latency_yolo_tpu_torch.step_ladder [--device cuda]
        [--out PATH]
    ZLT_BENCH_SMOKE=1 python -m zero_latency_yolo_tpu_torch.step_ladder \\
        --device cpu                                   # CPU mechanics

Times the exact cached serving step the batcher dispatches
(`InferenceEngine.get_step_cached` with the packed slots/heights/widths
tensor; `utils/bench_util.py` `measure_cached_step`, the pipeline method)
at each batch bucket, yolov8n at 416 in bf16 over 600x800 frames in a
608x800 bucket unless the environment says otherwise:

  ZLT_LADDER_VARIANT  the model (default yolov8n; yolov8p in smoke mode)
  ZLT_LADDER_SIZE     the model size (default 416; 64 in smoke mode)
  ZLT_LADDER          the batches (default 2,4,8,16,32,64; 1,2 in smoke)
  ZLT_LADDER_TOPK     the pre-NMS top-K (default 256)
  ZLT_BENCH_SMOKE=1   yolov8p at 64 on 64x96 frames in a 96x96 bucket

Prints one JSON line, the JAX package's `scripts/step_ladder.py`'s keys:
  {"ladder": {"2": ms, ...}, "variant": ..., "size": ..., "device": ...
   [, "pre_nms_topk": K]}
where `device` is the card's name and power limit as nvidia-smi gives them
(or "cpu"), and writes the same object to `--out`. This file is the card's
own ladder: `lane_physics` and `wire_ceiling` replay it (the synthetic
step), and nothing else. A batch that fails is printed FAILED; the ladder
keeps the rest and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.device import require_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain PyTorch version)")
    ap.add_argument("--out", default="",
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    require_device(args.device, "step_ladder")

    from .runtime.engine import InferenceEngine
    from .utils.bench_util import (Sweep, device_label, measure_cached_step,
                                   pipeline_kw, seeded_params,
                                   serving_config, smoke)

    sm = smoke()
    variant = os.environ.get("ZLT_LADDER_VARIANT",
                             "yolov8p" if sm else "yolov8n")
    size = 64 if sm else int(os.environ.get("ZLT_LADDER_SIZE", "416"))
    bh, bw = (96, 96) if sm else (608, 800)
    h, w = (64, 96) if sm else (600, 800)
    batches = (1, 2) if sm else tuple(
        int(b) for b in os.environ.get("ZLT_LADDER",
                                       "2,4,8,16,32,64").split(","))
    topk = int(os.environ.get("ZLT_LADDER_TOPK", "256"))

    cfg = serving_config(variant, size, batches, (bh, bw), topk=topk)
    engine = InferenceEngine(cfg, params=seeded_params(variant),
                             device=args.device)
    rng = np.random.default_rng(0)
    sweep = Sweep()
    ladder = {}

    def one(batch):
        frames = rng.integers(0, 256, (batch, bh, bw, 3), dtype=np.uint8)
        step_s, _ = measure_cached_step(engine, batch, (bh, bw), h, w,
                                        frames=frames, **pipeline_kw())
        step_ms = step_s * 1e3
        ladder[str(batch)] = round(step_ms, 3)
        print(f"# batch={batch}: step={step_ms:.3f} ms "
              f"({batch / step_ms * 1e3:.0f} fps)", file=sys.stderr,
              flush=True)

    for batch in batches:
        sweep.row(f"batch={batch}", lambda b=batch: one(b))
    out = {"ladder": ladder, "variant": variant, "size": size,
           "device": device_label(engine.device)}
    if topk != 256:
        out["pre_nms_topk"] = topk
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
