"""Convert a COCO-format dataset to the YOLO directory layout the trainer
consumes (`train/data.py`; the ultralytics convention):

    python -m zero_latency_yolo_tpu_torch.coco_to_yolo \
        --ann instances_train.json --images /data/coco/train2017 \
        --out datasets/train

Then fine-tune on it:

    python -m zero_latency_yolo_tpu_torch.train.loop --data datasets/train \
        --variant yolov8n --size 416 --classes <C>

The port's copy of the JAX package's `scripts/coco_to_yolo.py`, with its
arguments and output: images are symlinked (not copied), labels are
normalized center-format, COCO category ids remap to contiguous [0, C)
ascending (written to out/classes.txt), iscrowd annotations are skipped by
default. It computes nothing on a device; it takes `--device` (default
`cuda`) as every tool of the port does, and without a CUDA device and
without `--device cpu` it exits with an error.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann", required=True, help="COCO annotation .json")
    ap.add_argument("--images", required=True, help="directory of images the "
                    "annotation file_names refer to")
    ap.add_argument("--out", required=True, help="output dataset root "
                    "(images/ + labels/ created inside)")
    ap.add_argument("--keep-crowd", action="store_true",
                    help="keep iscrowd=1 annotations (skipped by default)")
    ap.add_argument("--device", default="cuda",
                    help="the tools' device rule (nothing runs on it)")
    args = ap.parse_args(argv)

    from .utils.device import require_device
    require_device(args.device, "coco_to_yolo")

    from .train.data import coco_to_yolo
    n, cat_map = coco_to_yolo(args.ann, args.images, args.out,
                              skip_crowd=not args.keep_crowd)
    print(f"wrote {n} images, {len(cat_map)} classes -> {args.out} "
          f"(train with --classes {len(cat_map)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
