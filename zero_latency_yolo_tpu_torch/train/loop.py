"""Fine-tuning entry point: data pipeline + train loop + checkpoint/resume.

The port's counterpart of the JAX package's `train/loop.py`, with the same
arguments and flags, on the CUDA devices (or the CPU when asked):

    python -m zero_latency_yolo_tpu_torch.train.loop --steps 200 \
        --variant yolov8p --size 64 --batch 8 --ckpt-dir checkpoints/

`--device` (default cuda) takes the place of the JAX loop's `--platform`.
`--mesh-data` / `--mesh-model` train on a (data, model) mesh of the CUDA
devices (`train/step.py`); with fewer devices than the mesh the loop warns
and trains on one device.
Data via --data: a YOLO-convention directory (images/ + labels/*.txt, see
train/data.py), .npz shards (`images` (N,H,W,3) uint8, `targets` (N,M,5)
[class,cx,cy,w,h] normalized, class=-1 padding), or the built-in synthetic
generators. The NumPy batch generators below are copies of the JAX
package's: for a seed they give the same batches.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def synthetic_batches(batch: int, size: int, max_boxes: int = 4,
                      seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless synthetic detection data: gray background, colored rectangles
    whose class is determined by aspect/brightness — learnable signal."""
    rng = np.random.default_rng(seed)
    while True:
        images = np.full((batch, size, size, 3), 0.35, np.float32)
        targets = np.full((batch, max_boxes, 5), -1.0, np.float32)
        for b in range(batch):
            for m in range(rng.integers(1, max_boxes + 1)):
                w = rng.uniform(0.15, 0.5)
                h = rng.uniform(0.15, 0.5)
                cx = rng.uniform(w / 2, 1 - w / 2)
                cy = rng.uniform(h / 2, 1 - h / 2)
                cls = rng.integers(0, 4)
                color = np.zeros(3, np.float32)
                color[cls % 3] = 0.9 if cls < 3 else 0.6
                x0 = int((cx - w / 2) * size)
                x1 = int((cx + w / 2) * size)
                y0 = int((cy - h / 2) * size)
                y1 = int((cy + h / 2) * size)
                images[b, y0:y1, x0:x1] = color
                targets[b, m] = (cls, cx, cy, w, h)
        yield images, targets


def crowded_batches(batch: int, size: int, max_boxes: int = 12,
                    seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Dense synthetic scenes: 4-12 small/medium rectangles painted
    back-to-front with overlap, per-instance color jitter, and
    occlusion-aware labels (boxes left <30% visible are dropped — a fully
    painted-over box is label noise). This is the regime dense assignment
    strategies target: ambiguous anchor ownership, partial occlusion,
    crowded centers — the scenario the blob task (synthetic_batches) lacks,
    which is where the center-vs-TAL assigner comparison belongs."""
    rng = np.random.default_rng(seed)
    while True:
        images = np.full((batch, size, size, 3), 0.35, np.float32)
        targets = np.full((batch, max_boxes, 5), -1.0, np.float32)
        for b in range(batch):
            n = int(rng.integers(4, max_boxes + 1))
            owner = np.full((size, size), -1, np.int32)
            boxes = []
            for m in range(n):
                w = rng.uniform(0.08, 0.35)
                h = rng.uniform(0.08, 0.35)
                cx = rng.uniform(w / 2, 1 - w / 2)
                cy = rng.uniform(h / 2, 1 - h / 2)
                cls = int(rng.integers(0, 4))
                color = np.zeros(3, np.float32)
                color[cls % 3] = 0.9 if cls < 3 else 0.6
                color = np.clip(color + rng.uniform(-0.08, 0.08, 3), 0, 1)
                x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
                y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
                images[b, y0:y1, x0:x1] = color
                owner[y0:y1, x0:x1] = m
                boxes.append((cls, cx, cy, w, h,
                              max((y1 - y0) * (x1 - x0), 1)))
            kept = 0
            for m, (cls, cx, cy, w, h, area) in enumerate(boxes):
                if float((owner == m).sum()) / area >= 0.3:
                    targets[b, kept] = (cls, cx, cy, w, h)
                    kept += 1
        yield images, targets


def mosaic_batches(src: Iterator[Tuple[np.ndarray, np.ndarray]],
                   prob: float = 1.0, hflip: float = 0.5,
                   seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Mosaic + horizontal-flip augmentation (the YOLOv8 recipe's core).

    Each output image stitches 4 source images onto a 2S x 2S canvas
    (one per quadrant, native scale) and takes a random S x S crop; boxes
    are remapped into crop coordinates, clipped to the window, and dropped
    when a clipped side falls under 1% of the image. Output target capacity
    doubles (4 images crop to roughly 2x the boxes on average) and stays
    shape-static across batches, so the train step never recompiles.
    """
    rng = np.random.default_rng(seed)
    pool_imgs: list = []
    pool_tgts: list = []
    for images, targets in src:
        pool_imgs.extend(images)
        pool_tgts.extend(targets)
        b = len(images)
        if len(pool_imgs) < 4 * b:
            continue
        size = images.shape[1]
        m_out = 2 * targets.shape[1]
        out_i = np.empty_like(images)
        out_t = np.full((b, m_out, 5), -1.0, targets.dtype)
        for i in range(b):
            if rng.random() >= prob:
                j = rng.integers(len(pool_imgs))
                out_i[i] = pool_imgs[j]
                t = pool_tgts[j]
                out_t[i, :len(t)] = t
            else:
                canvas = np.zeros((2 * size, 2 * size, 3), images.dtype)
                boxes = []
                for q, (qy, qx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                    j = rng.integers(len(pool_imgs))
                    canvas[qy * size:(qy + 1) * size,
                           qx * size:(qx + 1) * size] = pool_imgs[j]
                    for cls, cx, cy, w, h in pool_tgts[j]:
                        if cls < 0:
                            continue
                        boxes.append((cls, cx + qx, cy + qy, w, h))
                # Quantize the crop origin to whole pixels FIRST, keep the
                # INTEGER for indexing, and derive the box-remap offset from
                # it — a continuous offset paired with a truncated pixel
                # crop displaced every box by up to 1/size systematically
                # (and re-deriving the int from m/size truncates to m-1 for
                # some sizes, re-introducing the same off-by-one).
                ky = int(rng.uniform(0, 1) * size)
                kx = int(rng.uniform(0, 1) * size)
                oy = ky / size
                ox = kx / size
                out_i[i] = canvas[ky:ky + size, kx:kx + size]
                kept = 0
                for cls, cx, cy, w, h in boxes:
                    if kept >= m_out:
                        break
                    # Crop window in canvas units: [ox, ox+1] x [oy, oy+1].
                    x0 = max(cx - w / 2, ox)
                    x1 = min(cx + w / 2, ox + 1)
                    y0 = max(cy - h / 2, oy)
                    y1 = min(cy + h / 2, oy + 1)
                    if x1 - x0 < 0.01 or y1 - y0 < 0.01:
                        continue
                    out_t[i, kept] = (cls, (x0 + x1) / 2 - ox,
                                      (y0 + y1) / 2 - oy, x1 - x0, y1 - y0)
                    kept += 1
            if rng.random() < hflip:
                out_i[i] = out_i[i, :, ::-1]
                valid = out_t[i, :, 0] >= 0
                out_t[i, valid, 1] = 1.0 - out_t[i, valid, 1]
        # Keep the pool a bounded sliding window of recent source images.
        pool_imgs = pool_imgs[-8 * b:]
        pool_tgts = pool_tgts[-8 * b:]
        yield out_i, out_t


def photometric_batches(src: Iterator[Tuple[np.ndarray, np.ndarray]],
                        strength: float = 1.0, seed: int = 0
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Photometric augmentation (the ultralytics recipe's hsv_h/s/v analog,
    label-free): per-image gamma, brightness, per-channel gain, and additive
    Gaussian noise, each scaled by `strength` (1.0 ≈ the OOD eval domain's
    level-1 photometric envelope — train/ood.py keeps its held-out seeds, so
    training with this does not touch the eval distribution's scenes).

    It is the training-side lever aimed at the gap between the
    in-distribution and the OOD score (docs/BENCH_NOTES.md, OOD section)."""
    rng = np.random.default_rng(seed)
    s = float(strength)
    for images, targets in src:
        out = images.copy()
        for i in range(len(out)):
            img = out[i]
            img = np.clip(img, 0.0, 1.0) ** rng.uniform(1 - 0.2 * s,
                                                        1 + 0.25 * s)
            img *= rng.uniform(1 - 0.15 * s, 1 + 0.1 * s)
            img *= (1.0 + rng.uniform(-0.08 * s, 0.08 * s, 3)).astype(
                np.float32)
            img += rng.normal(0.0, 0.02 * s, img.shape).astype(np.float32)
            out[i] = np.clip(img, 0.0, 1.0)
        yield out, targets


def clutter_batches(src: Iterator[Tuple[np.ndarray, np.ndarray]],
                    strength: float = 1.0, seed: int = 11
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Distractor-clutter augmentation (label-free): paints object-like
    SHAPES with deliberately ambiguous color codes — the shared
    train/ood.py painter, so the training clutter matches the eval axis it
    targets by construction. This is the training-side lever for the OOD
    clutter axis the photometric recipe measurably could not close
    (docs/BENCH_NOTES.md, robust-recipe and clutter sections).

    Label safety is the painter's `avoid_boxes` contract: rectangles
    covering >20% of a labeled box are rejected and stripes skip labeled
    pixels entirely (a full-width stripe could otherwise bury a small
    mosaic-cropped box the targets still assert exists). The default seed
    (11) is distinct from the OOD eval domain's held-out seed (777) and
    draws a different sequence; eval scenes are never reproduced here."""
    from .ood import paint_distractors

    rng = np.random.default_rng(seed)
    s = float(strength)
    for images, targets in src:
        out = images.copy()
        for i in range(len(out)):
            valid = targets[i][targets[i][:, 0] >= 0]
            boxes = valid[:, 1:5] if len(valid) else None
            paint_distractors(rng, out[i],
                              int(rng.integers(1, max(int(4 * s), 2) + 1)),
                              int(rng.integers(0, 3)),
                              avoid_boxes=boxes)
        yield np.clip(out, 0.0, 1.0), targets


def npz_batches(pattern: str, batch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no data shards match {pattern}")
    yielded = False
    while True:
        for path in files:
            with np.load(path) as z:
                images = z["images"].astype(np.float32)
                if images.max() > 1.5:
                    images = images / 255.0
                targets = z["targets"].astype(np.float32)
            for i in range(0, len(images) - batch + 1, batch):
                yielded = True
                yield images[i:i + batch], targets[i:i + batch]
        if not yielded:
            raise ValueError(
                f"every shard matching {pattern} has fewer than batch="
                f"{batch} samples; nothing to train on")


def train(variant: str = "yolov8p", num_classes: int = 4, size: int = 64,
          batch: int = 8, steps: int = 100, lr: float = 1e-3,
          data: Optional[str] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, mesh_data: int = 1, mesh_model: int = 1,
          remat: bool = False, init_from: Optional[str] = None,
          ema: bool = False, ema_decay: float = 0.9998,
          mosaic: float = 0.0, photometric: float = 0.0,
          clutter: float = 0.0, assigner: str = "center",
          crowded: bool = False, max_boxes: int = 32,
          multiscale: Optional[Sequence[int]] = None,
          schedule: str = "const", warmup_steps: int = 0,
          distill_from: Optional[str] = None, distill_weight: float = 1.0,
          distill_box_weight: float = 1.0, distill_temp: float = 2.0,
          log_every: int = 10, device: str = "cuda"):
    """Train and return the state. The arguments are the JAX package's
    `train(...)`; `device` is where the step runs (cuda unless the caller
    asks for the CPU). The step computes in bf16, as the JAX loop's. On a
    mesh the state returned is the trained one joined onto the mesh's first
    device (`parallel/mesh.py` `join_state`)."""
    import torch

    from ..models.weights import (infer_spec_from_params, load_params,
                                  train_params_from_jax)
    from ..models.yolov8 import get_spec, init_params
    from ..parallel.mesh import join_state
    from .checkpoint import CheckpointManager
    from .optim import make_optimizer
    from .step import init_train_state, make_train_step, train_mesh

    if schedule not in ("const", "cosine"):  # fail before params build/load
        raise ValueError(f"unknown lr schedule {schedule!r} "
                         "(expected 'const' or 'cosine')")
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to train on the CPU")
    spec = get_spec(variant, num_classes)
    tree = (load_params(init_from) if init_from
            else init_params(0, spec, folded=False))
    tx = make_optimizer(lr, schedule, steps, warmup_steps)
    state = init_train_state(train_params_from_jax(tree, device=device), tx,
                             ema=ema)

    t_params = t_spec = None
    if distill_from:
        t_tree = load_params(distill_from)
        t_spec = infer_spec_from_params(t_tree)
        if (t_spec.num_classes, t_spec.reg_max) != (spec.num_classes,
                                                    spec.reg_max):
            raise ValueError(
                f"teacher {distill_from} has nc={t_spec.num_classes}, "
                f"reg_max={t_spec.reg_max}; student needs "
                f"nc={spec.num_classes}, reg_max={spec.reg_max}")
        t_params = train_params_from_jax(t_tree, device=device)
        print(f"distilling from {t_spec.variant} ({distill_from}), "
              f"w_kd={distill_weight} w_box={distill_box_weight} "
              f"T={distill_temp}")

    mesh = train_mesh(mesh_data, mesh_model, device)
    sizes = tuple(int(s) for s in multiscale) if multiscale else (size,)
    for s in sizes:
        if s % 32:
            raise ValueError(f"train size {s} must be a multiple of 32 "
                             "(stride-32 FPN)")
    step_fns = {s: make_train_step(spec, tx, (s, s), mesh=mesh, remat=remat,
                                   ema_decay=ema_decay, assigner=assigner,
                                   teacher_spec=t_spec,
                                   distill_weight=distill_weight,
                                   distill_box_weight=distill_box_weight,
                                   distill_temp=distill_temp)
                for s in sizes}
    step_fn = step_fns[sizes[0]]
    if mesh is not None:
        print(f"train mesh {mesh.describe()}", flush=True)
    state = step_fn.shard_state(state)
    if t_params is not None:
        t_params = step_fn.shard_teacher(t_params)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore(state, tx)
        if restored is not None:
            state = restored
            print(f"resumed from step {state.step}")

    def _batches_for(s: int):
        if data and os.path.isdir(data):
            from .data import yolo_dir_batches
            src_it = yolo_dir_batches(data, batch, s, max_boxes=max_boxes,
                                      num_classes=num_classes,
                                      cache_mb=2048 // max(len(sizes), 1))
        elif data:
            if len(sizes) > 1:
                raise ValueError(".npz shards are fixed-shape; multiscale "
                                 "needs a directory dataset or the "
                                 "synthetic task")
            src_it = npz_batches(data, batch)
        elif crowded:
            src_it = crowded_batches(batch, s)
        else:
            src_it = synthetic_batches(batch, s)
        if mosaic > 0:
            src_it = mosaic_batches(src_it, prob=mosaic)
        if clutter > 0:
            src_it = clutter_batches(src_it, strength=clutter)
        if photometric > 0:
            src_it = photometric_batches(src_it, strength=photometric)
        return src_it

    per_size = {s: _batches_for(s) for s in sizes}
    t0 = time.perf_counter()
    start = state.step
    for i in range(max(steps - start, 0)):
        s = sizes[i % len(sizes)]
        images, targets = next(per_size[s])
        if t_params is not None:
            state, metrics = step_fns[s](state, images, targets, t_params)
        else:
            state, metrics = step_fns[s](state, images, targets)
        step_num = start + i + 1
        if step_num % log_every == 0 or step_num == steps:
            loss = float(metrics["loss"])
            rate = step_num - start and (step_num - start) / (
                time.perf_counter() - t0)
            kd = (f" kd {float(metrics['kd_cls']):.3f}/"
                  f"{float(metrics['kd_box']):.3f}" if "kd_cls" in metrics
                  else "")
            print(f"step {step_num:6d}  loss {loss:8.4f}  "
                  f"box {float(metrics['box']):.3f} "
                  f"cls {float(metrics['cls']):.3f} "
                  f"dfl {float(metrics['dfl']):.3f}{kd}  {rate:.2f} it/s",
                  flush=True)
        if mgr is not None and ckpt_every > 0 and step_num % ckpt_every == 0:
            mgr.save(state, tx)
    if mgr is not None:
        mgr.save(state, tx)
    return state if mesh is None else join_state(state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="zero-latency-yolo fine-tuning (PyTorch port)")
    ap.add_argument("--variant", default="yolov8p")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data", default=None,
                    help="YOLO-convention dataset directory (images/ + "
                         "labels/*.txt) or .npz shard glob")
    ap.add_argument("--max-boxes", type=int, default=32,
                    help="target capacity per image for directory datasets")
    ap.add_argument("--multiscale", default="",
                    help="comma list of train sizes to round-robin (e.g. "
                         "'416,320'); overrides --size")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ema", action="store_true",
                    help="track an EMA of the weights (serve the EMA)")
    ap.add_argument("--mosaic", type=float, default=0.0,
                    help="mosaic augmentation probability (0 disables)")
    ap.add_argument("--photometric", type=float, default=0.0,
                    help="photometric augmentation strength (0 disables)")
    ap.add_argument("--clutter", type=float, default=0.0,
                    help="distractor-clutter augmentation strength "
                         "(0 disables)")
    ap.add_argument("--assigner", default="center", choices=("tal", "center"))
    ap.add_argument("--schedule", default="const", choices=("const", "cosine"),
                    help="lr schedule: cosine = warmup-cosine decay to 5%% "
                         "of --lr over --steps")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear warmup steps (with --schedule cosine)")
    ap.add_argument("--crowded", action="store_true",
                    help="use the dense occlusion-aware synthetic task")
    ap.add_argument("--init-from", default=None, help="warm-start .npz")
    ap.add_argument("--distill-from", default=None,
                    help="teacher .npz for knowledge distillation; nc and "
                         "reg_max must match the student")
    ap.add_argument("--distill-weight", type=float, default=1.0)
    ap.add_argument("--distill-box-weight", type=float, default=1.0)
    ap.add_argument("--distill-temp", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the step runs")
    args = ap.parse_args(argv)
    train(variant=args.variant, num_classes=args.classes, size=args.size,
          batch=args.batch, steps=args.steps, lr=args.lr, data=args.data,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          mesh_data=args.mesh_data, mesh_model=args.mesh_model,
          remat=args.remat, init_from=args.init_from, ema=args.ema,
          mosaic=args.mosaic, photometric=args.photometric,
          clutter=args.clutter, assigner=args.assigner, crowded=args.crowded,
          max_boxes=args.max_boxes,
          multiscale=([int(s) for s in args.multiscale.split(",")]
                      if args.multiscale else None),
          schedule=args.schedule, warmup_steps=args.warmup,
          distill_from=args.distill_from, distill_weight=args.distill_weight,
          distill_box_weight=args.distill_box_weight,
          distill_temp=args.distill_temp, device=args.device)


if __name__ == "__main__":
    main()
