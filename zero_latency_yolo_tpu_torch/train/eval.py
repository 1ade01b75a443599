"""Detection evaluation: AP at IoU thresholds for trained parameters.

The port's counterpart of the JAX package's `train/eval.py`: the serving
path (forward + decode + class-weighted NMS) over an eval set, then AP per
class with greedy IoU matching (VOC-style, all-point interpolation) at the
primary threshold and over the COCO ladder 0.50:0.95.

The forward is the port's serving forward: the tree is folded
(`models/weights.py` `params_from_jax`) and placed (`place_params`), then
`forward_decoded` and `ops/nms.py` `postprocess_batch` run. On the card eval
therefore runs the three hand-written kernels (1x1 GEMM, bias+SiLU, NMS); on
the CPU, and with plain=True, their plain versions. The JAX package
evaluates an unfolded tree with a BN tail instead: folding first is a
difference by design, held to the JAX evaluation in f32 by the tests.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.weights import params_from_jax, place_params, train_params_to_numpy
from ..models.yolov8 import ModelSpec, forward_decoded
from ..ops import nms as nms_ops
from ..runtime.engine import full_f32_precision
from ..utils.geometry import iou_matrix_cxcywh


def average_precision(scored: List[Tuple[float, bool]], n_gt: int) -> float:
    """All-point-interpolated AP from (score, is_true_positive) pairs."""
    if n_gt == 0:
        return 0.0
    scored = sorted(scored, key=lambda s: -s[0])
    tp = np.cumsum([1.0 if hit else 0.0 for _, hit in scored])
    fp = np.cumsum([0.0 if hit else 1.0 for _, hit in scored])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def _greedy_match(order: np.ndarray, iou: Optional[np.ndarray],
                  scores: np.ndarray, iou_thresh: float
                  ) -> List[Tuple[float, bool]]:
    """Greedy score-ordered matching over a precomputed IoU matrix (the
    matrix and order do not depend on the threshold, so the COCO ladder
    re-runs only this loop per rung)."""
    n_gt = 0 if iou is None else iou.shape[1]
    taken = np.zeros(n_gt, bool)
    out: List[Tuple[float, bool]] = []
    for i in order:
        hit = False
        if n_gt:
            j = int(np.argmax(np.where(taken, -1.0, iou[i])))
            if not taken[j] and iou[i, j] >= iou_thresh:
                taken[j] = True
                hit = True
        out.append((float(scores[i]), hit))
    return out


def match_detections(pred_boxes: np.ndarray, pred_scores: np.ndarray,
                     gt_boxes: np.ndarray, iou_thresh: float = 0.5
                     ) -> List[Tuple[float, bool]]:
    """Greedy score-ordered matching of one image's single-class detections."""
    order = np.argsort(-pred_scores)
    iou = (iou_matrix_cxcywh(pred_boxes, gt_boxes)
           if len(gt_boxes) else None)
    return _greedy_match(order, iou, pred_scores, iou_thresh)


COCO_IOU_LADDER = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))


def evaluate(params, spec: ModelSpec, images: np.ndarray, targets: np.ndarray,
             conf_thresh: float = 0.25, nms_thresh: float = 0.45,
             iou_thresh: float = 0.5, batch: int = 8,
             class_weights: Optional[np.ndarray] = None,
             dtype=torch.float32, topk: Optional[int] = None,
             device="cuda", plain: bool = False) -> Dict[str, float]:
    """AP over an eval set: the primary threshold plus the COCO IoU ladder.

    params:  a tree in NumPy or the training form (folded here)
    images:  (N, S, S, 3) float in [0,1] (already letterboxed/square)
    targets: (N, M, 5) [class, cx, cy, w, h] normalized, class=-1 padding
    Returns {"mAP": AP@iou_thresh, "mAP50_95": the mean over IoU
    0.50:0.95:0.05, "AP/<cls>": per class @iou_thresh, "recall", "num_gt"}.
    The forward runs once; the ladder re-runs only the host-side matcher.
    An f32 eval runs in full f32 (`full_f32_precision`), not TF32.
    """
    n, s = images.shape[0], images.shape[1]
    nc = spec.num_classes
    placed = place_params(params_from_jax(train_params_to_numpy(params)),
                          device, dtype)
    cw = torch.tensor(class_weights if class_weights is not None
                      else np.ones(nc), dtype=torch.float32, device=device)
    scale = torch.ones((batch,), dtype=torch.float32, device=device)
    pad = torch.zeros((batch, 2), dtype=torch.float32, device=device)
    wh = torch.full((batch, 2), float(s), dtype=torch.float32, device=device)
    kw = {} if topk is None else {"topk": int(topk)}
    precision = (full_f32_precision if dtype == torch.float32
                 else contextlib.nullcontext)

    ladder = tuple(sorted({float(iou_thresh), *COCO_IOU_LADDER}))
    per_class: Dict[float, Dict[int, List[Tuple[float, bool]]]] = {
        t: {c: [] for c in range(nc)} for t in ladder}
    gt_count = {c: 0 for c in range(nc)}
    matched_total = 0
    for i0 in range(0, n, batch):
        chunk = images[i0:i0 + batch]
        pad_n = batch - len(chunk)
        if pad_n:
            chunk = np.concatenate([chunk, np.zeros((pad_n,) + chunk.shape[1:],
                                                    chunk.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device)
        with torch.inference_mode(), precision():
            pred = forward_decoded(placed, spec, x, dtype=dtype, plain=plain)
            out = nms_ops.postprocess_batch(pred, cw, conf_thresh, nms_thresh,
                                            scale, pad, wh, plain=plain, **kw)
        boxes = out["boxes"].cpu().numpy()
        scores = out["scores"].cpu().numpy()
        classes = out["classes"].cpu().numpy()
        counts = out["count"].cpu().numpy()
        for bi in range(len(images[i0:i0 + batch])):
            t = targets[i0 + bi]
            valid = t[:, 0] >= 0
            for c in range(nc):
                gt_c = t[valid & (t[:, 0] == c)][:, 1:]
                gt_count[c] += len(gt_c)
                k = int(counts[bi])
                sel = classes[bi, :k] == c
                pb, ps = boxes[bi, :k][sel], scores[bi, :k][sel]
                order = np.argsort(-ps)
                iou = (iou_matrix_cxcywh(pb, gt_c)
                       if len(gt_c) else None)
                for thr in ladder:
                    res = _greedy_match(order, iou, ps, thr)
                    if thr == iou_thresh:
                        matched_total += sum(1 for _, hit in res if hit)
                    per_class[thr][c].extend(res)

    def _map_at(thr: float) -> Dict[int, float]:
        return {c: average_precision(per_class[thr][c], gt_count[c])
                for c in range(nc) if gt_count[c] > 0}

    aps = _map_at(iou_thresh)
    coco = ([float(np.mean(list(_map_at(t).values())))
             for t in COCO_IOU_LADDER] if any(gt_count.values()) else [])
    total_gt = sum(gt_count.values())
    return {
        "mAP": float(np.mean(list(aps.values()))) if aps else 0.0,
        "mAP50_95": float(np.mean(coco)) if coco else 0.0,
        **{f"AP/{c}": ap for c, ap in aps.items()},
        "recall": matched_total / total_gt if total_gt else 0.0,
        "num_gt": total_gt,
    }
