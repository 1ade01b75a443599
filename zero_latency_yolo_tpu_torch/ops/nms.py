"""Fused detection postprocess: class weighting, threshold, greedy NMS,
un-letterbox, packed output.

The PyTorch counterpart of the JAX package's `ops/nms.py`, with the same
semantics (reference src/inference/onnx_engine.cpp:758-878):

- per-anchor argmax class after `class_weights` multiply the scores,
  threshold at conf, top-K candidates by weighted score;
- greedy same-class suppression at IoU > nms_threshold on center-format
  boxes (`ops/nms_cuda.py` `nms_keep`: one CUDA kernel from boxes to the
  keep mask);
- compaction to MAX_DET, boxes un-letterboxed to source pixels and
  normalized, scores clipped to [0, 1];
- one packed (B, 1 + 6*MAX_DET) f32 array per batch, so one D2H copy.

`postprocess_batch_levels` is the same over the per-level decode
(tpu.select="perlevel"): candidates are ranked within each level first.

Candidate order decides greedy NMS. `lax.top_k` puts the lower index first
among equal scores; `torch.topk` promises no order, so the ranking here is a
stable descending sort, which keeps the lower index first too.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .nms_cuda import _iou_matrix_center, nms_keep, nms_keep_plain  # noqa: F401

MAX_DET = 32       # reference MAX_DETECTION_COUNT (src/common/constants.h:18)
PRE_NMS_TOPK = 256


def _rank_candidates(boxes: torch.Tensor, probs: torch.Tensor,
                     class_weights: torch.Tensor, conf_thresh: float, topk: int):
    """Weight, threshold and rank one batch of anchor sets: (B, A, 4) boxes
    and (B, A, nc) probs -> top-K boxes, scores (-1 = below threshold) and
    classes, score-descending with the lower anchor index first on ties."""
    w = probs * class_weights
    best_score, best_class = torch.max(w, dim=-1)
    ranked = torch.where(best_score >= float(np.float32(conf_thresh)),
                         best_score, torch.full_like(best_score, -1.0))
    top_scores, order = torch.sort(ranked, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :topk], order[:, :topk]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_class = torch.gather(best_class, 1, top_idx).to(torch.int32)
    return top_boxes, top_scores, top_class


def _select_one(pred: torch.Tensor, class_weights: torch.Tensor,
                conf_thresh: float, topk: int):
    """Stage 1: weight, threshold, top-K candidate selection over (B, A, 4+nc)."""
    top_boxes, top_scores, top_class = _rank_candidates(
        pred[..., :4], pred[..., 4:], class_weights, conf_thresh, topk)
    return top_boxes, top_scores, top_class, top_scores > 0


def _compact_one(top_boxes, top_scores, top_class, keep, scale, pad, src_wh
                 ) -> Dict[str, torch.Tensor]:
    """Stage 3 (batched): survivors first in rank order, the first MAX_DET
    kept, un-letterboxed and normalized to the source frame."""
    b, k = keep.shape
    # A stable sort on "not kept" lists the kept slots first, in rank order.
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1]
    sel = order[:, :MAX_DET] if k >= MAX_DET else torch.cat(
        [order, order[:, :1].expand(b, MAX_DET - k)], dim=1)
    n_kept = torch.clamp(keep.sum(dim=-1, dtype=torch.int32), max=MAX_DET)
    det_valid = (torch.arange(MAX_DET, device=keep.device)[None, :]
                 < n_kept[:, None])
    out_boxes = torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, sel)
    out_class = torch.gather(top_class, 1, sel)

    s = scale[:, None]
    cx = (out_boxes[..., 0] - pad[:, 0:1]) / s
    cy = (out_boxes[..., 1] - pad[:, 1:2]) / s
    w = out_boxes[..., 2] / s
    h = out_boxes[..., 3] / s
    src_w, src_h = src_wh[:, 0:1], src_wh[:, 1:2]
    norm = torch.stack([
        torch.clamp(cx / src_w, 0.0, 1.0),
        torch.clamp(cy / src_h, 0.0, 1.0),
        torch.clamp(w / src_w, 0.0, 1.0),
        torch.clamp(h / src_h, 0.0, 1.0),
    ], dim=-1)
    zero = torch.zeros((), device=keep.device)
    return {
        "boxes": torch.where(det_valid[..., None], norm, zero),
        "scores": torch.where(det_valid, out_scores, zero),
        "classes": torch.where(det_valid, out_class,
                               torch.zeros((), dtype=torch.int32,
                                           device=keep.device)),
        "count": n_kept,
    }


def _nms_and_compact(top_boxes, top_scores, top_class, top_valid, iou_thresh,
                     scale, pad, src_wh, plain: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Stages 2+3: greedy same-class suppression, compact + un-letterbox."""
    keep = (nms_keep_plain if plain else nms_keep)(top_boxes, top_class,
                                                   top_valid, iou_thresh)
    out = _compact_one(top_boxes, top_scores, top_class, keep, scale, pad,
                       src_wh)
    # Class weights (> 1) boost scores for ranking/threshold, but the score
    # reported on the wire is a confidence: clip to [0, 1].
    out["scores"] = torch.clamp(out["scores"], 0.0, 1.0)
    return out


def postprocess_batch(pred: torch.Tensor, class_weights: torch.Tensor,
                      conf_thresh: float, iou_thresh: float,
                      scale: torch.Tensor, pad: torch.Tensor,
                      src_wh: torch.Tensor, topk: int = PRE_NMS_TOPK,
                      plain: bool = False) -> Dict[str, torch.Tensor]:
    """Batched postprocess.

    pred:    (B, A, 4+nc) decoded model output (model-input pixel boxes)
    class_weights: (nc,) score multipliers
    conf_thresh / iou_thresh: host floats (runtime values)
    scale:   (B,) letterbox scale; pad: (B, 2) = (pad_x, pad_y)
    src_wh:  (B, 2) source frame (w, h) as float
    plain:   run the NMS kernel's plain version (reference runs)
    """
    topk = min(topk, pred.shape[1])
    top_boxes, top_scores, top_class, top_valid = _select_one(
        pred, class_weights, conf_thresh, topk)
    return _nms_and_compact(top_boxes, top_scores, top_class, top_valid,
                            iou_thresh, scale, pad, src_wh, plain=plain)


def postprocess_batch_levels(boxes_l: Sequence[torch.Tensor],
                             probs_l: Sequence[torch.Tensor],
                             class_weights: torch.Tensor, conf_thresh: float,
                             iou_thresh: float, scale: torch.Tensor,
                             pad: torch.Tensor, src_wh: torch.Tensor,
                             topk: int = PRE_NMS_TOPK, plain: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """postprocess_batch over the level-separated decode
    (tpu.select="perlevel"): the top min(topk, A_l) candidates within each
    FPN level, then the global top-k over the levels' survivors, ranked by
    the same stable descending sort. The kept set equals the global top-k
    over all anchors; among equal scores the order may differ (the JAX
    package says the same of its `lax.top_k` form)."""
    cs, cb, cc = [], [], []
    for bx, pr in zip(boxes_l, probs_l):
        b, s, c = _rank_candidates(bx, pr, class_weights, conf_thresh,
                                   min(topk, pr.shape[1]))
        cs.append(s)
        cb.append(b)
        cc.append(c)
    scores = torch.cat(cs, dim=1)
    boxes = torch.cat(cb, dim=1)
    classes = torch.cat(cc, dim=1)
    k = min(topk, scores.shape[1])
    top_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, ti = top_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, ti[..., None].expand(-1, -1, 4))
    top_class = torch.gather(classes, 1, ti)
    return _nms_and_compact(top_boxes, top_scores, top_class, top_scores > 0,
                            iou_thresh, scale, pad, src_wh, plain=plain)


def pack_outputs(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pack the postprocess dict into ONE f32 array (B, 1 + 6*MAX_DET):
    [count, boxes.flat, scores, classes]. Class ids are small ints, exact
    in f32."""
    b = out["count"].shape[0]
    return torch.cat([
        out["count"].to(torch.float32)[:, None],
        out["boxes"].reshape(b, -1),
        out["scores"],
        out["classes"].to(torch.float32),
    ], dim=-1)


def unpack_outputs(arr: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side inverse of pack_outputs (on the already-read-back array)."""
    b = arr.shape[0]
    boxes_end = 1 + 4 * MAX_DET
    return {
        "count": arr[:, 0].astype(np.int32),
        "boxes": arr[:, 1:boxes_end].reshape(b, MAX_DET, 4),
        "scores": arr[:, boxes_end:boxes_end + MAX_DET],
        "classes": arr[:, boxes_end + MAX_DET:boxes_end + 2 * MAX_DET]
        .astype(np.int32),
    }


# ---------------------------------------------------------------------------
# NumPy reference (test oracle)
# ---------------------------------------------------------------------------

def nms_reference(pred: np.ndarray, class_weights: np.ndarray,
                  conf_thresh: float, iou_thresh: float) -> list:
    """Straightforward per-class greedy NMS in NumPy, mirroring the reference
    C++ (sort by confidence, same-class IoU suppression). Returns a list of
    (box_cxcywh_model_px, score, class_id), score-descending."""
    probs = pred[:, 4:] * class_weights[None, :]
    best = probs.max(axis=1)
    cls = probs.argmax(axis=1)
    sel = best >= conf_thresh
    boxes, scores, classes = pred[sel, :4], best[sel], cls[sel]
    order = np.argsort(-scores, kind="stable")
    boxes, scores, classes = boxes[order], scores[order], classes[order]
    kept = []
    suppressed = np.zeros(len(scores), dtype=bool)
    for i in range(len(scores)):
        if suppressed[i]:
            continue
        kept.append((boxes[i], float(min(scores[i], 1.0)), int(classes[i])))
        for j in range(i + 1, len(scores)):
            if suppressed[j] or classes[j] != classes[i]:
                continue
            if _iou_center_np(boxes[i], boxes[j]) > iou_thresh:
                suppressed[j] = True
    return kept


def _iou_center_np(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / max(union, 1e-9)
