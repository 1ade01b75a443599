"""YOLOv8 detection loss (anchor-free, DFL) and response distillation.

The PyTorch counterpart of the JAX package's `train/loss.py`, term for term:

- **assignment** (no gradient), two schemes:
  - `"tal"`: task-aligned assignment: alignment metric t = p_cls^alpha *
    IoU^beta between each anchor's prediction and each GT, the top-k
    candidates per GT among anchors whose center lies inside the box,
    conflicts to the highest-t GT, soft classification targets
    t / max_t * max_IoU over the post-conflict assignment.
  - `"center"` (default): an anchor is positive when its center is inside
    the box and within `center_radius × stride` of the GT center;
    conflicts go to the smallest-area GT; hard one-hot targets.
- **cls**: BCE on class logits over all anchors.
- **box**: CIoU loss at positive anchors (TAL: weighted by the soft score).
- **dfl**: distribution focal loss on the ltrb bin distributions.

Targets are (B, M, 5) [class, cx, cy, w, h] in [0, 1], padded with class -1.
`torch.maximum` / `torch.minimum` stand where the JAX code has
`jnp.maximum` / `jnp.minimum`: both split the gradient of a tie in half.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.yolov8 import ModelSpec, anchors_for


def _pairwise_ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """CIoU between matched (N, 4) center-format boxes -> (N,)."""
    eps = 1e-9
    b1x1, b1y1 = box1[:, 0] - box1[:, 2] / 2, box1[:, 1] - box1[:, 3] / 2
    b1x2, b1y2 = box1[:, 0] + box1[:, 2] / 2, box1[:, 1] + box1[:, 3] / 2
    b2x1, b2y1 = box2[:, 0] - box2[:, 2] / 2, box2[:, 1] - box2[:, 3] / 2
    b2x2, b2y2 = box2[:, 0] + box2[:, 2] / 2, box2[:, 1] + box2[:, 3] / 2
    zero = box1.new_zeros(())
    iw = torch.maximum(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1),
                       zero)
    ih = torch.maximum(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1),
                       zero)
    inter = iw * ih
    union = box1[:, 2] * box1[:, 3] + box2[:, 2] * box2[:, 3] - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((box1[:, 0] - box2[:, 0]) ** 2 + (box1[:, 1] - box2[:, 1]) ** 2)
    v = (4 / math.pi ** 2) * (torch.atan(box2[:, 2] / (box2[:, 3] + eps)) -
                              torch.atan(box1[:, 2] / (box1[:, 3] + eps))) ** 2
    alpha = (v / (v - iou + 1 + eps)).detach()
    return iou - rho2 / c2 - alpha * v


def _iou_matrix(pred_px: torch.Tensor, gt_px: torch.Tensor) -> torch.Tensor:
    """Plain IoU between all (B, A, 4) predictions and (B, M, 4) GTs, both
    center-format px -> (B, A, M). The TAL alignment metric's IoU."""
    eps = 1e-9
    p = pred_px[:, :, None, :]
    g = gt_px[:, None, :, :]
    px1, py1 = p[..., 0] - p[..., 2] / 2, p[..., 1] - p[..., 3] / 2
    px2, py2 = p[..., 0] + p[..., 2] / 2, p[..., 1] + p[..., 3] / 2
    gx1, gy1 = g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2
    gx2, gy2 = g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2
    zero = pred_px.new_zeros(())
    iw = torch.maximum(torch.minimum(px2, gx2) - torch.maximum(px1, gx1), zero)
    ih = torch.maximum(torch.minimum(py2, gy2) - torch.maximum(py1, gy1), zero)
    inter = iw * ih
    union = (p[..., 2] * p[..., 3] + g[..., 2] * g[..., 3] - inter + eps)
    return inter / union


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of an integer tensor; an index outside [0, n) gives a
    zero row, as `jax.nn.one_hot` does (padding class -1)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def detection_loss(spec: ModelSpec, outs: Sequence[torch.Tensor],
                   targets: torch.Tensor, input_hw: Tuple[int, int],
                   center_radius: float = 2.5,
                   w_box: float = 7.5, w_cls: float = 0.5, w_dfl: float = 1.5,
                   assigner: str = "center", tal_topk: int = 10,
                   tal_alpha: float = 0.5, tal_beta: float = 6.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detection loss over raw per-level maps.

    outs:    list of (B, Hi, Wi, 4*reg_max + nc) from the training forward
    targets: (B, M, 5) [class, cx, cy, w, h] normalized, class=-1 padding
    """
    reg_max, nc = spec.reg_max, spec.num_classes
    h_in, w_in = input_hw
    b = outs[0].shape[0]
    dev = outs[0].device
    flat = torch.cat([o.reshape(b, -1, 4 * reg_max + nc) for o in outs], dim=1)
    box_logits = flat[..., :4 * reg_max]
    cls_logits = flat[..., 4 * reg_max:]
    anchors_np, strides_np = anchors_for(spec, h_in, w_in)
    anchors = torch.from_numpy(anchors_np).to(dev)         # (A, 2) grid units
    strides = torch.from_numpy(strides_np[:, 0]).to(dev)   # (A,)
    a = anchors.shape[0]
    anchor_px = anchors * strides[:, None]

    targets = targets.to(device=dev, dtype=torch.float32)
    gt_cls = targets[..., 0]
    gt_box_px = targets[..., 1:] * torch.tensor(
        [w_in, h_in, w_in, h_in], dtype=torch.float32, device=dev)
    gt_valid = gt_cls >= 0

    probs = torch.softmax(box_logits.reshape(b, a, 4, reg_max), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    dist = torch.sum(probs * bins, dim=-1)
    lt, rb = dist[..., :2], dist[..., 2:]
    x1y1 = anchors[None] - lt
    x2y2 = anchors[None] + rb
    pred_box_px = torch.cat(
        [(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1) * strides[None, :, None]

    ax = anchor_px[None, :, None, 0]
    ay = anchor_px[None, :, None, 1]
    gx = gt_box_px[:, None, :, 0]
    gy = gt_box_px[:, None, :, 1]
    gw = gt_box_px[:, None, :, 2]
    gh = gt_box_px[:, None, :, 3]
    inside = ((ax > gx - gw / 2) & (ax < gx + gw / 2) &
              (ay > gy - gh / 2) & (ay < gy + gh / 2))

    if assigner == "tal":
        cand = inside & gt_valid[:, None, :]
        cls_prob = torch.sigmoid(cls_logits.detach())
        gt_idx = torch.clamp(gt_cls, min=0).long()
        p_at_gt = torch.gather(cls_prob, 2,
                               gt_idx[:, None, :].expand(b, a, -1))
        iou = _iou_matrix(pred_box_px.detach(), gt_box_px)
        iou = torch.clamp(iou, min=0.0)
        metric = (p_at_gt ** tal_alpha) * (iou ** tal_beta)
        metric = torch.where(cand, metric, torch.zeros_like(metric))
        k = min(tal_topk, a)
        topv = torch.topk(metric.transpose(1, 2), k, dim=-1).values
        kth = topv[..., -1:].transpose(1, 2)                  # (B, 1, M)
        pos = cand & (metric >= kth) & (metric > 1e-12)
        m_masked = torch.where(pos, metric, torch.full_like(metric, -1.0))
        best_gt = torch.argmax(m_masked, dim=-1)              # (B, A)
        is_pos = torch.any(pos, dim=-1)
        owner = (F.one_hot(best_gt, pos.shape[-1]).bool()
                 & is_pos[..., None])
        final = pos & owner
        pos_metric = torch.where(final, metric, torch.zeros_like(metric))
        max_t = torch.amax(pos_metric, dim=1)                 # (B, M)
        max_iou = torch.amax(torch.where(final, iou, torch.zeros_like(iou)),
                             dim=1)
        norm = max_iou / (max_t + 1e-9)
        t_at_anchor = torch.gather(pos_metric, 2, best_gt[..., None])[..., 0]
        n_at_anchor = torch.gather(norm, 1, best_gt)
        score = torch.where(is_pos, t_at_anchor * n_at_anchor,
                            torch.zeros_like(t_at_anchor))
    elif assigner == "center":
        radius = center_radius * strides[None, :, None]
        near = (torch.abs(ax - gx) < radius) & (torch.abs(ay - gy) < radius)
        pos = inside & near & gt_valid[:, None, :]
        area = torch.where(pos, gw * gh, torch.full_like(pos, math.inf,
                                                          dtype=torch.float32))
        best_gt = torch.argmin(area, dim=-1)
        is_pos = torch.any(pos, dim=-1)
        score = is_pos.float()
    else:
        raise ValueError(f"unknown assigner {assigner!r}")

    m_box = torch.gather(gt_box_px, 1, best_gt[..., None].expand(b, a, 4))
    m_cls = torch.gather(gt_cls, 1, best_gt)

    num_pos = torch.clamp(torch.sum(is_pos.float()), min=1.0)
    score = score.detach()
    score_sum = torch.clamp(torch.sum(score), min=1.0)

    one_hot = _one_hot(m_cls.long(), nc) * score[..., None]
    cls_loss = torch.sum(_bce_logits(cls_logits, one_hot)) / score_sum

    w_pos = score
    ciou = _pairwise_ciou(pred_box_px.reshape(-1, 4), m_box.reshape(-1, 4))
    box_loss = torch.sum((1.0 - ciou) * w_pos.reshape(-1)) / score_sum

    gxy = m_box[..., :2] / strides[None, :, None]
    gwh = m_box[..., 2:] / strides[None, :, None]
    tlt = anchors[None] - (gxy - gwh / 2)
    trb = (gxy + gwh / 2) - anchors[None]
    tdist = torch.clamp(torch.cat([tlt, trb], dim=-1), 0, reg_max - 1 - 1e-3)
    tl = torch.floor(tdist)
    wr = tdist - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(box_logits.reshape(b, a, 4, reg_max), dim=-1)
    tl_i = tl.long()
    lp_l = torch.gather(logp, 3, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, 3,
                        torch.clamp(tl_i + 1, max=reg_max - 1)[..., None])[..., 0]
    dfl = -(wl * lp_l + wr * lp_r)
    dfl_loss = torch.sum(torch.mean(dfl, dim=-1) * w_pos) / score_sum

    total = w_box * box_loss + w_cls * cls_loss + w_dfl * dfl_loss
    return total, {"box": box_loss, "cls": cls_loss, "dfl": dfl_loss,
                   "num_pos": num_pos}


def _bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def distill_loss(spec: ModelSpec, teacher_outs: Sequence[torch.Tensor],
                 student_outs: Sequence[torch.Tensor],
                 temp: float = 2.0, w_cls: float = 1.0, w_box: float = 1.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Response-based knowledge distillation over raw per-level head maps
    (the JAX package's `distill_loss`): tempered soft-target BCE over every
    anchor and class, and the KL between teacher and student DFL bin
    distributions weighted by the teacher's quality max_c sigmoid(t_cls);
    both scaled by temp**2. The teacher maps carry no gradient (the train
    step runs the teacher under `torch.no_grad`)."""
    reg_max, nc = spec.reg_max, spec.num_classes
    b = student_outs[0].shape[0]
    eps = 1e-9
    flat_s = torch.cat(
        [o.reshape(b, -1, 4 * reg_max + nc) for o in student_outs], dim=1)
    flat_t = torch.cat(
        [o.reshape(b, -1, 4 * reg_max + nc) for o in teacher_outs], dim=1)
    if flat_s.shape != flat_t.shape:
        raise ValueError(
            f"teacher/student head shapes disagree: {tuple(flat_t.shape)} vs "
            f"{tuple(flat_s.shape)} (reg_max/nc/strides must match)")
    a = flat_s.shape[1]
    s_box = flat_s[..., :4 * reg_max].reshape(b, a, 4, reg_max)
    s_cls = flat_s[..., 4 * reg_max:]
    t_box = flat_t[..., :4 * reg_max].reshape(b, a, 4, reg_max)
    t_cls = flat_t[..., 4 * reg_max:]

    p_t = torch.sigmoid(t_cls / temp)
    kd_cls = torch.mean(_bce_logits(s_cls / temp, p_t)) * temp ** 2

    q = torch.amax(torch.sigmoid(t_cls), dim=-1)
    q_sum = torch.clamp(torch.sum(q), min=1.0)
    p_tb = torch.softmax(t_box / temp, dim=-1)
    lp_s = torch.log_softmax(s_box / temp, dim=-1)
    kl = torch.sum(p_tb * (torch.log(p_tb + eps) - lp_s), dim=-1)
    kd_box = torch.sum(torch.mean(kl, dim=-1) * q) / q_sum * temp ** 2

    total = w_cls * kd_cls + w_box * kd_box
    return total, {"kd_cls": kd_cls, "kd_box": kd_box}
