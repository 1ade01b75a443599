"""Greedy same-class NMS keep mask: CUDA kernel, plain PyTorch version,
host plan, launch count.

Replaces the JAX package's TPU kernel `ops/nms_pallas.py`
(`_suppress_kernel`, via `greedy_nms_mask_pallas`) and the pairwise IoU and
same-class matrices built in front of it: over score-sorted candidates,
candidate i removes every j > i of its class with IoU(i, j) > thr while i
itself is still kept. Exact greedy NMS; K = pre_nms_topk.

On the H100 the work is bound by neither bytes nor operations but by the
serial chain of greedy NMS. The kernel (`csrc/nms_sm90.cu`
`nms_keep_kernel`) takes the boxes, classes and valid flags and returns the
keep mask in one launch: one block a frame builds the upper-triangle
suppression bitmask in shared memory from the boxes, and one warp scans it,
jumping from one alive candidate to the next, so the chain has one step per
kept box. The (B, K, K) IoU matrix never reaches device memory.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ._build import check, kernels

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0

MAX_K = 1024  # lane w of the scanning warp holds keep word w
MAX_THREADS = 1024


@dataclass(frozen=True)
class NmsPlan:
    """Launch plan of nms_keep_kernel for K candidates a frame."""
    words: int    # keep / mask words a row: ceil(K / 32)
    stride: int   # mask row stride in words: 32 * words + 1 (distinct banks)
    threads: int  # a block: one per mask word (w, i), 32..1024
    smem: int     # dynamic shared memory bytes a block


@functools.cache
def plan_nms_keep(k: int) -> NmsPlan:
    """The kernel's shared-memory layout and block size (csrc/nms_sm90.cu):
    the mask (words x stride u32), five f32 and one i32 a box, the words
    (cached: the step is host-bound)."""
    words = (k + 31) // 32
    stride = 32 * words + 1
    threads = min(MAX_THREADS, max(32, 32 * math.ceil(words * k / 32)))
    return NmsPlan(words, stride, threads,
                   4 * (words * stride + 6 * k + words))


def _iou_matrix_center(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) center-format boxes -> (..., K, K)."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    x1, y1 = cx - w / 2, cy - h / 2
    x2, y2 = cx + w / 2, cy + h / 2
    area = torch.clamp(w, min=0) * torch.clamp(h, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    iw = torch.clamp(ix2 - ix1, min=0)
    ih = torch.clamp(iy2 - iy1, min=0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def greedy_nms_mask_plain(iou: torch.Tensor, same_class: torch.Tensor,
                          valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The K-step suppression scan as vector ops over the batch.

    iou:        (B, K, K) f32 pairwise IoU, rows score-sorted descending
    same_class: (B, K, K) bool
    valid:      (B, K) bool (score above the confidence threshold)
    returns     (B, K) bool keep mask
    """
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    suppress = ((iou > float(np.float32(iou_thresh))) & same_class
                & (idx[None, :] > idx[:, None]))
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[:, i, :] & keep[:, i:i + 1])
    return keep


def nms_keep_plain(boxes: torch.Tensor, classes: torch.Tensor,
                   valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch version: the IoU matrix, the same-class mask and the
    scan, each materialised."""
    same = classes[:, :, None] == classes[:, None, :]
    return greedy_nms_mask_plain(_iou_matrix_center(boxes), same, valid,
                                 iou_thresh)


def nms_keep(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
             iou_thresh: float) -> torch.Tensor:
    """Greedy same-class NMS.

    boxes:   (B, K, 4) f32 center format (cx, cy, w, h), score-sorted
    classes: (B, K) int32
    valid:   (B, K) bool (score above the confidence threshold)
    returns  (B, K) bool keep mask

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, classes, valid, iou_thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"nms_keep: boxes shape {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if classes.shape != (b, k) or valid.shape != (b, k):
        raise ValueError(f"nms_keep: shapes boxes={tuple(boxes.shape)} "
                         f"classes={tuple(classes.shape)} "
                         f"valid={tuple(valid.shape)}")
    if (boxes.dtype != torch.float32 or classes.dtype != torch.int32
            or valid.dtype != torch.bool):
        raise ValueError("nms_keep: want boxes f32, classes int32, valid bool")
    if b < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"nms_keep: B={b}, K={k}: want B >= 1 and K in "
                         f"1..{MAX_K} (one scan lane a keep word)")
    if classes.device != boxes.device or valid.device != boxes.device:
        raise ValueError("nms_keep: inputs on different devices")
    if not (boxes.is_contiguous() and classes.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("nms_keep: inputs must be contiguous")
    thr = float(np.float32(iou_thresh))
    if not thr >= 0.0:
        raise ValueError(f"nms_keep: iou_thresh {iou_thresh} must be >= 0 "
                         "(a pair that does not intersect is never tested)")
    plan = plan_nms_keep(k)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    index = boxes.get_device()
    with torch.cuda.device(index):
        err = kernels().lib.zlt_nms_keep(
            boxes.data_ptr(), classes.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), b, k, thr, plan.threads, plan.smem,
            torch.cuda.current_stream(index).cuda_stream)
    check(err, "nms_keep")
    global launches
    launches += 1
    return keep
