"""Greedy-NMS suppression scan: CUDA kernel, plain PyTorch version, launch
count.

Replaces the JAX package's TPU kernel `ops/nms_pallas.py`
(`_suppress_kernel`, via `greedy_nms_mask_pallas`): over score-sorted
candidates, row i removes every j > i with `iou[i, j] > thr` and the same
class, while i itself is still kept. Exact greedy NMS; K = pre_nms_topk.

On the H100 the scan is bound by latency, not by bytes or operations: it is
K dependent steps, and the (B, K, K) inputs it reads are a few MB at most.
The kernel (`csrc/kernels.cu` `nms_suppress_kernel`) runs one block per frame
with one thread per column and the keep mask in shared memory, so each step
is one barrier and one coalesced row read, and the rows of candidates that
are already suppressed are never read. It takes the IoU matrix that
`ops/nms.py` computes beside it, as the TPU kernel did; computing the IoU
inside the kernel so that the K x K matrix never reaches device memory is
later work.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import check, kernels

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0


def greedy_nms_mask_plain(iou: torch.Tensor, same_class: torch.Tensor,
                          valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch version: the K-step scan as vector ops over the batch."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    suppress = ((iou > float(np.float32(iou_thresh))) & same_class
                & (idx[None, :] > idx[:, None]))
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[:, i, :] & keep[:, i:i + 1])
    return keep


def greedy_nms_mask(iou: torch.Tensor, same_class: torch.Tensor,
                    valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Batched suppression scan.

    iou:        (B, K, K) f32 pairwise IoU, rows score-sorted descending
    same_class: (B, K, K) bool
    valid:      (B, K) bool (score above the confidence threshold)
    returns     (B, K) bool keep mask

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if iou.device.type == "cpu":
        return greedy_nms_mask_plain(iou, same_class, valid, iou_thresh)
    if iou.device.type != "cuda":
        raise ValueError(f"greedy_nms_mask: unsupported device {iou.device}")
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"greedy_nms_mask: iou shape {tuple(iou.shape)}")
    b, k, _ = iou.shape
    if same_class.shape != iou.shape or valid.shape != (b, k):
        raise ValueError(f"greedy_nms_mask: shapes iou={tuple(iou.shape)} "
                         f"same={tuple(same_class.shape)} "
                         f"valid={tuple(valid.shape)}")
    if (iou.dtype != torch.float32 or same_class.dtype != torch.bool
            or valid.dtype != torch.bool):
        raise ValueError("greedy_nms_mask: want iou f32, same_class and "
                         "valid bool")
    if not 1 <= k <= 1024:
        raise ValueError(f"greedy_nms_mask: K={k} outside 1..1024 (one "
                         "thread per candidate)")
    if same_class.device != iou.device or valid.device != iou.device:
        raise ValueError("greedy_nms_mask: inputs on different devices")
    iou = iou.contiguous()
    same8 = same_class.contiguous().view(torch.int8)  # bool bytes are 0/1
    valid32 = valid.to(torch.int32).contiguous()
    keep = torch.empty((b, k), dtype=torch.int32, device=iou.device)
    lib = kernels().lib
    with torch.cuda.device(iou.device):
        err = lib.zlt_nms_suppress(
            iou.data_ptr(), same8.data_ptr(), valid32.data_ptr(),
            keep.data_ptr(), b, k, float(np.float32(iou_thresh)),
            torch.cuda.current_stream(iou.device).cuda_stream)
    check(err, "greedy_nms_mask")
    global launches
    launches += 1
    return keep != 0
