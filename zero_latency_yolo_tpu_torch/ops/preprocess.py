"""On-device frame preprocessing: letterbox resize + normalize.

The PyTorch counterpart of the JAX package's `ops/preprocess.py` default,
`letterbox_batch_mxu`: an aspect-preserving bilinear resize onto a 114-gray
canvas (the ultralytics convention), written as two interpolation-matrix
products per frame. Frames arrive padded into a fixed (Hbuf, Wbuf) bucket;
the true per-frame (h, w) are runtime tensors, so one batch shape serves
every client resolution within a bucket.

The interpolation matrices reproduce `_interp_matrix` exactly (edge
clipping, the inside mask, FILL = 114/255, round-half-even in
`letterbox_params`); `F.interpolate` samples differently and is not used.
The two products are plain `torch.matmul` in f32: in bf16 the operands are
rounded to bf16 first and the intermediate product once more, as the JAX
package's bf16 einsums with f32 accumulation do.
"""

from __future__ import annotations

import torch

FILL = 114.0 / 255.0  # ultralytics letterbox gray


def letterbox_params(h: torch.Tensor, w: torch.Tensor, size: int):
    """Scale and pad offsets for letterboxing (h, w) into (size, size).

    h, w: f32 tensors (any shape). Returns (scale, pad_x, pad_y)."""
    h = h.to(torch.float32)
    w = w.to(torch.float32)
    scale = torch.minimum(size / h, size / w)
    new_h = torch.round(h * scale)
    new_w = torch.round(w * scale)
    pad_y = (size - new_h) / 2.0
    pad_x = (size - new_w) / 2.0
    return scale, pad_x, pad_y


def _interp_matrix(src_coords: torch.Tensor, src_size: int,
                   valid_len: torch.Tensor) -> torch.Tensor:
    """(B, out, src_size) bilinear interpolation matrices for runtime coords
    src_coords (B, out) and per-frame valid lengths (B,).

    Row o has weight (1-f) at clip(floor(c),0,valid-1) and f at
    clip(floor(c)+1,0,valid-1); when both clip to the same index the weights
    sum to 1 (edge replication). Rows whose source coordinate falls outside
    [-0.5, valid-0.5] are zeroed (letterbox padding, filled afterwards).
    """
    c0 = torch.floor(src_coords)
    f = (src_coords - c0)[..., None]
    valid_f = valid_len.to(torch.float32)[:, None]
    i0 = torch.minimum(torch.clamp(c0, min=0), valid_f - 1)[..., None]
    i1 = torch.minimum(torch.clamp(c0 + 1, min=0), valid_f - 1)[..., None]
    idx = torch.arange(src_size, dtype=torch.float32,
                       device=src_coords.device)
    mat = (idx == i0) * (1.0 - f) + (idx == i1) * f
    inside = ((src_coords >= -0.5) & (src_coords <= valid_f - 0.5))[..., None]
    return torch.where(inside, mat, torch.zeros((), device=mat.device))


def letterbox_batch_mxu(frames: torch.Tensor, heights: torch.Tensor,
                        widths: torch.Tensor, size: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Letterbox a padded uint8 batch (B, Hbuf, Wbuf, 3) -> (B, size, size, 3)
    f32 via two interpolation products:

        out[b, o, p, c] = sum_{i, j} Ry[b, o, i] * frame[b, i, j, c] * Rx[b, p, j]

    heights/widths: (B,) int32 true frame dims within the padded buffer.
    dtype=torch.bfloat16 rounds the operands to bf16 (f32 accumulation)."""
    bsz, hbuf, wbuf, _ = frames.shape
    hf = heights.to(torch.float32)
    wf = widths.to(torch.float32)
    scale, pad_x, pad_y = letterbox_params(hf, wf, size)
    o = torch.arange(size, dtype=torch.float32, device=frames.device)
    src_y = (o[None, :] - pad_y[:, None] + 0.5) / scale[:, None] - 0.5
    src_x = (o[None, :] - pad_x[:, None] + 0.5) / scale[:, None] - 0.5

    def cast(t):
        return t.to(dtype).to(torch.float32)

    ry = cast(_interp_matrix(src_y, hbuf, heights))          # (B, S, Hbuf)
    rx = cast(_interp_matrix(src_x, wbuf, widths))           # (B, S, Wbuf)
    f = frames.to(torch.float32).reshape(bsz, hbuf, wbuf * 3)
    tmp = cast(torch.bmm(ry, f)).reshape(bsz, size * wbuf, 3)  # (B, S*Wbuf, 3)
    # out[b, o, p, c] = sum_j rx[b, p, j] tmp[b, o, j, c]
    tmp = tmp.reshape(bsz, size, wbuf, 3).permute(0, 2, 1, 3).reshape(
        bsz, wbuf, size * 3)
    out = torch.bmm(rx, tmp).reshape(bsz, size, size, 3)     # (B, P, O, 3)
    out = out.permute(0, 2, 1, 3) / 255.0                     # (B, O, P, 3)
    inside = (((src_y >= -0.5) & (src_y <= hf[:, None] - 0.5))[:, :, None]
              & ((src_x >= -0.5) & (src_x <= wf[:, None] - 0.5))[:, None, :])
    return torch.where(inside[..., None], out,
                       torch.full((), FILL, device=out.device)).contiguous()
