"""On-device frame preprocessing: letterbox resize + normalize.

The PyTorch counterpart of the JAX package's `ops/preprocess.py`, one
function for each `tpu.preprocess` / `tpu.stem` value:

- `letterbox_batch_mxu` (the default): an aspect-preserving bilinear resize
  onto a 114-gray canvas (the ultralytics convention), written as two
  interpolation-matrix products per frame;
- `letterbox_batch_mxu_s2d` (stem="s2d"): the same products, emitting the
  (B, S/2, S/2, 12) space-to-depth layout directly;
- `letterbox_batch` ("letterbox"): the same resize as four gathers per
  output pixel and a bilinear blend;
- `stretch_batch` ("stretch"): the reference's nearest-neighbor stretch;
- `letterbox_batch_rowcol`: the letterbox as separable row and column
  gathers plus a lerp. No config value selects it (as in the JAX package,
  whose `tpu.preprocess` enum leaves it out); it is here so that the
  module is whole.

Frames arrive padded into a fixed (Hbuf, Wbuf) bucket; the true per-frame
(h, w) are runtime tensors, so one batch shape serves every client
resolution within a bucket. The JAX package computes all of these in XLA;
here they are plain PyTorch.

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

    ry = _cast(_interp_matrix(src_y, hbuf, heights), dtype)   # (B, S, Hbuf)
    rx = _cast(_interp_matrix(src_x, wbuf, widths), dtype)   # (B, S, Wbuf)
    f = frames.to(torch.float32).reshape(bsz, hbuf, wbuf * 3)
    out = _rows_then_cols(ry, f, rx, dtype)                  # (B, O, P, 3)
    inside = (((src_y >= -0.5) & (src_y <= hf[:, None] - 0.5))[:, :, None]
              & ((src_x >= -0.5) & (src_x <= wf[:, None] - 0.5))[:, None, :])
    return torch.where(inside[..., None], out,
                       torch.full((), FILL, device=out.device)).contiguous()


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to `dtype` and back to f32 (the JAX package's operand
    casts before an f32-accumulating einsum)."""
    return t.to(dtype).to(torch.float32)


def _rows_then_cols(ry: torch.Tensor, f: torch.Tensor, rx: torch.Tensor,
                    dtype) -> torch.Tensor:
    """out[b, o, p, c] = sum_j rx[b, p, j] (sum_i ry[b, o, i] f[b, i, j, c])
    / 255 for ry (B, O, Hbuf), f (B, Hbuf, Wbuf*3) and rx (B, P, Wbuf);
    the intermediate rounded to `dtype`. Returns (B, O, P, 3)."""
    bsz, n_o, n_p, wbuf = ry.shape[0], ry.shape[1], rx.shape[1], rx.shape[2]
    tmp = _cast(torch.bmm(ry, f), dtype)                      # (B, O, Wbuf*3)
    tmp = tmp.reshape(bsz, n_o, wbuf, 3).permute(0, 2, 1, 3).reshape(
        bsz, wbuf, n_o * 3)
    out = torch.bmm(rx, tmp).reshape(bsz, n_p, n_o, 3)       # (B, P, O, 3)
    return out.permute(0, 2, 1, 3) / 255.0


def letterbox_batch_mxu_s2d(frames: torch.Tensor, heights: torch.Tensor,
                            widths: torch.Tensor, size: int,
                            dtype=torch.float32) -> torch.Tensor:
    """The letterbox of letterbox_batch_mxu in the space-to-depth layout
    (B, size/2, size/2, 12), channel a*6+b*3+c = letterboxed[2p+a, 2q+b, c]:
    the row matrix split by output-row parity into two half-height products,
    each column product writing its (a, b) block of channels (the JAX
    package's `_letterbox_one_mxu_s2d`). Feeds models/yolov8.py
    stem="s2d"."""
    if size % 2:
        raise ValueError("s2d letterbox needs an even model size")
    bsz, hbuf, wbuf, _ = frames.shape
    hf = heights.to(torch.float32)
    wf = widths.to(torch.float32)
    scale, pad_x, pad_y = letterbox_params(hf, wf, size)
    o = torch.arange(size, dtype=torch.float32, device=frames.device)
    src_y = (o[None, :] - pad_y[:, None] + 0.5) / scale[:, None] - 0.5
    src_x = (o[None, :] - pad_x[:, None] + 0.5) / scale[:, None] - 0.5
    ry = _cast(_interp_matrix(src_y, hbuf, heights), dtype)
    rx = _cast(_interp_matrix(src_x, wbuf, widths), dtype)
    iy = (src_y >= -0.5) & (src_y <= hf[:, None] - 0.5)
    ix = (src_x >= -0.5) & (src_x <= wf[:, None] - 0.5)
    f = frames.to(torch.float32).reshape(bsz, hbuf, wbuf * 3)
    fill = torch.full((), FILL, device=frames.device)
    blocks = []
    for a in (0, 1):
        for b in (0, 1):
            out = _rows_then_cols(ry[:, a::2].contiguous(), f,
                                  rx[:, b::2].contiguous(), dtype)
            inside = iy[:, a::2, None] & ix[:, None, b::2]
            blocks.append(torch.where(inside[..., None], out, fill))
    return torch.cat(blocks, dim=-1)


def letterbox_batch(frames: torch.Tensor, heights: torch.Tensor,
                    widths: torch.Tensor, size: int) -> torch.Tensor:
    """Letterbox a padded uint8 batch (B, Hbuf, Wbuf, 3) -> (B, size, size, 3)
    f32 by bilinear sampling: four clipped gathers per output pixel and the
    blend of the JAX package's `_bilinear_sample` (edge replication at the
    frame's true (h, w), FILL outside it)."""
    bsz, hbuf, wbuf, _ = frames.shape
    hf = heights.to(torch.float32)[:, None, None]
    wf = widths.to(torch.float32)[:, None, None]
    scale, pad_x, pad_y = letterbox_params(hf, wf, size)
    o = torch.arange(size, dtype=torch.float32, device=frames.device)
    sy = ((o[None, :, None] - pad_y + 0.5) / scale - 0.5).expand(
        bsz, size, size)
    sx = ((o[None, None, :] - pad_x + 0.5) / scale - 0.5).expand(
        bsz, size, size)
    inside = (sy >= -0.5) & (sy <= hf - 0.5) & (sx >= -0.5) & (sx <= wf - 0.5)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    flat = frames.reshape(bsz, hbuf * wbuf, 3)

    def clip_gather(yi, xi):
        yi = torch.minimum(torch.clamp(yi, min=0), hf - 1).to(torch.int64)
        xi = torch.minimum(torch.clamp(xi, min=0), wf - 1).to(torch.int64)
        idx = (yi * wbuf + xi).reshape(bsz, size * size, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(
            bsz, size, size, 3).to(torch.float32)

    v00 = clip_gather(y0, x0)
    v01 = clip_gather(y0, x0 + 1)
    v10 = clip_gather(y0 + 1, x0)
    v11 = clip_gather(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = (top * (1 - fy) + bot * fy) / 255.0
    return torch.where(inside[..., None], out,
                       torch.full((), FILL, device=out.device))


def stretch_batch(frames: torch.Tensor, heights: torch.Tensor,
                  widths: torch.Tensor, size: int) -> torch.Tensor:
    """The reference's nearest-neighbor stretch (no letterbox,
    onnx_engine.cpp:677-697): source index floor(dst * src / size), clipped
    to the frame's true (h, w). (B, Hbuf, Wbuf, 3) uint8 -> (B, size, size,
    3) f32 in [0, 1]."""
    bsz, hbuf, wbuf, _ = frames.shape
    o = torch.arange(size, dtype=torch.float32, device=frames.device)
    h = heights.to(torch.int64)[:, None]
    w = widths.to(torch.int64)[:, None]
    sy = torch.minimum(torch.clamp(
        (o[None, :] * heights.to(torch.float32)[:, None] / size).to(
            torch.int64), min=0), h - 1)
    sx = torch.minimum(torch.clamp(
        (o[None, :] * widths.to(torch.float32)[:, None] / size).to(
            torch.int64), min=0), w - 1)
    idx = (sy[:, :, None] * wbuf + sx[:, None, :]).reshape(bsz, size * size, 1)
    flat = frames.reshape(bsz, hbuf * wbuf, 3)
    out = torch.gather(flat, 1, idx.expand(-1, -1, 3))
    return out.reshape(bsz, size, size, 3).to(torch.float32) / 255.0


def letterbox_batch_rowcol(frames: torch.Tensor, heights: torch.Tensor,
                           widths: torch.Tensor, size: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Letterbox a padded uint8 batch (B, Hbuf, Wbuf, 3) -> (B, size, size,
    3) f32 by separable row and column gathers plus a lerp (the JAX
    package's `letterbox_batch_rowcol`): bilinear taps exactly two source
    rows per output row, so the resample is S row gathers, a lerp, S column
    gathers and a lerp, in `dtype`, then / 255 in f32; FILL outside the
    frame's true (h, w). Equal to `letterbox_batch` in f32."""
    bsz = frames.shape[0]
    hf = heights.to(torch.float32)[:, None]
    wf = widths.to(torch.float32)[:, None]
    scale, pad_x, pad_y = letterbox_params(hf, wf, size)
    o = torch.arange(size, dtype=torch.float32, device=frames.device)[None]
    sy = (o - pad_y + 0.5) / scale - 0.5                    # (B, S)
    sx = (o - pad_x + 0.5) / scale - 0.5

    def taps(s, valid):
        s0 = torch.floor(s)
        frac = (s - s0).to(dtype)
        i0 = torch.minimum(torch.clamp(s0, min=0), valid - 1).to(torch.int64)
        i1 = torch.minimum(torch.clamp(s0 + 1, min=0), valid - 1).to(torch.int64)
        return i0, i1, frac

    y0, y1, fy = taps(sy, hf)
    b = torch.arange(bsz, device=frames.device)[:, None]
    fy = fy[:, :, None, None]
    rows = (frames[b, y0].to(dtype) * (1 - fy)
            + frames[b, y1].to(dtype) * fy)                # (B, S, Wbuf, 3)
    x0, x1, fx = taps(sx, wf)
    fx = fx[:, None, :, None]
    out = (torch.take_along_dim(rows, x0[:, None, :, None], dim=2) * (1 - fx)
           + torch.take_along_dim(rows, x1[:, None, :, None], dim=2) * fx)
    out = out.to(torch.float32) / 255.0
    inside = (((sy >= -0.5) & (sy <= hf - 0.5))[:, :, None]
              & ((sx >= -0.5) & (sx <= wf - 0.5))[:, None, :])
    return torch.where(inside[..., None], out,
                       torch.full((), FILL, device=out.device))
