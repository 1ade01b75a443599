"""Conv bias + SiLU epilogue: CUDA kernel, plain PyTorch version, launch
count.

Replaces the JAX package's TPU kernel `ops/act_pallas.py`
(`_bias_silu_kernel`, via `fused_bias_silu`): elementwise

    out = silu(y + b)      over NHWC y (..., C), b (C,)

with f32 math and storage in y's type. It follows every conv that the 1x1
matmul kernel does not produce (the stem, the stride-2 convs, the k=3
bottleneck and head convs), which run as `F.conv2d` without bias.

On the H100 the pass is bound by bytes: one read and one write per element
against a handful of f32 operations. The kernel (`csrc/kernels.cu`
`bias_silu_vec_kernel`) walks the flat NHWC buffer with 16-byte vector loads
and stores when C is a multiple of the vector width (8 bf16 or 4 f32) and a
scalar grid-stride loop otherwise; the bias index is `i % C`. Unlike the TPU
kernel it has no lane rule: it takes every C, and it keeps the bias in f32
(the TPU kernel rounded it to y's type first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0


def bias_silu_plain(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: silu(y + b) in f32, stored in y's type."""
    return F.silu(y.float() + b.float()).to(y.dtype)


def bias_silu(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(y + b) over y (..., C) contiguous and b (C,) f32. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel."""
    if y.device.type == "cpu":
        return bias_silu_plain(y, b)
    if y.device.type != "cuda":
        raise ValueError(f"bias_silu: unsupported device {y.device}")
    if y.dtype not in _DTYPES or b.dtype != torch.float32:
        raise ValueError(f"bias_silu: dtypes y={y.dtype} b={b.dtype} "
                         "(want y f32 or bf16; b f32)")
    if y.dim() < 1 or b.dim() != 1 or b.shape[0] != y.shape[-1]:
        raise ValueError(f"bias_silu: shapes y={tuple(y.shape)} "
                         f"b={tuple(b.shape)}")
    if not (y.is_contiguous() and b.is_contiguous()):
        raise ValueError("bias_silu: inputs must be contiguous")
    if b.device != y.device:
        raise ValueError("bias_silu: inputs on different devices")
    out = torch.empty_like(y)
    lib = kernels().lib
    with torch.cuda.device(y.device):
        err = lib.zlt_bias_silu(
            y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(),
            y.shape[-1], _DTYPES[y.dtype],
            torch.cuda.current_stream(y.device).cuda_stream)
    check(err, "bias_silu")
    global launches
    launches += 1
    return out
