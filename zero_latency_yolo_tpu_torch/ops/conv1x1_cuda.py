"""1x1 conv as a matmul with a fused bias(+SiLU) epilogue: CUDA kernel,
plain PyTorch version, launch count.

Replaces the JAX package's TPU kernel `ops/conv1x1_pallas.py`
(`_mm_bias_silu_kernel` / `_mm_bias_kernel`, via `conv1x1_bias_act`): for an
NHWC activation viewed as x (M = B*H*W, Cin),

    y = silu(x @ w + b)        (or x @ w + b for the detect-head tips)

with f32 accumulation and the epilogue applied to the accumulator before the
one store, in x's type.

On the H100: YOLOv8n's 1x1 convs are thin (Cin 32-512, Cout 4-256), so at
the serving shapes the bytes of x and y, not the multiply-adds, set the
least time (a few tens of FLOPs per byte against the card's ~295 bf16
FLOPs per byte). The kernel (`csrc/kernels.cu` `mm_bias_act_kernel`) reads x
and w once per 64x64 output tile, keeps the sum in registers and writes y
once, so the bias and SiLU cost no memory traffic. It is a plain
shared-memory tiled GEMM on the CUDA cores; `wgmma` and TMA are later work.
It takes every shape: the edges of M, Cin and Cout are masked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0


def conv1x1_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           act: bool = True) -> torch.Tensor:
    """Plain PyTorch version: f32 matmul + bias (+ SiLU), stored in x's type."""
    z = torch.addmm(b.float(), x.float(), w.float())
    if act:
        z = F.silu(z)
    return z.to(x.dtype)


def conv1x1_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: bool = True) -> torch.Tensor:
    """silu(x @ w + b) (or x @ w + b with act=False) over x (M, Cin),
    w (Cin, Cout) in x's type and b (Cout,) f32. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return conv1x1_bias_act_plain(x, w, b, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_bias_act: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != torch.float32:
        raise ValueError(f"conv1x1_bias_act: dtypes x={x.dtype} w={w.dtype} "
                         f"b={b.dtype} (want x, w both f32 or bf16; b f32)")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or w.shape[0] != x.shape[1] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"conv1x1_bias_act: shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} b={tuple(b.shape)}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv1x1_bias_act: inputs must be contiguous")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv1x1_bias_act: inputs on different devices")
    m, cin = x.shape
    cout = w.shape[1]
    if m >= 2 ** 31 or cin * cout >= 2 ** 31:
        raise ValueError("conv1x1_bias_act: shape exceeds 32-bit indexing")
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    lib = kernels().lib
    with torch.cuda.device(x.device):
        err = lib.zlt_conv1x1_bias_act(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, cin,
            cout, int(act), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "conv1x1_bias_act")
    global launches
    launches += 1
    return out
