"""Conv bias + SiLU epilogue: CUDA kernel, plain PyTorch version, launch
count.

Replaces the JAX package's TPU kernel `ops/act_pallas.py`
(`_bias_silu_kernel`, via `fused_bias_silu`): elementwise

    out = silu(y + b)      over NHWC y (..., C), b (C,)

with f32 math and storage in y's type. It follows every conv that the 1x1
matmul kernel does not produce (the stem, the stride-2 convs, the k=3
bottleneck and head convs), which run as `F.conv2d` without bias.

On the H100 the pass is bound by bytes: one read and one write per element
against a handful of f32 operations. When C is a multiple of the vector
width (8 bf16 or 4 f32) and the buffers are 16-byte aligned, the kernel
(`csrc/kernels.cu` `bias_silu_vec_kernel`) walks the flat NHWC buffer in
16-byte vectors with a fixed channel group per thread (`plan_bias_silu`);
otherwise a scalar grid-stride loop (`bias_silu_kernel`) runs, with bias
index `i % C`. The wrapper picks the kernel. Most serving calls are small,
so a launch's fixed latency, not the bytes, sets their time. Unlike the
TPU kernel it has no lane rule: it takes every C, and it keeps the bias in
f32 (the TPU kernel rounded it to y's type first).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._build import check, kernels

UNROLL = 4  # 16-byte loads a thread of the vector kernel starts at once

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0


def bias_silu_plain(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: silu(y + b) in f32, stored in y's type."""
    return F.silu(y.float() + b.float()).to(y.dtype)


@dataclass(frozen=True)
class BiasSiluPlan:
    """`vec`: the vector kernel, over `nvec` 16-byte vectors of `groups` =
    C / width channel groups a row; `stride`: the threads that work (a
    multiple of `groups` for the vector kernel)."""
    vec: bool
    nvec: int
    groups: int
    stride: int


@functools.lru_cache(maxsize=4096)
def plan_bias_silu(n: int, c: int, elem_size: int, aligned: bool,
                   wave_threads: int) -> BiasSiluPlan:
    """Thread layout of one call over n elements with c channels (cached:
    the serving step repeats its shapes, and the step is host-bound).

    Vector kernel: thread t takes vectors t, t + stride, ... (UNROLL at a
    time). With `stride` a multiple of the channel groups, vector v and
    v + stride hold the same channels, so a thread loads its biases once.
    `stride` is the buffer's vector count (one vector a thread) or one
    resident wave of the card (`wave_threads`, rounded down to a multiple
    of the groups), whichever is smaller. The scalar kernel takes
    min(n, wave_threads) threads."""
    width = 16 // elem_size
    if c % width or not aligned:
        return BiasSiluPlan(False, 0, 0, max(1, min(n, wave_threads)))
    nvec, groups = n // width, c // width
    return BiasSiluPlan(True, nvec, groups,
                        max(groups, min(nvec, wave_threads // groups * groups)))


@functools.cache
def _wave_threads(index: int, dtype_code: int) -> int:
    """Threads of one resident wave of the vector kernel on card `index`."""
    with torch.cuda.device(index):
        threads = kernels().lib.zlt_bias_silu_wave_threads(dtype_code)
    if threads < 1:
        raise RuntimeError("bias_silu: occupancy query failed")
    return threads


def bias_silu(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(y + b) over y (..., C) contiguous and b (C,) f32. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel."""
    if not y.is_cuda:
        if y.device.type == "cpu":
            return bias_silu_plain(y, b)
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
    n = y.numel()
    if n >= 2 ** 31:
        raise ValueError(f"bias_silu: {n} elements exceed 32-bit offsets")
    out = torch.empty_like(y)
    code, index = _DTYPES[y.dtype], y.get_device()
    plan = plan_bias_silu(n, y.shape[-1], y.element_size(),
                          y.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                          _wave_threads(index, code))
    lib = kernels().lib
    with torch.cuda.device(index):
        err = lib.zlt_bias_silu(
            y.data_ptr(), b.data_ptr(), out.data_ptr(), n, y.shape[-1], code,
            int(plan.vec), plan.stride,
            torch.cuda.current_stream(index).cuda_stream)
    check(err, "bias_silu")
    global launches
    launches += 1
    return out
