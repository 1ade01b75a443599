"""The kernel wrappers' launch counts in one dict.

Each wrapper of `ops/*_cuda.py` adds one to its module's count where it
launches its kernel (never for a CPU tensor, which runs the plain
version). The server reports these counts in `/statusz` `kernel_launches`,
so a process that drives the server from outside (`loadtest.py`) can read
what its load launched."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import (act_cuda, conv1x1_cuda, conv3x3_cuda, conv_int8_cuda,
               nms_cuda)

# The device functions of each kernel, as the profiler names them: a kernel
# event whose name holds one of these is that kernel's (`chip_smoke.py`'s
# in-step times, `trace_analyze`'s rollup).
KERNEL_SYMBOLS: Dict[str, Tuple[str, ...]] = {
    "nms_keep": ("nms_keep_kernel",),
    "conv1x1_bias_act": ("conv1x1_wgmma_kernel", "mm_bias_act_kernel"),
    "bias_silu": ("bias_silu_vec_kernel", "bias_silu_kernel"),
    "conv3x3_bias_act": ("conv3x3_wgmma_kernel",),
    "conv_int8": ("conv_int8_kernel",),
}


def kernel_of(event_name: str) -> Optional[str]:
    """The port kernel a profiler event belongs to, or None."""
    for name, symbols in KERNEL_SYMBOLS.items():
        if any(sym in event_name for sym in symbols):
            return name
    return None


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the process started or the counts were
    last set to 0; `conv1x1_wgmma` and `conv1x1_simt` split
    `conv1x1_bias_act` by route."""
    by_route = conv1x1_cuda.launches_by_route
    return {"nms_keep": nms_cuda.launches,
            "conv1x1_bias_act": conv1x1_cuda.launches,
            **{f"conv1x1_{r}": by_route[r] for r in conv1x1_cuda.ROUTES},
            "bias_silu": act_cuda.launches,
            "conv3x3_bias_act": conv3x3_cuda.launches,
            "conv_int8": conv_int8_cuda.launches}
