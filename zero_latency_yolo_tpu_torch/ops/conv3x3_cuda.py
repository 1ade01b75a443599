"""3x3 conv with its bias + SiLU fused: a CUDA kernel, the plan that routes
a call to it, the plain PyTorch version, a launch count.

The kernel (`csrc/conv3x3_sm90.cu`) redesigns the JAX package's TPU kernel
`ops/act_pallas.py` (`_bias_silu_kernel`) for the H100: the bias + SiLU pass
that followed every k=3 conv becomes the epilogue of a hand-written
implicit-GEMM conv on Hopper's tensor cores, so each k=3 conv of the bf16
step is one launch and its output goes to memory once. It computes the JAX
package's `models/yolov8.py` `_conv` at k=3: for NHWC bf16 x (B, H, W,
Cin), a folded weight and an f32 bias,

    y = bf16( silu( conv3x3(x, w, stride, pad 1) in f32 + b ) )

with one rounding at the end (the JAX package's bf16 serving path rounds
the conv's output to bf16 before its bf16 tail; see ROADMAP.md, Deliberate
differences).

The route is decided here, by shape, type and layout, before the launch
(`plan_conv3x3`): "wgmma" for bf16 with Cin and the pixel stride multiples
of 8 (16-byte copies), 16-byte-aligned x and w, w laid out K-major, stride
1 or 2 and every offset within 32 bits; "conv2d" (`F.conv2d` and the
bias+SiLU kernel of `ops/act_cuda.py`, the caller's business) for
everything else: f32, and the stem's Cin 3.

The weight needs no layout of its own: `models/weights.py` `place_params`
places every k=3 kernel OIHW in channels-last memory, whose bytes are the
K-major (Cout, 9*Cin) matrix in (ky, kx, ci) order that the kernel reads
(`is_k_major`), and a channel shard of it (`shard=`) is its own contiguous
copy of the same layout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._build import KernelError, check, kernels

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel).
launches = 0

# The kernel's tiles: BM rows (one or two warpgroups' wgmma m64) by 64 bf16
# of K (one 128-byte swizzled row); the (BM, BN) tiles it is built for,
# with the ring depth of each; the least row tiles of 128 a call needs (in
# SMs) to take them; shared memory an SM offers.
BK = 64
TILES = {(64, 8): 4, (64, 16): 4, (64, 32): 4, (64, 64): 4, (64, 128): 3,
         (128, 32): 4, (128, 64): 3}   # (BM, BN) -> stages
WIDE_M_WAVES = 4
SMEM_PER_SM = 233472       # 228 KB of the SM's 256 KB
BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class Conv3x3Plan:
    """How one call runs. Route "wgmma": tile bm x bn over K = 9 * Cin in
    steps of bk, `stages` ring slots, tiles_m x tiles_n output tiles (tile t
    covers rows (t // tiles_n) * bm, columns (t % tiles_n) * bn), `grid`
    blocks taking tiles t = block, block + grid, ...; `smem` bytes of
    dynamic shared memory a block. Route "conv2d" uses none."""
    route: str
    bm: int = 0
    bn: int = 0
    bk: int = 0
    stages: int = 0
    tiles_m: int = 0
    tiles_n: int = 0
    grid: int = 0
    smem: int = 0

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n


def out_hw(h: int, w: int, stride: int) -> tuple:
    """Output height and width of a k=3 pad-1 conv."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one block: its `Smem<bm, bn, stages>` (the
    activation and weight ring tiles, the padded bf16 staging tile of the
    epilogue, two mbarriers a stage; 1024-aligned) plus 1024 bytes to align
    the base. The kernel checks the launch against its own size."""
    raw = stages * (bm * BK + bn * BK) * 2 + bm * (bn + 8) * 2 + 16 * stages
    return -(-raw // 1024) * 1024 + 1024


@functools.lru_cache(maxsize=4096)
def plan_conv3x3(n: int, h: int, w: int, cin: int, cout: int, stride: int,
                 dtype: torch.dtype, ldx: int = 0, aligned: bool = True,
                 w_kmajor: bool = True, sms: int = 132,
                 tiles: tuple = ()) -> Conv3x3Plan:
    """The route and, for the kernel, the tiles of one call over x (n, h,
    w, cin) with pixel stride `ldx` (0: cin) (cached: the serving step
    repeats its shapes, and the step is host-bound). `tiles` = (BM, BN), a
    built tile, replaces the rule below (the card's sweep of every tile).

    The N tile is the smallest built one that holds min(Cout, 128),
    halved while the tiles do not reach the `sms` SMs, down to 64. Row
    tiles are 64 rows, or 128 (two consumer warpgroups sharing each weight
    tile) for Cout <= 64 when there are at least WIDE_M_WAVES x `sms` of
    them: the rule of the card's sweep of every built tile at the step's
    calls (PERF.md).
    There is no split K: a call stays one launch. The grid is one
    resident wave (BLOCKS_PER_SM a SM, fewer where shared memory does not
    allow) or the tile count, whichever is smaller."""
    ldx = ldx or cin
    ho, wo = out_hw(h, w, stride)
    m = n * ho * wo
    if (dtype != torch.bfloat16 or cin % 8 or ldx % 8 or ldx < cin
            or stride not in (1, 2) or not aligned or not w_kmajor
            or m == 0 or n * h * w * ldx >= 2 ** 31 or m * cout >= 2 ** 31
            or cout * 9 * cin >= 2 ** 31):
        return Conv3x3Plan("conv2d")
    bn = min(b for _, b in TILES if b >= min(cout, 128))
    while bn > 64 and -(-m // 64) * -(-cout // bn) < sms:
        bn //= 2
    bm = (128 if (128, bn) in TILES and cout <= 64
          and -(-m // 128) >= WIDE_M_WAVES * sms else 64)
    if tiles:
        if tuple(tiles) not in TILES:
            raise ValueError(f"no {tiles[0]}x{tiles[1]} tile is built")
        bm, bn = tiles
    stages = TILES[(bm, bn)]
    smem = smem_bytes(bm, bn, stages)
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    tiles_m, tiles_n = -(-m // bm), -(-cout // bn)
    return Conv3x3Plan("wgmma", bm=bm, bn=bn, bk=BK, stages=stages,
                       tiles_m=tiles_m, tiles_n=tiles_n,
                       grid=max(1, min(tiles_m * tiles_n, per_sm * sms)),
                       smem=smem)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pixel_stride(x: torch.Tensor) -> int:
    """The elements between neighbouring pixels of NHWC x whose channels
    are contiguous and pixels evenly spaced (a contiguous tensor, or a
    channel slice of one); 0 for any other layout."""
    b, h, w, c = x.shape
    sb, sh, sw, sc = x.stride()
    if (sc == 1 or c == 1) and sh == w * sw and (sb == h * sh or b == 1):
        return sw
    return 0


def is_k_major(w: torch.Tensor) -> bool:
    """Whether OIHW w lies in channels-last memory, contiguous: its bytes
    are the K-major matrix the kernel reads."""
    return w.permute(0, 2, 3, 1).is_contiguous()


def conv3x3_plan(x: torch.Tensor, w: torch.Tensor, stride: int,
                 tiles: tuple = ()) -> Conv3x3Plan:
    """plan_conv3x3 for NHWC x and OIHW w. Alignment is of their first
    elements; the SM count is the card's, 132 off the card."""
    n, h, wd, cin = x.shape
    sms = _sm_count(x.get_device()) if x.is_cuda else 132
    return plan_conv3x3(
        n, h, wd, cin, w.shape[0], stride, x.dtype, pixel_stride(x),
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
        w.shape[1:] == (cin, 3, 3) and is_k_major(w), sms, tuple(tiles))


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: `F.conv2d` (pad 1) over the values of x and w
    in f64, its sum rounded once to f32, then + b and SiLU in f32 and one
    rounding to x's type; NHWC out. A product of two bf16 values is exact
    in f64 and the f64 sum is within an f32 rounding of the exact one: the
    f32 sum the kernel's f32 accumulators approximate. An f32 `F.conv2d`
    is not that on the card, where cuDNN picks its own f32 algorithm: with
    it as the plain version, the bf16 evaluate card test
    (`test_evaluate_with_kernels_on_the_card`) put the kernels' mAP and the
    plain versions' 0.025 apart, over its 0.02 limit (PERF.md)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), stride=stride,
                 padding=1)
    return F.silu(y.permute(0, 2, 3, 1).float() + b.float()).to(
        x.dtype).contiguous()


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 1, *, tiles: tuple = ()) -> torch.Tensor:
    """silu(conv3x3(x, w, stride, pad 1) + b) over NHWC x (B, H, W, Cin)
    bf16 (contiguous or a channel slice of a contiguous tensor), OIHW w
    (Cout, Cin, 3, 3) bf16 in channels-last memory, b (Cout,) f32; returns
    NHWC (B, Ho, Wo, Cout). A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel, or raises KernelError where `conv3x3_plan`
    does not route the call to it (the caller sends such calls to
    F.conv2d; nothing falls back here). `tiles` = (BM, BN) forces a built
    tile (for the sweep that compares them on one call)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv3x3_bias_act_plain(x, w, b, stride)
        raise ValueError(f"conv3x3_bias_act: unsupported device {x.device}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise ValueError(f"conv3x3_bias_act: dtypes x={x.dtype} w={w.dtype} "
                         f"b={b.dtype} (want w in x's type; b f32)")
    if x.dim() != 4 or w.dim() != 4 or b.shape != (w.shape[0],) \
            or w.shape[1:] != (x.shape[3], 3, 3):
        raise ValueError(f"conv3x3_bias_act: shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} b={tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3_bias_act: inputs on different devices")
    if not b.is_contiguous():
        raise ValueError("conv3x3_bias_act: b must be contiguous")
    plan = conv3x3_plan(x, w, stride, tiles)
    if plan.route != "wgmma":
        raise KernelError(
            f"conv3x3_bias_act: the kernel does not take x{tuple(x.shape)} "
            f"strides {x.stride()} w{tuple(w.shape)} strides {w.stride()} "
            f"stride {stride} (plan: {plan.route})")
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = out_hw(h, wd, stride)
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib = kernels().lib
    index = x.get_device()
    with torch.cuda.device(index):
        err = lib.zlt_conv3x3_wgmma(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n, h,
            wd, cin, pixel_stride(x), cout, stride, plan.bm, plan.bn,
            plan.stages, plan.grid, plan.smem,
            torch.cuda.current_stream(index).cuda_stream)
    check(err, "conv3x3_bias_act")
    global launches
    launches += 1
    return out
