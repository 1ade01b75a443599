"""1x1 conv as a matmul with a fused bias(+SiLU) epilogue: two CUDA kernels,
the tile plan that routes between them, plain PyTorch version, launch counts.

Replaces the JAX package's TPU kernel `ops/conv1x1_pallas.py`
(`_mm_bias_silu_kernel` / `_mm_bias_kernel`, via `conv1x1_bias_act`): for an
NHWC activation viewed as x (M = B*H*W, Cin),

    y = silu(x @ w + b)        (or x @ w + b for the detect-head tips)

with f32 accumulation and the epilogue applied to the accumulator before the
one store, in x's type.

On the H100: YOLOv8n's 1x1 convs are thin (Cin 32-512, Cout 4-256), so at
the serving shapes the bytes of x and y, not the multiply-adds, set the
least time (a few tens of FLOPs per byte against the card's ~295 bf16
FLOPs per byte). Two routes, chosen here by type, shape and layout
before the launch, never on failure:

- "wgmma" (`csrc/conv1x1_sm90.cu`): bf16 with Cin a multiple of 8,
  16-byte-aligned x and w, and w laid out K-major (`k_major`: its
  (Cout, Cin) transpose contiguous, which TMA reads with 16-byte rows even
  at Cout = 4). Hopper's tensor cores fed by TMA through a ring of
  shared-memory stages, tiles fitted to the call by `plan_conv1x1`, a
  persistent grid. `models/weights.py` `place_params` lays every 1x1
  weight out K-major once, so every serving call of the bf16 step takes
  this route.
- "simt" (`csrc/kernels.cu` `mm_bias_act_kernel`): f32, and every other
  bf16 shape or layout. A shared-memory tiled GEMM on the CUDA cores that
  takes every shape (the edges of M, Cin and Cout are masked) and w in
  either layout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._build import check, kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("wgmma", "simt")

# Kernel launches since the last reset (the count a run reads to show that
# the main path went through the kernel), in all and by route.
launches = 0
launches_by_route = {r: 0 for r in ROUTES}

# The tensor-core kernel's tiles (csrc/conv1x1_sm90.cu): 64 rows (one
# warpgroup's wgmma m64) by 64 bf16 of K (one 128-byte swizzled row); N
# tiles with the ring depth each is built for; shared memory an SM offers.
BM, BK = 64, 64
N_TILES = {8: 4, 16: 4, 32: 4, 64: 4, 128: 3}   # N tile -> stages
SMEM_PER_SM = 233472       # 228 KB of the SM's 256 KB
BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class Conv1x1Plan:
    """How one call runs. For route "wgmma": tile BM x BN over K tiles of
    BK, `stages` ring slots, `tiles` = tiles_m x tiles_n output tiles (tile
    t covers rows (t // tiles_n) * BM and columns (t % tiles_n) * BN), and
    `grid` blocks that take tiles t = block, block + grid, ...; `smem`
    bytes of dynamic shared memory a block. Route "simt" uses none."""
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


def wgmma_smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel: its
    `Smem<bn, stages>` (x and w ring tiles, the padded bf16 staging tile of
    the epilogue, two mbarriers a stage; 1024-aligned) plus 1024 bytes to
    align the base. The kernel checks the launch against its own size."""
    raw = stages * (BM * BK + bn * BK) * 2 + BM * (bn + 8) * 2 + 16 * stages
    return -(-raw // 1024) * 1024 + 1024


@functools.lru_cache(maxsize=4096)
def plan_conv1x1(m: int, cin: int, cout: int, dtype: torch.dtype,
                 aligned: bool = True, w_kmajor: bool = True,
                 sms: int = 132) -> Conv1x1Plan:
    """The route and, for the tensor cores, the tiles of one call (cached:
    the serving step repeats its shapes, and the step is host-bound).

    bf16 with Cin % 8 == 0 (TMA needs 16-byte row strides), aligned
    buffers and w laid out K-major goes to "wgmma", everything else to
    "simt". The N tile is the smallest built one that holds min(Cout, 128);
    while the tiles do not reach the `sms` SMs it is halved, down to 32.
    The grid is one resident wave (BLOCKS_PER_SM a SM, fewer where shared
    memory does not allow) or the tile count, whichever is smaller."""
    if dtype != torch.bfloat16 or cin % 8 != 0 or not aligned \
            or not w_kmajor:
        return Conv1x1Plan("simt")
    bn = next(b for b in N_TILES if b >= min(cout, 128))
    tiles_m = -(-m // BM)
    while bn > 32 and tiles_m * -(-cout // bn) < sms:
        bn //= 2
    stages = N_TILES[bn]
    smem = wgmma_smem_bytes(bn, stages)
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    tiles_n = -(-cout // bn)
    return Conv1x1Plan("wgmma", bm=BM, bn=bn, bk=BK, stages=stages,
                       tiles_m=tiles_m, tiles_n=tiles_n,
                       grid=max(1, min(tiles_m * tiles_n, per_sm * sms)),
                       smem=smem)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w (Cin, Cout) with the same values, laid out K-major: a view of its
    contiguous (Cout, Cin) transpose, the layout the tensor-core route
    reads."""
    return w.t().contiguous().t()


def conv1x1_plan(x: torch.Tensor, w: torch.Tensor) -> Conv1x1Plan:
    """plan_conv1x1 for x (M, Cin) and w (Cin, Cout). Alignment is of their
    first elements (a view may start inside an allocation); the SM count
    is the card's, 132 off the card."""
    m, cin = x.shape
    sms = _sm_count(x.get_device()) if x.is_cuda else 132
    return plan_conv1x1(m, cin, w.shape[1], x.dtype,
                        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                        w.stride() == (1, cin), sms)


def conv1x1_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           act: bool = True) -> torch.Tensor:
    """Plain PyTorch version: f32 matmul + bias (+ SiLU), stored in x's type."""
    z = torch.addmm(b.float(), x.float(), w.float())
    if act:
        z = F.silu(z)
    return z.to(x.dtype)


def conv1x1_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: bool = True, *, route: str | None = None
                     ) -> torch.Tensor:
    """silu(x @ w + b) (or x @ w + b with act=False) over x (M, Cin)
    contiguous, w (Cin, Cout) in x's type, row-major or K-major
    (`k_major`), and b (Cout,) f32. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel of the route that `conv1x1_plan` picks.
    `route="simt"` forces the CUDA-core kernel (for comparing the two on
    one call); `route="wgmma"` raises where the plan does not pick it."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return conv1x1_bias_act_plain(x, w, b, act=act)
        raise ValueError(f"conv1x1_bias_act: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != torch.float32:
        raise ValueError(f"conv1x1_bias_act: dtypes x={x.dtype} w={w.dtype} "
                         f"b={b.dtype} (want x, w both f32 or bf16; b f32)")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1 or w.shape[0] != x.shape[1] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"conv1x1_bias_act: shapes x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} b={tuple(b.shape)}")
    w_kmajor = w.stride() == (1, w.shape[0])
    if not (x.is_contiguous() and b.is_contiguous()
            and (w_kmajor or w.is_contiguous())):
        raise ValueError("conv1x1_bias_act: inputs must be contiguous (w "
                         "row-major or K-major)")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv1x1_bias_act: inputs on different devices")
    m, cin = x.shape
    cout = w.shape[1]
    if m >= 2 ** 31 or cin * cout >= 2 ** 31:
        raise ValueError("conv1x1_bias_act: shape exceeds 32-bit indexing")
    plan = conv1x1_plan(x, w)
    if route is None:
        route = plan.route
    elif route not in ROUTES or (route == "wgmma" and plan.route != "wgmma"):
        raise ValueError(f"conv1x1_bias_act: route {route!r} does not take "
                         f"{x.dtype} x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"strides {w.stride()} (plan: {plan.route})")
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    lib = kernels().lib
    index = x.get_device()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        if route == "wgmma":
            err = lib.zlt_conv1x1_wgmma(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                cin, cout, int(act), plan.bn, plan.stages, plan.grid,
                plan.smem, stream)
        else:
            err = lib.zlt_conv1x1_bias_act(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m,
                cin, cout, int(act), _DTYPES[x.dtype], int(w_kmajor), stream)
    check(err, f"conv1x1_bias_act ({route})")
    global launches
    launches += 1
    launches_by_route[route] += 1
    return out
