"""The port's CUDA kernels against their plain PyTorch versions on the card:
at the serving step's own shapes (yolov8n, 416 px, batch 8) and at edge
shapes it does not reach (ragged tiles, K below a block, C not a multiple
of the vector width, misaligned buffers), on both routes of the 1x1 GEMM;
the NMS kernel exactly, on its edge cases too. Also the engine on the card:
dispatch returns before the device has run the step, the step's full f32
switch holds under PyTorch's default TF32 settings, a pending batch's CUDA
event says whether the step and its result's copy are done, complete()
reads the pinned copy without another one, and two batches in flight
through the ContinuousBatcher both complete, in order. The device frame
cache on the card: dispatch_from_cache returns before the device is done, a
flush makes no synchronizing call, the cached step equals the hosted one,
and a write flushed after a dispatch does not reach that dispatch's frames.
The serve-size ladder's paths: both kernels at the distinct shapes of
yolov8s at 640 (batch 16) and of yolov8n's split C2f at 416 (batch 32), NMS
at K = 128, and an adaptive downshift on the card whose results equal an
engine of the lower rung's model size. The int8 conv kernel at every int8
conv shape of yolov8n's int8 step at 416: int32 accumulators equal to the
plain version's and outputs within one ulp, on exact rounding ties, with a
dynamic device scale and without SiLU; a failed build or launch raises;
the int8 step's dispatch returns before the device is done. Training on
the card: bf16 and f32 steps (finite, the loss falls, f32 equal to the CPU
step), the gradient on every leaf (BN mean and var included), evaluate
with the kernels against the plain versions, and a checkpoint round trip
(on the card and onto the CPU, the resumed step bit-equal). The serving
mesh on the card: virtual meshes (2x1, 1x2, 2x2) over cuda:0 against the
single-device engine, hosted and cached; both kernels against their plain
versions at every channel-sharded shape of yolov8n at 416 and yolov8s at
640; dispatch on a mesh returns before the device is done; and a real
two-card mesh, which skips on fewer than two cards. The training mesh on
the card: the meshed step on virtual meshes over cuda:0 against the
single-device step, and on a real two-card 2x1 mesh (skips on fewer than
two cards).

Needs an NVIDIA GPU and nvcc: marked `cuda` and skipped elsewhere. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed: `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_nms_cases  # noqa: E402
from chip_smoke import CONV3X3_ATOL, CONV3X3_ULP, ulp_distance  # noqa: E402
from test_torch_serving_shapes import (  # noqa: E402
    INT8_N416_CONV_B1, N416_CONV3X3, S640_BIAS_SILU_B1, S640_CONV1X1_B1,
    S640_CONV3X3, SERVING_BIAS_SILU_B8, SERVING_CONV1X1_B8,
    SPLIT_N416_BIAS_SILU_B1, SPLIT_N416_CONV1X1_B1)
from zero_latency_yolo_tpu_torch.ops import (  # noqa: E402
    _build, act_cuda, conv1x1_cuda, conv3x3_cuda, conv_int8_cuda, nms_cuda)

pytestmark = pytest.mark.cuda

# bf16 tolerance of both 1x1 routes against the plain version: another
# summation order may move the one rounding to bf16 by one ulp.
BF16_MM_TOL = dict(atol=1e-2, rtol=2.0 ** -7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_nms(dev, boxes, classes, valid, thr=torch_nms_cases.THRESH):
    """The kernel's keep mask equals the plain version's, bit for bit, in
    one launch."""
    boxes, classes, valid = (torch.from_numpy(a).to(dev)
                             for a in (boxes, classes, valid))
    n0 = nms_cuda.launches
    got = nms_cuda.nms_keep(boxes, classes, valid, thr)
    torch.cuda.synchronize()
    assert nms_cuda.launches == n0 + 1
    assert got.dtype == torch.bool and got.shape == valid.shape
    want = nms_cuda.nms_keep_plain(boxes, classes, valid, thr)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("b,k", [(1, 1), (3, 37), (8, 256), (2, 1024),
                                 (128, 256)])
def test_nms_kernel_exact(dev, b, k):
    keep = _check_nms(dev, *torch_nms_cases.seeded(k + b, b, k))
    assert 0 < int(keep.sum()) or k == 1


@pytest.mark.parametrize("name", sorted(torch_nms_cases.edge_cases()))
def test_nms_kernel_edge_cases(dev, name):
    _check_nms(dev, *torch_nms_cases.edge_cases()[name])


@pytest.mark.parametrize("thr", [0.0, 0.45, 0.7, 1.0])
def test_nms_kernel_thresholds(dev, thr):
    _check_nms(dev, *torch_nms_cases.seeded(7, 8, 256, valid_frac=0.9), thr=thr)


def test_nms_plan_is_the_kernel_layout(dev):
    lib = _build.kernels().lib
    for k in range(1, nms_cuda.MAX_K + 1):
        assert nms_cuda.plan_nms_keep(k).smem == lib.zlt_nms_keep_smem_bytes(k)


@pytest.mark.parametrize("layout", ["row-major", "k-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,cin,cout,act", [(1, 1, 1, True), (169, 64, 4, False),
                                            (1000, 48, 96, True),
                                            (4097, 512, 256, True)])
def test_conv1x1_kernel(dev, dtype, m, cin, cout, act, layout):
    """Either layout of w, on the route the plan picks for it (row-major and
    f32 on the CUDA cores; bf16 K-major with Cin % 8 == 0 on the tensor
    cores)."""
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, cin, generator=g).to(dev, dtype)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(dev, dtype)
    if layout == "k-major":
        w = conv1x1_cuda.k_major(w)
    b = torch.randn(cout, generator=g).to(dev)
    got = conv1x1_cuda.conv1x1_bias_act(x, w, b, act=act).float()
    want = conv1x1_cuda.conv1x1_bias_act_plain(x, w, b, act=act).float()
    # f32: another summation order; bf16: that order's rounding may move
    # the one rounding to bf16 by one ulp.
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(
        atol=1e-2, rtol=2.0 ** -7)
    torch.testing.assert_close(got, want, **tol)


def _mm_inputs(dev, m, cin, cout, seed):
    """bf16 x (M, Cin), w (Cin, Cout) laid out K-major, f32 b."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, cin, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(dev, torch.bfloat16)
    return x, conv1x1_cuda.k_major(w), torch.randn(cout, generator=g).to(dev)


def _check_wgmma(x, w, b, act):
    assert conv1x1_cuda.conv1x1_plan(x, w).route == "wgmma"
    n0 = conv1x1_cuda.launches_by_route["wgmma"]
    got = conv1x1_cuda.conv1x1_bias_act(x, w, b, act=act)
    torch.cuda.synchronize()
    assert conv1x1_cuda.launches_by_route["wgmma"] == n0 + 1
    want = conv1x1_cuda.conv1x1_bias_act_plain(x, w, b, act=act)
    torch.testing.assert_close(got.float(), want.float(), **BF16_MM_TOL)


@pytest.mark.parametrize("m,cin,cout,act", SERVING_CONV1X1_B8,
                         ids=lambda v: str(v))
def test_conv1x1_tensor_cores_serving_shapes(dev, m, cin, cout, act):
    _check_wgmma(*_mm_inputs(dev, m, cin, cout, seed=m + cin + cout), act)


# The distinct 1x1 calls of the ladder's paths at their batch bucket.
LADDER_CONV1X1 = sorted({(m * 16, cin, cout, act)
                         for m, cin, cout, act in S640_CONV1X1_B1}
                        | {(m * 32, cin, cout, act)
                           for m, cin, cout, act in SPLIT_N416_CONV1X1_B1})
LADDER_BIAS_SILU = sorted({(16,) + s[1:] for s in S640_BIAS_SILU_B1}
                          | {(32,) + s[1:] for s in SPLIT_N416_BIAS_SILU_B1})


@pytest.mark.parametrize("m,cin,cout,act", LADDER_CONV1X1,
                         ids=lambda v: str(v))
def test_conv1x1_tensor_cores_ladder_shapes(dev, m, cin, cout, act):
    _check_wgmma(*_mm_inputs(dev, m, cin, cout, seed=m + cin + cout), act)


@pytest.mark.parametrize("shape", LADDER_BIAS_SILU, ids=lambda s: str(s))
def test_bias_silu_ladder_shapes(dev, shape):
    g = torch.Generator().manual_seed(shape[1] * shape[-1])
    y = (torch.randn(shape, generator=g) * 4).to(dev, torch.bfloat16)
    b = torch.randn(shape[-1], generator=g).to(dev)
    n0 = act_cuda.launches
    got = act_cuda.bias_silu(y, b)
    torch.cuda.synchronize()
    assert act_cuda.launches == n0 + 1
    torch.testing.assert_close(got.float(),
                               act_cuda.bias_silu_plain(y, b).float(),
                               atol=1e-5, rtol=2.0 ** -7)


@pytest.mark.parametrize("b", [1, 16, 32])
def test_nms_kernel_exact_at_k128(dev, b):
    _check_nms(dev, *torch_nms_cases.seeded(128 + b, b, 128))


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("cin", [48, 96])
@pytest.mark.parametrize("cout", [4, 8])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 1352, 86528])
def test_conv1x1_tensor_cores_edges(dev, m, cout, cin, act):
    """Ragged M against the 64-row tile, K tails against the 64-deep K
    tile (48, 96), Cout below and at the n8 tile; M = 86528 walks many
    tiles a block, so a stale mbarrier phase would show there."""
    _check_wgmma(*_mm_inputs(dev, m, cin, cout, seed=m * cin + cout), act)


def test_conv1x1_misaligned_view_runs_on_cuda_cores(dev):
    x, w, b = _mm_inputs(dev, 1000, 64, 32, seed=5)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xv = flat[1:].view_as(x)
    xv.copy_(x)
    assert conv1x1_cuda.conv1x1_plan(xv, w).route == "simt"
    n0 = dict(conv1x1_cuda.launches_by_route)
    got = conv1x1_cuda.conv1x1_bias_act(xv, w, b)
    torch.cuda.synchronize()
    assert conv1x1_cuda.launches_by_route == {**n0, "simt": n0["simt"] + 1}
    want = conv1x1_cuda.conv1x1_bias_act_plain(x, w, b)
    torch.testing.assert_close(got.float(), want.float(), **BF16_MM_TOL)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        conv1x1_cuda.conv1x1_bias_act(xv, w, b, route="wgmma")


def test_conv1x1_tensor_cores_need_the_k_major_copy(dev):
    """A row-major w runs on the CUDA cores, and forcing the tensor cores
    onto it raises."""
    x, w, b = _mm_inputs(dev, 64, 64, 32, seed=6)
    w_row = w.contiguous()
    assert conv1x1_cuda.conv1x1_plan(x, w_row).route == "simt"
    n0 = dict(conv1x1_cuda.launches_by_route)
    got = conv1x1_cuda.conv1x1_bias_act(x, w_row, b)
    torch.cuda.synchronize()
    assert conv1x1_cuda.launches_by_route == {**n0, "simt": n0["simt"] + 1}
    torch.testing.assert_close(
        got.float(), conv1x1_cuda.conv1x1_bias_act_plain(x, w, b).float(),
        **BF16_MM_TOL)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        conv1x1_cuda.conv1x1_bias_act(x, w_row, b, route="wgmma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((1, 1, 1, 1), 0), ((2, 5, 7, 24), 0),
                                          ((3, 9, 9, 12), 0), ((2, 13, 13, 64), 1),
                                          ((1, 208, 208, 16), 0)])
def test_bias_silu_kernel(dev, dtype, shape, offset):
    g = torch.Generator().manual_seed(shape[-1])
    n = torch.Size(shape).numel()
    # offset=1 starts the buffer one element into an allocation: misaligned
    # for 16-byte vectors, so the scalar loop runs.
    y = (torch.randn(n + offset, generator=g) * 4).to(dev, dtype)[offset:]
    y = y.view(shape)
    b = torch.randn(shape[-1], generator=g).to(dev)
    got = act_cuda.bias_silu(y, b)
    assert got.dtype == dtype
    got = got.float()
    want = act_cuda.bias_silu_plain(y, b).float()
    # Same f32 formula; exp may differ in the last f32 bit, which can move
    # the one rounding to bf16 by one ulp.
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(
        atol=1e-5, rtol=2.0 ** -7)
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SERVING_BIAS_SILU_B8, ids=lambda s: str(s))
def test_bias_silu_serving_shapes(dev, shape, dtype):
    g = torch.Generator().manual_seed(shape[1] * shape[-1])
    y = (torch.randn(shape, generator=g) * 4).to(dev, dtype)
    b = torch.randn(shape[-1], generator=g).to(dev)
    n0 = act_cuda.launches
    got = act_cuda.bias_silu(y, b)
    torch.cuda.synchronize()
    assert act_cuda.launches == n0 + 1
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(
        atol=1e-5, rtol=2.0 ** -7)
    torch.testing.assert_close(got.float(), act_cuda.bias_silu_plain(y, b).float(),
                               **tol)


def _conv3x3_inputs(dev, n, h, w, cin, ldx, cout, seed=0):
    """x (n, h, w, cin) bf16, a channel slice of a (.., ldx) tensor when ldx
    > cin (as a C2f's y[..., c:]); an OIHW weight in channels-last memory
    (the K-major matrix place_params lays out); an f32 bias."""
    g = torch.Generator().manual_seed(seed + h * 7 + cin * 13 + cout)
    full = torch.randn(n, h, w, ldx, generator=g).to(dev, torch.bfloat16)
    x = full[..., ldx - cin:]
    wt = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin ** 0.5)).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return x, wt, torch.randn(cout, generator=g).to(dev)


def _check_conv3x3(x, w, b, stride, tiles=()):
    """One launch; within CONV3X3_ULP bf16 ulps of the plain version, or
    CONV3X3_ATOL where a cancelling sum leaves a value near 0 (the same f32
    sums in another order, SiLU with the hardware's exp2 and reciprocal,
    one rounding each)."""
    n0 = conv3x3_cuda.launches
    got = conv3x3_cuda.conv3x3_bias_act(x, w, b, stride, tiles=tiles)
    torch.cuda.synchronize()
    assert conv3x3_cuda.launches == n0 + 1
    want = conv3x3_cuda.conv3x3_bias_act_plain(x, w, b, stride)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous() and bool(torch.isfinite(got.float()).all())
    far = (got.float() - want.float()).abs() > CONV3X3_ATOL
    ulps = torch.where(far, ulp_distance(torch, got, want), 0)
    assert int(ulps.max()) <= CONV3X3_ULP


@pytest.mark.parametrize("batch,shape", [(8, s) for s in N416_CONV3X3]
                         + [(16, s) for s in S640_CONV3X3],
                         ids=lambda v: str(v))
def test_conv3x3_serving_shapes(dev, batch, shape):
    """Every k=3 call of the yolov8n 416 b8 and yolov8s 640 b16 bf16 steps
    on the k=3 kernel."""
    h, w, cin, ldx, cout, stride = shape
    x, wt, b = _conv3x3_inputs(dev, batch, h, w, cin, ldx, cout)
    assert conv3x3_cuda.conv3x3_plan(x, wt, stride).route == "wgmma"
    _check_conv3x3(x, wt, b, stride)


@pytest.mark.parametrize("n,h,w,cin,ldx,cout,stride", [
    (1, 7, 9, 16, 16, 16, 1),     # M 63: one ragged row tile
    (1, 5, 13, 16, 16, 24, 1),    # M 65; Cout 24 in a 32 tile
    (3, 13, 11, 32, 64, 40, 2),   # odd sizes at stride 2; a channel slice
    (2, 5, 5, 8, 8, 8, 1),        # Cin 8: eight taps a K tile
    (2, 9, 9, 16, 16, 4, 1),      # Cout 4 (a 1x4 mesh shard) in an 8 tile
    (3, 9, 15, 64, 64, 200, 2),   # Cout 200: two N tiles, the last ragged
    (1, 3, 3, 256, 512, 136, 1),  # M 9, K 2304, Cout 136
    (2, 26, 26, 512, 512, 72, 2)], ids=lambda v: str(v))
def test_conv3x3_edges(dev, n, h, w, cin, ldx, cout, stride):
    x, wt, b = _conv3x3_inputs(dev, n, h, w, cin, ldx, cout)
    _check_conv3x3(x, wt, b, stride)


@pytest.mark.parametrize("tile", sorted(conv3x3_cuda.TILES),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_conv3x3_every_built_tile(dev, tile):
    """Each built (BM, BN) instance at a shape with ragged M and N edges."""
    x, wt, b = _conv3x3_inputs(dev, 3, 19, 23, 48, 96, 3 * tile[1] // 2 + 8)
    _check_conv3x3(x, wt, b, 1, tiles=tile)
    _check_conv3x3(x, wt, b, 2, tiles=tile)


def test_conv3x3_refuses_without_fallback(dev):
    """A CUDA call the plan does not route to the kernel raises KernelError
    and launches nothing: f32, the stem's Cin 3, a misaligned view, a
    weight not laid out K-major. Nothing falls back to F.conv2d."""
    x, wt, b = _conv3x3_inputs(dev, 2, 8, 8, 16, 16, 16)
    cases = [(x.float(), wt.float()),
             (torch.zeros(2, 8, 8, 3, device=dev, dtype=torch.bfloat16),
              torch.zeros(16, 3, 3, 3, device=dev, dtype=torch.bfloat16)
              .contiguous(memory_format=torch.channels_last)),
             (torch.zeros(2, 8, 8, 20, device=dev,
                          dtype=torch.bfloat16)[..., 4:], wt),
             (x, wt.contiguous())]
    n0 = conv3x3_cuda.launches
    for xx, ww in cases:
        assert conv3x3_cuda.conv3x3_plan(xx, ww, 1).route == "conv2d"
        with pytest.raises(_build.KernelError, match="does not take"):
            conv3x3_cuda.conv3x3_bias_act(xx, ww, b, 1)
    assert conv3x3_cuda.launches == n0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        conv1x1_cuda.conv1x1_bias_act(x, torch.zeros(8, 2, device=dev,
                                                     dtype=torch.float16),
                                      torch.zeros(2, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        conv1x1_cuda.conv1x1_bias_act(x.float(), torch.zeros(8, 4, device=dev)[:, ::2],
                                      torch.zeros(2, device=dev))
    y = torch.zeros(4, 8, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        act_cuda.bias_silu(y, torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="dtypes"):
        act_cuda.bias_silu(y.t().half(), torch.zeros(8, device=dev))
    boxes = torch.zeros(1, 1025, 4, device=dev)
    classes = torch.zeros(1, 1025, dtype=torch.int32, device=dev)
    valid = torch.ones(1, 1025, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="K in 1..1024"):
        nms_cuda.nms_keep(boxes, classes, valid, 0.5)
    for thr in (-0.1, float("nan")):
        with pytest.raises(ValueError, match="must be >= 0"):
            nms_cuda.nms_keep(boxes[:, :4], classes[:, :4], valid[:, :4], thr)
    with pytest.raises(ValueError, match="classes int32"):
        nms_cuda.nms_keep(boxes[:, :4], classes[:, :4].long(), valid[:, :4],
                          0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_cuda.nms_keep(boxes[:, :8:2], classes[:, :4], valid[:, :4], 0.5)


def _int8_inputs(dev, h, w, cin, ldx, cout, k, batch=2, dtype=torch.bfloat16,
                 seed=0):
    """x (batch, h, w, cin), a channel slice of a (.., ldx) tensor when ldx >
    cin (as a C2f's y[..., c:]), a packed int8 weight, f32 scales and bias."""
    g = torch.Generator().manual_seed(seed + h * 7 + cin * 13 + cout + k)
    full = torch.randn(batch, h, w, ldx, generator=g).to(dev, dtype)
    x = full[..., ldx - cin:]
    wq = torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                       dtype=torch.int8)
    ws = (torch.rand(cout, generator=g) * 0.02 + 1e-3).to(dev)
    b = torch.randn(cout, generator=g).to(dev)
    return x, conv_int8_cuda.pack_weight(wq).to(dev), ws, b


def _check_int8(x, x_scale, w, ws, b, k, stride, act=True):
    """Accumulators equal to the plain version's; outputs within one ulp of
    x's type (the same f32 arithmetic; exp may differ in the last bit)."""
    n0 = conv_int8_cuda.launches
    acc = conv_int8_cuda.conv_int8_acc(x, x_scale, w, k, stride)
    got = conv_int8_cuda.conv_int8(x, x_scale, w, ws, b, k, stride, act)
    torch.cuda.synchronize()
    assert conv_int8_cuda.launches == n0 + 2
    want_acc = conv_int8_cuda.conv_int8_acc_plain(x, x_scale, w, k, stride)
    assert torch.equal(acc, want_acc)
    want = conv_int8_cuda.conv_int8_plain(x, x_scale, w, ws, b, k, stride, act)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert int(ulp_distance(torch, got, want).max()) <= 1
    return acc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", INT8_N416_CONV_B1, ids=lambda s: str(s))
def test_conv_int8_serving_shapes(dev, shape, dtype):
    """Every int8 conv of yolov8n's int8 step at 416 (batch 2), a static
    scale as calibration gives one."""
    h, w, cin, ldx, cout, k, stride = shape
    x, wq, ws, b = _int8_inputs(dev, h, w, cin, ldx, cout, k, dtype=dtype)
    x_scale = torch.tensor(float(x.abs().amax()) * 1.1 / 127.0, device=dev)
    acc = _check_int8(x, x_scale, wq, ws, b, k, stride)
    assert int(acc.abs().max()) > 0


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,cin,ldx,cout,k,stride", [
    (1, 1, 16, 16, 1, 1, 1), (7, 5, 16, 16, 70, 3, 2), (9, 11, 24, 40, 24, 3, 1),
    (65, 3, 8, 8, 8, 3, 1), (13, 13, 12, 12, 9, 3, 2), (4, 4, 20, 36, 130, 1, 1)])
def test_conv_int8_edges(dev, h, w, cin, ldx, cout, k, stride, dtype, act):
    """Ragged M and N tiles, K below one step, Cin off the 8-channel runs
    (the scalar gather), a sliced input, a dynamic scale computed on the
    device, and no SiLU."""
    x, wq, ws, b = _int8_inputs(dev, h, w, cin, ldx, cout, k, dtype=dtype)
    _check_int8(x, conv_int8_cuda.dynamic_scale(x), wq, ws, b, k, stride,
                act)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_int8_rounds_ties_to_even(dev, dtype):
    """Activations on exact half steps (x / x_scale = n + 0.5) quantize to
    the even neighbour, as jnp.round: with a 1x1 identity weight the
    accumulator is the quantized value itself."""
    vals = torch.tensor([0.5, 1.5, 2.5, -2.5, -3.5, 126.5, -126.5, 127.5,
                         200.0, -0.5], dtype=dtype, device=dev)
    cin = 16
    x = torch.zeros(1, 1, len(vals), cin, dtype=dtype, device=dev)
    x[0, 0, :, 0] = vals
    eye = torch.zeros(cin, 1, 1, cin, dtype=torch.int8)
    eye[:, 0, 0] = torch.eye(cin, dtype=torch.int8)
    w = conv_int8_cuda.pack_weight(eye).to(dev)
    acc = conv_int8_cuda.conv_int8_acc(x, torch.tensor(1.0, device=dev), w,
                                       1, 1)
    assert acc[0, 0, :, 0].tolist() == [0, 2, 2, -2, -4, 126, -126, 127,
                                        127, 0]
    ones = torch.ones(cin, device=dev)
    _check_int8(x, torch.tensor(1.0, device=dev), w, ones, ones * 0, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_scale", [1e-6 * 1.1 / 127, 7.9e-11, 0.0173474,
                                     0.5, 3.7])
def test_conv_int8_quantize_is_the_correctly_rounded_quotient(dev, dtype,
                                                              x_scale):
    """The kernel's quantize (a reciprocal with two FMA corrections) gives
    round(x / x_scale) of the IEEE quotient: values on and one f32 step
    either side of every half step in range, far beyond the clip (where
    the quotient overflows f32 too, and infinities), far under one half
    (denormals included) and zeros, through a 1x1 identity weight (the
    accumulator is the quantized value)."""
    cin = 16
    xs = torch.tensor(x_scale, dtype=torch.float32)
    half = (torch.arange(-140, 141, dtype=torch.float32) + 0.5) * xs
    g = torch.Generator().manual_seed(3)
    vals = torch.cat([
        half, torch.nextafter(half, torch.tensor(float("inf"))),
        torch.nextafter(half, torch.tensor(-float("inf"))),
        (torch.rand(4096, generator=g) * 2 - 1) * 300 * xs,
        (torch.rand(1024, generator=g) * 2 - 1) * 1e-30,
        torch.tensor([0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38,
                      float("inf"), -float("inf")])])
    vals = torch.cat([vals, torch.zeros(-len(vals) % cin)]).to(dtype)
    x = vals.reshape(-1, 1, 1, cin).to(dev)
    eye = torch.eye(cin, dtype=torch.int8).reshape(cin, 1, 1, cin)
    w = conv_int8_cuda.pack_weight(eye).to(dev)
    ones = torch.ones(cin, device=dev)
    acc = _check_int8(x, xs.to(dev), w, ones, ones * 0, 1, 1)
    want = torch.clamp(torch.round(x.float() / xs.to(dev)), -127, 127)
    assert torch.equal(acc.float(), want)


def test_conv_int8_launch_and_build_failures_raise(dev, tmp_path, monkeypatch):
    """A launch the kernel refuses raises KernelError from the wrapper
    (nothing falls back to the plain version); so does a source nvcc
    cannot build."""
    x, _, ws, b = _int8_inputs(dev, 8, 8, 16, 16, 16, 3)
    # K padded to 150, not a multiple of the MMA's K step: the wrapper's
    # checks pass (its padded_k agrees), the kernel's entry refuses.
    monkeypatch.setattr(conv_int8_cuda, "padded_k", lambda k, cin: 150)
    w150 = torch.zeros(16, 150, dtype=torch.int8, device=dev)
    n0 = conv_int8_cuda.launches
    with pytest.raises(_build.KernelError, match="conv_int8: CUDA error"):
        conv_int8_cuda.conv_int8(x, torch.tensor(1.0, device=dev), w150, ws,
                                 b, 3, 1)
    assert conv_int8_cuda.launches == n0
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelError, match="nvcc failed"):
        _build.build()


def _small_engine(dtype: str, batch_buckets=(2,), **tpu):
    """yolov8p at 64 px with NumPy-initialised weights on the card."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz", "confidence_threshold": 0.5,
        "nms_threshold": 0.45,
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": dtype,
                "batch_buckets": list(batch_buckets),
                "frame_buckets": [[96, 128]],
                "pre_nms_topk": 64, **tpu}})
    return InferenceEngine(cfg, params=ym.init_params(0, ym.get_spec(
        "yolov8p", 4)), device="cuda")


def test_dispatch_returns_before_the_device_is_done(dev):
    """A spin of the GPU queued before dispatch is still running when
    dispatch returns: dispatch waits neither for earlier steps nor for its
    own uploads."""
    _dispatch_returns_early(_small_engine("bfloat16"))


def test_int8_dispatch_returns_before_the_device_is_done(dev):
    """The same for the int8 step: its activation scales stay on the
    device (calibrated, and dynamic where a block has none)."""
    eng = _small_engine("bfloat16", quantize_int8=True)
    assert "x_scale" in eng._params["m1"]
    _dispatch_returns_early(eng)
    del eng._params["m2"]["cv1"]["x_scale"]  # one dynamic scale
    _dispatch_returns_early(eng)


def _dispatch_returns_early(eng):
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    rng = np.random.default_rng(0)
    reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                             width=128, height=96,
                             data=rng.integers(0, 256, (96, 128, 3),
                                               dtype=np.uint8))
            for i in range(2)]
    want = eng.complete(eng.dispatch(reqs))  # builds and warms everything
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second of the GPU's clock
    t0 = time.perf_counter()
    pending = eng.dispatch(reqs)
    host_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    got = eng.complete(pending)
    assert busy, f"dispatch returned with the stream idle ({host_s:.3f} s)"
    assert [len(r.detections) for r in got] == [len(r.detections) for r in want]


def test_f32_step_precision_holds_under_default_tf32(dev, monkeypatch):
    """With PyTorch's TF32 settings on (its cuDNN default), a conv inside
    full_f32_precision() is an f32 conv: its error against float64 is f32
    rounding; the same conv outside it may be TF32."""
    from zero_latency_yolo_tpu_torch.runtime.engine import full_f32_precision
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        monkeypatch.setattr(cudnn.conv, "fp32_precision", "tf32")
        monkeypatch.setattr(matmul, "fp32_precision", "tf32")
    else:
        monkeypatch.setattr(cudnn, "allow_tf32", True)
        monkeypatch.setattr(matmul, "allow_tf32", True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 128, 52, 52, generator=g).to(dev)
    w = torch.randn(128, 128, 3, 3, generator=g).to(dev)
    ref = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)

    def rel_err(y):
        return float((y.double() - ref).abs().max() / ref.abs().max())

    with full_f32_precision():
        strict = rel_err(torch.nn.functional.conv2d(x, w, padding=1))
    loose = rel_err(torch.nn.functional.conv2d(x, w, padding=1))
    print(f"conv rel err: full f32 {strict:.3g}, default TF32 {loose:.3g}")
    assert strict < 1e-5


def _requests(n, seed=0, first_client=1):
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    rng = np.random.default_rng(seed)
    return [InferenceRequest(client_id=first_client + i, frame_id=i,
                             timestamp=i, width=128, height=96,
                             data=rng.integers(0, 256, (96, 128, 3),
                                               dtype=np.uint8))
            for i in range(n)]


def test_pending_event_follows_the_device(dev):
    """dispatch starts the result's D2H copy into pinned memory and records
    an event behind it: not ready while a queued spin of the GPU runs,
    ready after; the batcher's _ready reads that event."""
    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    eng = _small_engine("bfloat16")
    reqs = _requests(2)
    eng.complete(eng.dispatch(reqs))  # builds and warms everything
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second of the GPU's clock
    pending = eng.dispatch(reqs)
    assert pending.is_real_device and pending.serve_size == eng.model_size
    assert pending.host is not None and pending.host.is_pinned()
    assert not pending.event.query()
    assert not ContinuousBatcher._ready(pending)
    pending.event.synchronize()
    assert ContinuousBatcher._ready(pending)
    assert len(eng.complete(pending)) == 2


def test_complete_reads_the_pinned_copy_without_another(dev, monkeypatch):
    """Once the event has fired, complete() reads the pinned buffer: the
    device output may be overwritten and Tensor.cpu() may fail, and the
    results are still those of the step."""
    eng = _small_engine("float32")
    reqs = _requests(2, seed=1)
    want = eng.complete(eng.dispatch(reqs))
    pending = eng.dispatch(reqs)
    pending.event.synchronize()
    with torch.inference_mode():
        pending.out.fill_(0.0)
    torch.cuda.synchronize()

    def no_copy(self, *a, **k):
        raise AssertionError("complete() made a second D2H copy")
    monkeypatch.setattr(torch.Tensor, "cpu", no_copy)
    got = eng.complete(pending)
    assert sum(len(r.detections) for r in want) > 0
    assert [[vars(d) for d in r.detections] for r in got] == [
        [vars(d) for d in r.detections] for r in want]


def test_two_batches_in_flight_complete_in_order(dev):
    """With the GPU held busy, the batcher dispatches a second batch while
    the first is still running (two in flight); both complete, first
    first. The second stays unready until the first has completed."""
    import threading

    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    eng = _small_engine("bfloat16")
    eng.complete(eng.dispatch(_requests(2)))
    got, depth = [], []
    cv = threading.Condition()

    def on_result(results):
        with cv:
            got.append([r.client_id for r in results])
            cv.notify()

    b = ContinuousBatcher(eng, on_result, max_batch=1, batch_window_ms=1.0,
                          max_inflight=2)
    dispatch = b._dispatch
    armed = []

    def spy(batch):
        if armed and not depth:  # this batch waits behind a spin of the GPU
            torch.cuda._sleep(int(2e9))  # about a second of its clock
        out = dispatch(batch)
        if armed:
            depth.append(len(b._inflight) + len(out))
        return out
    b._dispatch = spy
    b.start()
    try:
        # A first frame on the batcher thread: a thread's first step
        # creates its cuDNN and cuBLAS handles, which waits for the device.
        b.submit(_requests(1, seed=1, first_client=3)[0])
        with cv:
            assert cv.wait_for(lambda: got == [[3]], timeout=60)
        got.clear()
        armed.append(True)
        # One frame a batch (max_batch=1), both queued at once (under the
        # batcher's re-entrant lock): the second batch is dispatched while
        # the first still waits behind the spin, before the batcher could
        # find its queue empty and wait for the first.
        reqs = (_requests(1, seed=2, first_client=1)
                + _requests(1, seed=3, first_client=2))
        with b._cv:
            for r in reqs:
                b.submit(r)
        with cv:
            cv.wait_for(lambda: len(got) >= 2, timeout=60)
    finally:
        b.stop()
    assert depth[:2] == [1, 2], depth
    assert got == [[1], [2]]
    assert eng.error_count.value == 0


def _cached(eng, reqs, seed=0):
    """A card-resident frame cache of the engine's bucket holding each
    request's frame (flushed), and the ids of the requests."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    cache = DeviceFrameCache(8, 96, 128, device="cuda")
    for r in reqs:
        assert cache.write_keyframe(r.client_id, r.data)
    cache.run_locked(lambda c: c)
    return cache, [r.client_id for r in reqs]


def _from_cache(eng, cache, reqs, ids):
    return cache.dispatch_with(
        lambda c, s, h, w: eng.dispatch_from_cache(reqs, c, s, h, w), ids)


def _dets(results):
    return [[(d.class_id, d.x, d.y, d.width, d.height, d.confidence)
             for d in r.detections] for r in results]


def test_dispatch_from_cache_returns_before_the_device_is_done(dev):
    eng = _small_engine("bfloat16")
    reqs = _requests(2)
    cache, ids = _cached(eng, reqs)
    want = eng.complete(_from_cache(eng, cache, reqs, ids))  # warms all
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second of the GPU's clock
    t0 = time.perf_counter()
    pending = _from_cache(eng, cache, reqs, ids)
    host_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    got = eng.complete(pending)
    assert busy, (f"dispatch_from_cache returned with the stream idle "
                  f"({host_s:.3f} s)")
    assert _dets(got) == _dets(want)


def test_cache_flush_makes_no_synchronizing_call(dev):
    """Keyframes and ROI writes flushed under sync debug mode "error": any
    synchronizing call (a pageable copy, a readback) would raise. The
    gather and the cached dispatch too."""
    eng = _small_engine("bfloat16")
    reqs = _requests(2)
    cache, ids = _cached(eng, reqs)  # first buffers made outside the check
    eng.complete(_from_cache(eng, cache, reqs, ids))
    rng = np.random.default_rng(5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in reqs:
            assert cache.write_keyframe(r.client_id, r.data)
        for k in range(20):
            region = rng.integers(0, 256, (8 + k, 16, 3), dtype=np.uint8)
            assert cache.write_roi(ids[k % 2], region, k, 2 * k)
        cache.run_locked(lambda c: c)
        cache.gather(ids)
        pending = _from_cache(eng, cache, reqs, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(eng.complete(pending)) == 2


def test_cached_step_equals_hosted_step_at_batch_8(dev):
    """Eight frames served from the card's cache and from host staging, on
    the same engine, batch and bucket: equal to the last bit."""
    eng = _small_engine("bfloat16", batch_buckets=(8,))
    eng.update_thresholds(confidence=0.05)
    reqs = _requests(8, seed=4)
    cache, ids = _cached(eng, reqs)
    hosted = eng.complete(eng.dispatch(reqs))
    cached = eng.complete(_from_cache(eng, cache, reqs, ids))
    assert sum(len(r.detections) for r in hosted) > 0, "vacuous"
    assert _dets(cached) == _dets(hosted)
    # The packed outputs, bit for bit: get_step_cached against get_step.
    shw = torch.tensor([[cache.slot(i) for i in ids], [96] * 8, [128] * 8],
                       dtype=torch.int32, device="cuda")
    args = (eng._class_weights, eng.config.confidence_threshold,
            eng.config.nms_threshold)
    a = eng.get_step_cached(8, (96, 128))(eng._params, cache._cache, shw, *args)
    frames = torch.from_numpy(np.stack([r.data for r in reqs])).cuda()
    b = eng.get_step(8, (96, 128))(eng._params, frames, shw[1], shw[2], *args)
    assert torch.equal(a, b)


def test_write_after_dispatch_does_not_reach_it(dev):
    """With the stream held busy: dispatch from the cache, then write a new
    keyframe to the same slot and flush it. The dispatch serves the old
    frame (its gather is queued before the write), the next one the new."""
    eng = _small_engine("float32")
    eng.update_thresholds(confidence=0.05)
    old, new = _requests(2, seed=6), _requests(2, seed=7)
    cache, ids = _cached(eng, old)
    want_old = eng.complete(eng.dispatch(old))
    want_new = eng.complete(eng.dispatch(new))
    assert _dets(want_old) != _dets(want_new)
    eng.complete(_from_cache(eng, cache, old, ids))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))
    pending = _from_cache(eng, cache, old, ids)
    for r in new:
        assert cache.write_keyframe(r.client_id, r.data)
    cache.run_locked(lambda c: c)
    assert not torch.cuda.current_stream().query()  # all still queued
    assert _dets(eng.complete(pending)) == _dets(want_old)
    assert _dets(eng.complete(_from_cache(eng, cache, new, ids))) == _dets(
        want_new)


def test_adaptive_downshift_on_the_card(dev):
    """A yolov8p ladder (64, 32) on the card: with an SLO far below the
    step's latency the engine steps down through its own completions, and
    its results at 32 equal, to the last bit, those of an engine of model
    size 32; with the SLO far above, it steps back up."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine

    def engine(size, ladder):
        cfg = ServerConfig.from_dict({
            "model_path": "/nonexistent.npz", "confidence_threshold": 0.25,
            "detection": {"model_width": size, "model_height": size},
            "tpu": {"variant": "yolov8p", "num_classes": 4,
                    "dtype": "bfloat16", "batch_buckets": [2],
                    "frame_buckets": [[96, 128]], "pre_nms_topk": 64,
                    "serve_sizes": ladder,
                    "adaptive_slo_ms": 8.0 if ladder else 0.0}})
        return InferenceEngine(cfg, params=ym.init_params(
            0, ym.get_spec("yolov8p", 4)), device="cuda")
    eng = engine(64, [64, 32])
    eng.warmup()
    assert eng._warmed_sizes == (64, 32)
    reqs = _requests(2, seed=4)

    def drive(until):
        deadline = time.perf_counter() + 30
        while not until() and time.perf_counter() < deadline:
            for r in reqs:
                r.enqueue_t = time.perf_counter()
            eng.complete(eng.dispatch(reqs))
    assert eng.update_adaptive_slo(0.001)
    drive(lambda: eng._serve_size == 32)
    assert eng._serve_size == 32 and eng.size_downshifts == 1
    got = eng.complete(eng.dispatch(reqs))
    want = engine(32, []).infer_batch(reqs)
    assert {r.serve_size for r in got} == {32}
    assert _dets(got) == _dets(want)
    assert eng.update_adaptive_slo(1e4)
    drive(lambda: eng._serve_size == 64)
    assert eng._serve_size == 64 and eng.size_upshifts == 1


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

def _train_state(dev, ema=False, schedule="const"):
    from zero_latency_yolo_tpu_torch.models.weights import train_params_from_jax
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    from zero_latency_yolo_tpu_torch.train.optim import make_optimizer
    from zero_latency_yolo_tpu_torch.train.step import init_train_state
    spec = get_spec("yolov8p", 4)
    tx = make_optimizer(1e-3, schedule, steps=6, warmup_steps=1)
    state = init_train_state(train_params_from_jax(
        init_params(0, spec, folded=False), device=dev), tx, ema=ema)
    return spec, tx, state


def _train_batches(n, size=64, batch=4):
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    gen = synthetic_batches(batch, size, seed=0)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_train_step_on_the_card(dev, dtype):
    """Five steps of one batch on the card: every loss finite and falling,
    every leaf changed and finite; in f32 the first loss equals the same
    step's on the CPU within 1e-5 relative (full f32 on the card)."""
    from zero_latency_yolo_tpu_torch.models.weights import tree_leaves
    from zero_latency_yolo_tpu_torch.train.step import make_train_step
    spec, tx, state = _train_state(dev, ema=True)
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    step = make_train_step(spec, tx, (64, 64), dtype=dtype)
    images, targets = _train_batches(1)[0]
    losses = [float(step(state, images, targets)[1]["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for p, b in zip(tree_leaves(state.params), before):
        assert p.device.type == "cuda" and bool(torch.isfinite(p).all())
        assert not torch.equal(p.detach(), b)
    if dtype == torch.float32:
        _, cpu_tx, cpu_state = _train_state("cpu")
        cpu_step = make_train_step(spec, cpu_tx, (64, 64),
                                   dtype=torch.float32)
        want = float(cpu_step(cpu_state, images, targets)[1]["loss"])
        assert abs(losses[0] - want) <= 1e-5 * abs(want)


def test_train_gradient_reaches_every_leaf_on_the_card(dev):
    """The loss's gradient on the card is nonzero and finite on every leaf
    of the training form, BN mean and var included."""
    from zero_latency_yolo_tpu_torch.models.weights import (flatten,
                                                            train_params_to_numpy,
                                                            tree_leaves)
    from zero_latency_yolo_tpu_torch.models.yolov8 import forward_train_raw
    from zero_latency_yolo_tpu_torch.train.loss import detection_loss
    spec, _, state = _train_state(dev)
    images, targets = _train_batches(1)[0]
    leaves = tree_leaves(state.params)
    outs = forward_train_raw(state.params, spec,
                             torch.from_numpy(images).to(dev))
    loss, _ = detection_loss(spec, outs, torch.from_numpy(targets).to(dev),
                             (64, 64))
    grads = torch.autograd.grad(loss, leaves)
    names = sorted(flatten(train_params_to_numpy(state.params)))
    assert sum(n.endswith("/bn/mean") for n in names) > 0
    assert sum(n.endswith("/bn/var") for n in names) > 0
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_evaluate_with_kernels_on_the_card(dev):
    """evaluate of the deployed weights on 16 images at 416 with the kernels
    against their plain versions: in f32 the same numbers (within
    chip_smoke.EVAL_TOL), in bf16 mAP and mAP50-95 within EVAL_BF16_TOL (a
    kernel's bf16 output may round one step away from its plain version's,
    which moves a detection on a threshold); every kernel launched, the bf16
    1x1 convs on the tensor cores."""
    from pathlib import Path
    from chip_smoke import EVAL_BF16_TOL, EVAL_TOL
    from zero_latency_yolo_tpu_torch.models.weights import load_params
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec
    from zero_latency_yolo_tpu_torch.train.eval import evaluate
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    root = Path(__file__).resolve().parent.parent
    tree = load_params(str(root / "artifacts" / "yolov8n_trained_416.npz"))
    spec = get_spec("yolov8n", 4)
    images, targets = next(synthetic_batches(16, 416, seed=416))
    for dtype, tol in ((torch.bfloat16, EVAL_BF16_TOL),
                       (torch.float32, EVAL_TOL)):
        nms_cuda.launches = act_cuda.launches = conv1x1_cuda.launches = 0
        conv1x1_cuda.launches_by_route = {r: 0 for r in conv1x1_cuda.ROUTES}
        got = evaluate(tree, spec, images, targets, dtype=dtype, device="cuda")
        assert nms_cuda.launches > 0 and act_cuda.launches > 0
        assert conv1x1_cuda.launches > 0
        if dtype == torch.bfloat16:
            assert (conv1x1_cuda.launches_by_route["wgmma"]
                    == conv1x1_cuda.launches)
        want = evaluate(tree, spec, images, targets, dtype=dtype,
                        device="cuda", plain=True)
        assert got["mAP"] > 0.5 and got["num_gt"] == want["num_gt"]
        for k in ("mAP", "mAP50_95"):
            assert abs(got[k] - want[k]) <= tol, (dtype, k, got, want)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A card state after 2 steps saved and restored, on the card and on
    the CPU, leaf for leaf equal; the restored card state's next step
    equals the uninterrupted run's, bit for bit, with cuDNN deterministic."""
    from chip_smoke import deterministic
    from zero_latency_yolo_tpu_torch.models.weights import tree_leaves
    from zero_latency_yolo_tpu_torch.train.checkpoint import CheckpointManager
    from zero_latency_yolo_tpu_torch.train.step import make_train_step
    batches = _train_batches(3)
    with deterministic(torch):
        spec, tx, state = _train_state(dev, ema=True, schedule="cosine")
        step = make_train_step(spec, tx, (64, 64))
        for images, targets in batches[:2]:
            step(state, images, targets)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(state, tx)
        _, tx2, fresh = _train_state(dev, ema=True, schedule="cosine")
        back = mgr.restore(fresh, tx2)
        _, tx3, cpu_fresh = _train_state("cpu", ema=True, schedule="cosine")
        on_cpu = mgr.restore(cpu_fresh, tx3)
        for a, b, c in zip(tree_leaves(state.params), tree_leaves(back.params),
                           tree_leaves(on_cpu.params)):
            assert b.device.type == "cuda" and c.device.type == "cpu"
            assert torch.equal(a.detach(), b.detach())
            assert torch.equal(a.detach().cpu(), c.detach())
        for x, y in zip(tx.state_leaves(state.opt_state),
                        tx3.state_leaves(on_cpu.opt_state)):
            assert np.array_equal(x, y)
        step(state, *batches[2])
        make_train_step(spec, tx2, (64, 64))(back, *batches[2])
        for a, b in zip(tree_leaves(state.params) + tree_leaves(state.ema_params),
                        tree_leaves(back.params) + tree_leaves(back.ema_params)):
            assert torch.equal(a.detach(), b.detach())


# ----------------------------------------------------------- serving mesh

def _mesh_engine(monkeypatch, data, model, devices=None, dtype="float32"):
    """_small_engine at batch 8 on a (data, model) mesh: over cuda:0
    repeated (a virtual mesh) unless `devices` are given."""
    from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh
    devices = devices or [torch.device("cuda", 0)] * (data * model)
    monkeypatch.setattr(pt_mesh, "available_devices",
                        lambda device="cuda": list(devices))
    eng = _small_engine(dtype, batch_buckets=(8,), mesh_data=data,
                        mesh_model=model)
    assert eng.mesh is not None and eng.mesh.shape == {"data": data,
                                                       "model": model}
    return eng


def _close_dets(got, want, atol):
    assert [len(r) for r in got] == [len(r) for r in want]
    diff = 0.0
    for g, w in zip(got, want):
        assert [d[0] for d in g] == [d[0] for d in w]
        if g:
            diff = max(diff, float(np.abs(np.array(g)[:, 1:]
                                          - np.array(w)[:, 1:]).max()))
    print(f"largest difference against the single-device engine: {diff:.3g}")
    assert diff <= atol


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_virtual_mesh_on_the_card_matches_single_device(dev, monkeypatch,
                                                        data, model):
    """f32, hosted and from a slot-sharded cache (its slots on the other
    data row's shard): counts and classes equal to the single-device
    engine, boxes and scores within 1e-3 (cuDNN may pick another algorithm
    at a halved Cout, so the sums may differ in order)."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    single = _small_engine("float32", batch_buckets=(8,))
    single.update_thresholds(confidence=0.1)
    reqs = _requests(8, seed=6)
    want = _dets(single.infer_batch(reqs))
    assert sum(map(len, want)) > 0, "vacuous"
    eng = _mesh_engine(monkeypatch, data, model)
    eng.update_thresholds(confidence=0.1)
    eng.warmup()
    _close_dets(_dets(eng.infer_batch(_requests(8, seed=6))), want, 1e-3)
    cache = DeviceFrameCache(8, 96, 128, device="cuda", mesh=eng.mesh)
    for r in reqs:
        assert cache.write_keyframe(r.client_id, r.data)
    ids = [r.client_id for r in reqs]
    got = eng.complete(_from_cache(eng, cache, _requests(8, seed=6), ids))
    _close_dets(_dets(got), want, 1e-3)
    assert eng.error_count.value == 0


def _sharded_calls(variant, size, model):
    """The 1x1, bias+SiLU and k=3 calls of one plain bf16 forward at batch 1
    on a virtual 1 x `model` mesh over cuda:0: their inputs, at the sharded
    shapes the mesh gives each kernel."""
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    from zero_latency_yolo_tpu_torch.models.weights import params_from_jax
    from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh
    spec = ym.get_spec(variant, 4)
    mesh = pt_mesh.make_mesh(1, model, [torch.device("cuda", 0)] * model)
    row = pt_mesh.row_params(mesh, pt_mesh.shard_params(
        params_from_jax(ym.init_params(0, spec)), mesh, torch.bfloat16), 0)
    calls = {"conv1x1": [], "bias_silu": [], "conv3x3": []}
    saved = (ym.conv1x1_bias_act_plain, ym.bias_silu_plain,
             ym.conv3x3_bias_act_plain)

    def rec(name, fn):
        def f(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return f
    ym.conv1x1_bias_act_plain = rec("conv1x1", saved[0])
    ym.bias_silu_plain = rec("bias_silu", saved[1])
    ym.conv3x3_bias_act_plain = rec("conv3x3", saved[2])
    try:
        x = torch.rand(1, size, size, 3, device="cuda")
        with torch.inference_mode():
            ym.forward_decoded(row, spec, x, dtype=torch.bfloat16, plain=True,
                               conv_fn=ym.tp_conv)
    finally:
        (ym.conv1x1_bias_act_plain, ym.bias_silu_plain,
         ym.conv3x3_bias_act_plain) = saved
    return calls


@pytest.mark.parametrize("variant,size", [("yolov8n", 416), ("yolov8s", 640)])
@pytest.mark.parametrize("model", [2, 4])
def test_kernels_at_every_sharded_shape(dev, variant, size, model):
    """Each 1x1 call of the sharded forward (Cout / model, down to 8
    columns at yolov8n's narrowest C2f cv1 at model 4) on the tensor cores,
    each bias+SiLU call and each k=3 call on the k=3 kernel (Cout / model,
    down to 4 at model 4) against their plain versions, in bf16."""
    calls = _sharded_calls(variant, size, model)
    couts = set()
    for (x, w, b), kw in calls["conv1x1"]:
        act = kw.get("act", True)
        assert conv1x1_cuda.conv1x1_plan(x, w).route == "wgmma", (
            tuple(x.shape), tuple(w.shape))
        couts.add(int(w.shape[1]))
        torch.testing.assert_close(
            conv1x1_cuda.conv1x1_bias_act(x, w, b, act),
            conv1x1_cuda.conv1x1_bias_act_plain(x, w, b, act), **BF16_MM_TOL)
    for (y, b), _ in calls["bias_silu"]:
        torch.testing.assert_close(act_cuda.bias_silu(y, b),
                                   act_cuda.bias_silu_plain(y, b),
                                   atol=1e-5, rtol=2.0 ** -7)
    k3_couts = set()
    for (x, w, b, stride), _ in calls["conv3x3"]:
        assert conv3x3_cuda.conv3x3_plan(x, w, stride).route == "wgmma"
        k3_couts.add(int(w.shape[0]))
        _check_conv3x3(x, w, b, stride)
    assert len(calls["conv3x3"]) == 38 * model
    assert min(k3_couts) == (16 if variant == "yolov8n" else 32) // model
    torch.cuda.synchronize()
    print(f"{variant}@{size} model {model}: {len(calls['conv1x1'])} 1x1 "
          f"calls (Cout {sorted(couts)}), {len(calls['bias_silu'])} "
          "bias+SiLU calls")
    if variant == "yolov8n":
        assert 32 // model in couts


def test_meshed_dispatch_returns_before_the_device_is_done(dev, monkeypatch):
    """On a virtual 2x2 mesh dispatch copies each row from pinned memory
    without waiting, and the pending batch's events follow the device."""
    eng = _mesh_engine(monkeypatch, 2, 2, dtype="bfloat16")
    rng = np.random.default_rng(0)
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                             width=128, height=96,
                             data=rng.integers(0, 256, (96, 128, 3),
                                               dtype=np.uint8))
            for i in range(8)]
    want = eng.complete(eng.dispatch(reqs))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))
    t0 = time.perf_counter()
    pending = eng.dispatch(reqs)
    host_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    assert not pending.event.query()
    got = eng.complete(pending)
    assert busy, f"dispatch returned with the stream idle ({host_s:.3f} s)"
    assert pending.event.query()
    assert [len(r.detections) for r in got] == [len(r.detections)
                                                for r in want]


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_two_card_mesh_matches_single_device(dev, monkeypatch, data, model):
    """A real mesh over cuda:0 and cuda:1: each kernel launches on a device
    that is not current (the wrappers enter each tensor's device), the
    1x1 kernel opts in to its shared memory on each card, and the rows'
    copies cross the cards; results as the single-device engine's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    single = _small_engine("float32", batch_buckets=(8,))
    single.update_thresholds(confidence=0.1)
    reqs = _requests(8, seed=7)
    want = _dets(single.infer_batch(reqs))
    eng = _mesh_engine(monkeypatch, data, model,
                       devices=[torch.device("cuda", i) for i in range(2)])
    eng.update_thresholds(confidence=0.1)
    assert not eng.mesh.virtual
    _close_dets(_dets(eng.infer_batch(_requests(8, seed=7))), want, 1e-3)
    cache = DeviceFrameCache(8, 96, 128, device="cuda", mesh=eng.mesh)
    for r in reqs:
        assert cache.write_keyframe(r.client_id, r.data)
    got = eng.complete(_from_cache(eng, cache, _requests(8, seed=7),
                                   [r.client_id for r in reqs]))
    _close_dets(_dets(got), want, 1e-3)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_virtual_train_mesh_matches_single_device_on_the_card(dev, shape):
    """The meshed train step over cuda:0 repeated (f32, yolov8p at 64,
    batch 4, 3 steps of the const chain with the EMA) against the
    single-device step on the card: losses within 1e-5 of max(|x|, 1); the
    joined params and EMA, per leaf, ||mesh - single|| within
    chip_smoke.TRAIN_TOL of ||single||; every copy bit-equal. Not an
    element-wise gate: Adam's first update is close to lr * sign(g) where
    |g| is near its eps, so such elements follow the last bits of their
    gradients, which cuDNN's algorithm for a halved batch or Cout moves
    (measured on a 1x2 mesh: one element 4.2e-5 off in a leaf whose max is
    0.32), as chip_smoke.py's fixture gate says."""
    _train_mesh_vs_single(shape, [torch.device("cuda", 0)] * 2)


def test_two_card_train_mesh_matches_single_device(dev):
    """A real 2x1 training mesh over cuda:0 and cuda:1 (each row's forward
    and backward on its card, the head maps and gradients copied across
    the cards): as the single-device step, with the gates of the virtual
    mesh's test."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _train_mesh_vs_single((2, 1), [torch.device("cuda", i) for i in range(2)])


def _train_mesh_vs_single(shape, devices):
    from chip_smoke import TRAIN_TOL, copies_differ
    from zero_latency_yolo_tpu_torch.models.weights import (
        train_params_from_jax, tree_leaves)
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh
    from zero_latency_yolo_tpu_torch.train.loop import synthetic_batches
    from zero_latency_yolo_tpu_torch.train.optim import make_optimizer
    from zero_latency_yolo_tpu_torch.train.step import (init_train_state,
                                                         make_train_step)
    spec = get_spec("yolov8p", 4)
    gen = synthetic_batches(4, 64, seed=0)
    batches = [next(gen) for _ in range(3)]
    runs = []
    for mesh in (None, pt_mesh.make_mesh(*shape, devices)):
        tx = make_optimizer(1e-3)
        fn = make_train_step(spec, tx, (64, 64), dtype=torch.float32,
                             mesh=mesh)
        state = fn.shard_state(init_train_state(train_params_from_jax(
            init_params(0, spec, folded=False), device="cuda:0"), tx,
            ema=True))
        losses = []
        for images, targets in batches:
            state, m = fn(state, images, targets)
            losses.append(float(m["loss"]))
        if mesh is not None:
            assert copies_differ(torch, state)[0] == 0
            state = pt_mesh.join_state(state)
        runs.append((losses, [p.detach().cpu().numpy() for p in
                              tree_leaves(state.params)
                              + tree_leaves(state.ema_params)]))
    (want_l, want), (got_l, got) = runs
    for a, b in zip(got_l, want_l):
        assert abs(a - b) <= 1e-5 * max(abs(b), 1.0), (got_l, want_l)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert np.linalg.norm(a - b) <= TRAIN_TOL * np.linalg.norm(b), i


# ---------------------------------------------------------------------------
# The operator tools on the card
# ---------------------------------------------------------------------------

def _tool_tree(seed):
    """A yolov8p tree, every leaf perturbed (no two initializers equal) and
    the class scores spread over (0, 1)."""
    from zero_latency_yolo_tpu_torch.models.weights import flatten, unflatten
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    rng = np.random.default_rng(seed)
    tree = unflatten({k: np.asarray(v, np.float32)
                      + rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
                      for k, v in flatten(init_params(
                          seed, get_spec("yolov8p", 4))).items()})
    for i, lvl in enumerate(tree["m22"]["cv3"]):
        lvl[2]["w"] = lvl[2]["w"] * 8.0
        lvl[2]["b"] = np.linspace(-2, 2, 4).astype(np.float32) + 0.01 * i
    return tree


def test_detect_on_the_card_matches_the_cpu(dev, tmp_path):
    """`detect` on the card launches the f32 step's kernels (the 1x1 on its
    CUDA-core route, bias+SiLU, NMS once a batch) and prints the lines of
    its `--device cpu` run: counts and classes equal, confidences and boxes
    within chip_smoke.TOOLS_TOL (a detection on a threshold excused)."""
    import contextlib
    import io
    import json
    cv2 = pytest.importorskip("cv2")
    from chip_smoke import STEP_LAUNCHES, TOOLS_TOL, detect_lines_gate, \
        task_frames
    from zero_latency_yolo_tpu_torch import detect
    from zero_latency_yolo_tpu_torch.models.weights import save_params
    from zero_latency_yolo_tpu_torch.ops.launches import launch_counts
    weights = str(tmp_path / "pico.npz")
    save_params(_tool_tree(7), weights)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, f in enumerate(task_frames(5, 64, seed=71)):
        cv2.imwrite(str(imgs / f"t{i}.png"), f)
    argv = ["--weights", weights, str(imgs), "--size", "64", "--conf",
            "0.01", "--batch", "2"]

    def run(device):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert detect.main(argv + ["--device", device]) == 0
        return [json.loads(x) for x in out.getvalue().splitlines()]
    before = launch_counts()
    got = run("cuda")
    torch.cuda.synchronize()
    after = launch_counts()
    n = {k: after[k] - before[k] for k in after}
    assert {k: n[k] for k in STEP_LAUNCHES} == {
        k: v * 3 for k, v in STEP_LAUNCHES.items()}   # 5 frames, batch 2
    assert n["conv1x1_simt"] == n["conv1x1_bias_act"] and n["conv1x1_wgmma"] == 0
    want = run("cpu")
    g = detect_lines_gate(want, got, 0.01, 0.45, TOOLS_TOL, TOOLS_TOL)
    assert g["ok"], g["failed"][:4]
    assert g["detections"] > 0


def test_exported_onnx_serves_as_the_npz_on_the_card(dev, tmp_path):
    """A tree exported with the twin traced on the card reads back
    bit-identical, and an engine on the card serving the `.onnx` gives the
    `.npz` engine's packed output to the last bit."""
    from chip_smoke import synthetic_frame
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.models.ultra import export_deployment_onnx
    from zero_latency_yolo_tpu_torch.models.weights import (flatten,
                                                            from_onnx,
                                                            save_params)
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec
    from zero_latency_yolo_tpu_torch.runtime.engine import (InferenceEngine,
                                                            InferenceRequest)
    tree = _tool_tree(8)
    npz, onnx = str(tmp_path / "m.npz"), str(tmp_path / "m.onnx")
    save_params(tree, npz)
    export_deployment_onnx(tree, get_spec("yolov8p", 4), onnx, 64,
                           device="cuda")
    src, back = flatten(tree), flatten(from_onnx(onnx))
    assert set(src) == set(back)
    assert all(np.array_equal(src[k], back[k]) for k in src)
    reqs = [InferenceRequest(client_id=i + 1, frame_id=i, timestamp=i,
                             width=96, height=64,
                             data=synthetic_frame(96, 64, seed=i))
            for i in range(2)]
    outs = []
    for path in (npz, onnx):
        cfg = ServerConfig.from_dict({
            "model_path": path, "confidence_threshold": 0.01,
            "detection": {"model_width": 64, "model_height": 64},
            "tpu": {"variant": "yolov8p", "num_classes": 4,
                    "dtype": "bfloat16", "batch_buckets": [1, 2],
                    "frame_buckets": [[64, 96]]}})
        eng = InferenceEngine(cfg, device="cuda")
        assert not eng.simulation
        outs.append(eng.dispatch(reqs).out.cpu())
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0][:, 0].sum()) > 0
