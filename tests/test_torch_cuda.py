"""The port's CUDA kernels against their plain PyTorch versions on the card:
at the serving step's own shapes (yolov8n, 416 px, batch 8) and at edge
shapes it does not reach (ragged tiles, K below a block, C not a multiple
of the vector width, misaligned buffers), on both routes of the 1x1 GEMM.

Needs an NVIDIA GPU and nvcc: marked `cuda` and skipped elsewhere. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed: `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_serving_shapes import SERVING_BIAS_SILU_B8, SERVING_CONV1X1_B8  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda, nms_cuda  # noqa: E402
from zero_latency_yolo_tpu_torch.ops.nms import _iou_matrix_center  # noqa: E402

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


@pytest.mark.parametrize("b,k", [(1, 1), (3, 37), (8, 256), (2, 1024)])
def test_nms_kernel_exact(dev, b, k):
    g = torch.Generator().manual_seed(k)
    boxes = torch.rand(b, k, 4, generator=g) * 400
    boxes[..., 2:] = boxes[..., 2:] / 2 + 10
    classes = torch.randint(0, 3, (b, k), generator=g)
    valid = torch.rand(b, k, generator=g) > 0.2
    iou = _iou_matrix_center(boxes).to(dev)
    same = (classes[:, :, None] == classes[:, None, :]).to(dev)
    valid = valid.to(dev)
    n0 = nms_cuda.launches
    got = nms_cuda.greedy_nms_mask(iou, same, valid, 0.45)
    torch.cuda.synchronize()
    assert nms_cuda.launches == n0 + 1
    want = nms_cuda.greedy_nms_mask_plain(iou, same, valid, 0.45)
    assert torch.equal(got, want)


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
    iou = torch.zeros(1, 2000, 2000, device=dev)
    with pytest.raises(ValueError, match="outside 1..1024"):
        nms_cuda.greedy_nms_mask(iou, iou > 0,
                                 torch.ones(1, 2000, dtype=torch.bool,
                                            device=dev), 0.5)
