"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path does not reach (ragged tiles, K below a
block, C not a multiple of the vector width, misaligned buffers).

Needs an NVIDIA GPU and nvcc: marked `cuda` and skipped elsewhere. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed: `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import pytest

torch = pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda, nms_cuda  # noqa: E402
from zero_latency_yolo_tpu_torch.ops.nms import _iou_matrix_center  # noqa: E402

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,cin,cout,act", [(1, 1, 1, True), (169, 64, 4, False),
                                            (1000, 48, 96, True),
                                            (4097, 512, 256, True)])
def test_conv1x1_kernel(dev, dtype, m, cin, cout, act):
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, cin, generator=g).to(dev, dtype)
    w = (torch.randn(cin, cout, generator=g) / cin ** 0.5).to(dev, dtype)
    b = torch.randn(cout, generator=g).to(dev)
    got = conv1x1_cuda.conv1x1_bias_act(x, w, b, act=act).float()
    want = conv1x1_cuda.conv1x1_bias_act_plain(x, w, b, act=act).float()
    # f32: another summation order; bf16: that order's rounding may move
    # the one rounding to bf16 by one ulp.
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(
        atol=1e-2, rtol=2.0 ** -7)
    torch.testing.assert_close(got, want, **tol)


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


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        conv1x1_cuda.conv1x1_bias_act(x, torch.zeros(8, 2, device=dev,
                                                     dtype=torch.float16),
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
