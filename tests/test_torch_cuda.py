"""The port's CUDA kernels against their plain PyTorch versions on the card:
at the serving step's own shapes (yolov8n, 416 px, batch 8) and at edge
shapes it does not reach (ragged tiles, K below a block, C not a multiple
of the vector width, misaligned buffers), on both routes of the 1x1 GEMM;
the NMS kernel exactly, on its edge cases too. Also the engine on the card:
dispatch returns before the device has run the step, the step's full f32
switch holds under PyTorch's default TF32 settings, a pending batch's CUDA
event says whether the step and its result's copy are done, complete()
reads the pinned copy without another one, and two batches in flight
through the ContinuousBatcher both complete, in order.

Needs an NVIDIA GPU and nvcc: marked `cuda` and skipped elsewhere. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed: `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_nms_cases  # noqa: E402
from test_torch_serving_shapes import SERVING_BIAS_SILU_B8, SERVING_CONV1X1_B8  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import (  # noqa: E402
    _build, act_cuda, conv1x1_cuda, nms_cuda)

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


def _small_engine(dtype: str):
    """yolov8p at 64 px with NumPy-initialised weights on the card."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.models import yolov8 as ym
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz", "confidence_threshold": 0.5,
        "nms_threshold": 0.45,
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": dtype,
                "batch_buckets": [2], "frame_buckets": [[96, 128]],
                "pre_nms_topk": 64}})
    return InferenceEngine(cfg, params=ym.init_params(0, ym.get_spec(
        "yolov8p", 4)), device="cuda")


def test_dispatch_returns_before_the_device_is_done(dev):
    """A spin of the GPU queued before dispatch is still running when
    dispatch returns: dispatch waits neither for earlier steps nor for its
    own uploads."""
    from zero_latency_yolo_tpu_torch.runtime.engine import InferenceRequest
    eng = _small_engine("bfloat16")
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
