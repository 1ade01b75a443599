"""The PyTorch port's serving slice against the JAX package (CPU, plain
kernel versions): forward, letterbox, the whole engine step, and the real
trained weights at a small input size."""

import os

import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jax_model  # noqa: E402
from zero_latency_yolo_tpu.models.weights import load_params as jax_load  # noqa: E402
from zero_latency_yolo_tpu.ops import preprocess as jax_pre  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import yolov8 as pt_model  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    params_from_jax, place_params)
from zero_latency_yolo_tpu_torch.ops import preprocess as pt_pre  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_416 = os.path.join(_REPO, "artifacts", "yolov8n_trained_416.npz")


def _port_params(tree, dtype=torch.float32):
    return place_params(params_from_jax(tree), "cpu", dtype)


def _assert_decoded_close(got, want, size):
    # The 1e-3 gate of tests/test_model_parity.py:54-63: boxes in units of
    # the input size (the wire format is normalized), probabilities absolute.
    box = np.abs(got[..., :4] - want[..., :4]).max() / size
    prob = np.abs(got[..., 4:] - want[..., 4:]).max()
    assert box < 1e-3, f"box diff {box:.2e}"
    assert prob < 1e-3, f"prob diff {prob:.2e}"


def test_init_params_match_jax():
    """The NumPy init is the JAX package's, number for number."""
    spec = jax_model.get_spec("yolov8p", 4)
    from zero_latency_yolo_tpu.models.weights import flatten
    want = flatten(jax_model.init_params(3, spec, folded=False, device=False))
    got = flatten(pt_model.init_params(3, pt_model.get_spec("yolov8p", 4),
                                       folded=False))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_anchors_match_jax():
    spec = jax_model.get_spec("yolov8n", 4)
    for h, w in ((416, 416), (160, 224)):
        for got, want in zip(pt_model.anchors_for(pt_model.get_spec("yolov8n", 4),
                                                  h, w),
                             jax_model.anchors_for(spec, h, w)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("folded", [True, False])
def test_forward_decoded_matches_jax_f32(folded):
    """yolov8p at 128 px, f32 (unfolded trees are folded by params_from_jax)."""
    size = 128
    spec = jax_model.get_spec("yolov8p", 4)
    tree = jax_model.init_params(0, spec, folded=folded, device=False)
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)).astype(
        np.float32)
    jtree = jax_model.fold_batchnorm(tree) if not folded else tree
    want = np.asarray(jax_model.forward_decoded(jtree, spec, jnp.asarray(x)))
    got = pt_model.forward_decoded(_port_params(tree),
                                   pt_model.get_spec("yolov8p", 4),
                                   torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    _assert_decoded_close(got, want, size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_letterbox_mxu_matches_jax(dtype):
    """Same frames, runtime sizes and interpolation matrices; f32 within
    float rounding, bf16 within one bf16 rounding of the intermediate."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    hs = np.array([64, 50, 31], np.int32)
    ws = np.array([96, 77, 96], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax_pre.letterbox_batch_mxu(
        jnp.asarray(frames), jnp.asarray(hs), jnp.asarray(ws), 128, jdt))
    got = pt_pre.letterbox_batch_mxu(
        torch.from_numpy(frames), torch.from_numpy(hs), torch.from_numpy(ws),
        128, tdt).numpy()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8  # 1 bf16 ulp of [0, 1]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _engine_cfg(extra_tpu=None):
    tpu = {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
           "batch_buckets": [2, 4], "frame_buckets": [[96, 128]],
           "pre_nms_topk": 64, "nms": "pallas_interpret"}
    tpu.update(extra_tpu or {})
    return {"model_path": "/nonexistent.npz", "confidence_threshold": 0.5,
            "nms_threshold": 0.45,
            "detection": {"model_width": 64, "model_height": 64},
            "tpu": tpu}


def _spread_params(seed):
    """Random yolov8p weights whose class logits spread widely, so scores are
    well separated (no near-ties at the threshold or in the ranking)."""
    tree = jax_model.init_params(seed, jax_model.get_spec("yolov8p", 4),
                                 device=False)
    for lvl in tree["m22"]["cv3"]:
        lvl[2]["w"] = lvl[2]["w"] * 8.0
        lvl[2]["b"] = np.linspace(-2, 2, 4).astype(np.float32)
    return tree


def _requests(cls, n):
    rng = np.random.default_rng(11)
    sizes = [(96, 128), (64, 96), (80, 80), (96, 60)]
    return [cls(client_id=i + 1, frame_id=i, timestamp=i,
                width=sizes[i % 4][1], height=sizes[i % 4][0],
                data=rng.integers(0, 256, sizes[i % 4] + (3,), dtype=np.uint8))
            for i in range(n)]


def test_engine_infer_batch_matches_jax():
    """The port engine's infer_batch against the JAX engine (f32, Pallas NMS
    in interpret mode) on the same config, frames and parameters: counts
    and classes equal, boxes and scores within 1e-3."""
    tree = _spread_params(2)
    jeng = jax_engine.InferenceEngine(JaxConfig.from_dict(_engine_cfg()),
                                      params=tree)
    peng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                     params=tree, device="cpu")
    want = jeng.infer_batch(_requests(jax_engine.InferenceRequest, 5))
    got = peng.infer_batch(_requests(pt_engine.InferenceRequest, 5))
    assert len(got) == len(want) == 5
    assert sum(len(r.detections) for r in want) > 0, "vacuous: no detections"
    for g, w in zip(got, want):
        assert (g.client_id, g.frame_id) == (w.client_id, w.frame_id)
        assert len(g.detections) == len(w.detections)
        for dg, dw in zip(g.detections, w.detections):
            assert dg.class_id == dw.class_id
            np.testing.assert_allclose(
                [dg.x, dg.y, dg.width, dg.height, dg.confidence],
                [dw.x, dw.y, dw.width, dw.height, dw.confidence], atol=1e-3)


def test_engine_dispatch_paths_agree():
    """complete_many (one readback for several batches) returns what
    infer_batch returns; oversized frames are shed and counted; a threshold
    update applies from the next dispatch."""
    tree = _spread_params(2)
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    params=tree, device="cpu")
    reqs = _requests(pt_engine.InferenceRequest, 6)
    want = eng.infer_batch(reqs)
    got = [r for rs in eng.complete_many([eng.dispatch(reqs[:4]),
                                          eng.dispatch(reqs[4:])])
           for r in rs]
    assert [(r.frame_id, [(d.class_id, d.x, d.confidence) for d in r.detections])
            for r in got] == [
        (r.frame_id, [(d.class_id, d.x, d.confidence) for d in r.detections])
        for r in want]
    big = pt_engine.InferenceRequest(client_id=9, frame_id=9, timestamp=0,
                                     width=200, height=200,
                                     data=np.zeros((200, 200, 3), np.uint8))
    assert len(eng.infer_batch(reqs[:1] + [big])) == 1
    assert eng.frames_dropped.value == 1
    eng.update_thresholds(confidence=1.0)
    assert all(not r.detections for r in eng.infer_batch(reqs))
    assert eng.status()["inferences"] == str(6 + 6 + 1 + 6)


def test_engine_refuses_unported_options():
    """Only a serving mesh is refused; int8, the layout switches, the
    other preprocess modes and a serve-size ladder construct."""
    for extra in ({"stem": "s2d"}, {"select": "perlevel"}, {"c2f": "split"},
                  {"serve_sizes": [32]}, {"preprocess": "letterbox"},
                  {"preprocess": "stretch"}, {"quantize_int8": True}):
        pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg(extra)),
                                  params=_spread_params(0), device="cpu")
    for extra in ({"mesh_data": 2}, {"mesh_model": 2}):
        with pytest.raises(ValueError, match="not implemented"):
            pt_engine.InferenceEngine(
                ServerConfig.from_dict(_engine_cfg(extra)),
                params=_spread_params(0), device="cpu")


def test_engine_simulation_mode_without_model():
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    device="cpu")
    assert eng.simulation
    res = eng.infer_batch(_requests(pt_engine.InferenceRequest, 3))
    assert len(res) == 3 and eng.status()["simulation"] == "true"


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                  params=_spread_params(0))


def test_real_weights_forward_160_matches_jax():
    """The trained deployment artifact (yolov8n, 416) at 160 px: the model
    is fully convolutional. f32, the 1e-3 gate, on in-distribution input
    (the artifact's own task, as tests/test_model_parity.py uses)."""
    from zero_latency_yolo_tpu.train.loop import synthetic_batches
    size = 160
    tree = jax_load(TRAINED_416)
    spec = jax_model.get_spec("yolov8n", 4)
    x, _ = next(synthetic_batches(2, size, seed=777))
    want = np.asarray(jax_model.forward_decoded(tree, spec, jnp.asarray(x)))
    got = pt_model.forward_decoded(_port_params(tree),
                                   pt_model.get_spec("yolov8n", 4),
                                   torch.from_numpy(x)).numpy()
    _assert_decoded_close(got, want, size)
    assert (want[..., 4:] > 0.5).any(), "vacuous: the model fires nowhere"


def _tf32_knobs():
    """(object, name, value on, value off) of cuDNN conv TF32 and matmul
    TF32: the per-op precision settings where PyTorch has them (2.9 and
    later), else the allow_tf32 flags."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        return [(cudnn.conv, "fp32_precision", "tf32", "ieee"),
                (matmul, "fp32_precision", "tf32", "ieee")]
    return [(cudnn, "allow_tf32", True, False),
            (matmul, "allow_tf32", True, False)]


def _tf32_on():
    return tuple(getattr(obj, name) == on for obj, name, on, _ in _tf32_knobs())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_step_precision_is_its_own(dtype, monkeypatch):
    """With the caller's TF32 on, an f32 step runs every conv and batched
    matmul with cuDNN and matmul TF32 off, and gives the caller's settings
    back; a bf16 step leaves them as they are."""
    eng = pt_engine.InferenceEngine(
        ServerConfig.from_dict(_engine_cfg({"dtype": dtype})),
        params=_spread_params(2), device="cpu")
    seen = []

    def recording(fn):
        def run(*args, **kwargs):
            seen.append(_tf32_on())
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        recording(torch.nn.functional.conv2d))
    monkeypatch.setattr(torch, "bmm", recording(torch.bmm))
    for obj, name, on, _ in _tf32_knobs():  # the caller's: TF32 on
        monkeypatch.setattr(obj, name, on)
    eng.infer_batch(_requests(pt_engine.InferenceRequest, 2))
    after = _tf32_on()
    assert len(seen) > 2  # the letterbox's two products and the k=3 convs
    inside = (False, False) if dtype == "float32" else (True, True)
    assert set(seen) == {inside}
    assert after == (True, True)


def test_engine_dispatch_copies_only_pinned_staging_non_blocking(monkeypatch):
    """dispatch copies to the device only its two staging buffers (frames,
    and heights and widths packed (2, B)), each with non_blocking=True, so
    from pinned memory it does not wait for the device; the pair returns to
    the free-list only when its batch is read back."""
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    params=_spread_params(2), device="cpu")
    reqs = _requests(pt_engine.InferenceRequest, 6)
    calls, recording = [], [True]
    to, step = torch.Tensor.to, eng._step

    def rec_to(self, *args, **kwargs):
        if recording[0]:
            calls.append((self, args, kwargs))
        return to(self, *args, **kwargs)

    def quiet_step(*args):  # the step's own dtype casts are not copies
        recording[0] = False
        try:
            return step(*args)
        finally:
            recording[0] = True

    monkeypatch.setattr(eng, "_step", quiet_step)
    monkeypatch.setattr(torch.Tensor, "to", rec_to)
    first = eng.dispatch(reqs[:4])
    second = eng.dispatch(reqs[4:])
    monkeypatch.undo()
    assert len(calls) == 4
    for src, args, kwargs in calls:
        assert kwargs.get("non_blocking") is True, (tuple(src.shape), kwargs)
    frames, shw = first.staging_buf
    assert shw.dtype == torch.int32 and shw.shape == (2, 4)
    assert shw[:, 0].tolist() == [reqs[0].height, reqs[0].width]
    bufs = {t.data_ptr() for p in (first, second) for t in p.staging_buf}
    assert {src.data_ptr() for src, _, _ in calls} == bufs
    assert second.staging_buf[0].data_ptr() != frames.data_ptr()
    got = eng.complete_many([first, second])
    assert [len(r) for r in got] == [4, 2]
    # Recycled after the readback: the next batch of 4 reuses the pair.
    again = eng.dispatch(reqs[:4])
    assert again.staging_buf[0] is frames and again.staging_buf[1] is shw
    assert [(r.frame_id, len(r.detections)) for r in eng.complete(again)] == [
        (r.frame_id, len(r.detections)) for r in got[0]]


def _dets(results):
    return [(r.client_id, r.frame_id,
             [(d.class_id, d.x, d.y, d.width, d.height, d.confidence)
              for d in r.detections]) for r in results]


def test_engine_infer_batch_cached_matches_infer_batch_and_jax():
    """Frames written to the device frame cache and served from it: equal
    to infer_batch on the same frames to the last bit (the config's one
    frame bucket is the cache's shape, so both run the same bucket and
    batch), and to the JAX engine's infer_batch_cached on the JAX cache
    within the 1e-3 gate; dispatch_from_cache through dispatch_with equals
    both."""
    from zero_latency_yolo_tpu.ops.roi import DeviceFrameCache as JaxCache
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    tree = _spread_params(2)
    peng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                     params=tree, device="cpu")
    jeng = jax_engine.InferenceEngine(JaxConfig.from_dict(_engine_cfg()),
                                      params=tree)
    reqs = _requests(pt_engine.InferenceRequest, 4)
    jreqs = _requests(jax_engine.InferenceRequest, 4)
    cache = DeviceFrameCache(4, 96, 128, device="cpu")
    jcache = JaxCache(4, 96, 128)
    ids = [r.client_id for r in reqs]
    for r in reqs:
        assert cache.write_keyframe(r.client_id, r.data)
        assert jcache.write_keyframe(r.client_id, r.data)
    frames, hs, ws = cache.gather(ids)
    got = peng.infer_batch_cached(reqs, frames, hs, ws)
    want = peng.infer_batch(reqs)
    assert sum(len(r.detections) for r in want) > 0, "vacuous: no detections"
    assert _dets(got) == _dets(want)
    fused = peng.complete(cache.dispatch_with(
        lambda c, s, h, w: peng.dispatch_from_cache(reqs, c, s, h, w), ids))
    assert _dets(fused) == _dets(want)
    jframes, jhs, jws = jcache.gather(ids)
    ref = jeng.infer_batch_cached(jreqs, jframes, jhs, jws)
    for g, w in zip(got, ref):
        assert len(g.detections) == len(w.detections)
        for dg, dw in zip(g.detections, w.detections):
            assert dg.class_id == dw.class_id
            np.testing.assert_allclose(
                [dg.x, dg.y, dg.width, dg.height, dg.confidence],
                [dw.x, dw.y, dw.width, dw.height, dw.confidence], atol=1e-3)


def test_engine_cached_dispatch_refuses_unbucketed_shapes():
    """As the JAX engine (tests/test_engine.py:94): dispatch_cached takes
    only a (batch bucket, frame bucket) shape, dispatch_from_cache only a
    batch bucket of slots."""
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    params=_spread_params(2), device="cpu")
    reqs = _requests(pt_engine.InferenceRequest, 3)
    with pytest.raises(ValueError, match="not a configured"):
        eng.dispatch_cached(reqs, torch.zeros((3, 96, 128, 3), dtype=torch.uint8),
                            np.array([64] * 3), np.array([96] * 3))
    with pytest.raises(ValueError, match="not a configured"):
        eng.dispatch_cached(reqs[:2], torch.zeros((2, 64, 64, 3),
                                                  dtype=torch.uint8),
                            np.array([64] * 2), np.array([64] * 2))
    cache = torch.zeros((4, 96, 128, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batch bucket"):
        eng.dispatch_from_cache(reqs, cache, np.arange(3), np.full(3, 64),
                                np.full(3, 96))
    assert eng.error_count.value == 0


def test_engine_dispatch_from_cache_copies_only_pinned_staging(monkeypatch):
    """dispatch_from_cache moves one packed (3, B) int32 array of slots,
    heights and widths to the device, non_blocking, from a staging buffer
    that is recycled when the batch is read back."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    params=_spread_params(2), device="cpu")
    reqs = _requests(pt_engine.InferenceRequest, 2)
    cache = DeviceFrameCache(4, 96, 128, device="cpu")
    for r in reqs:
        assert cache.write_keyframe(r.client_id, r.data)
    cache.run_locked(lambda c: c)
    calls, recording = [], [True]
    to, step = torch.Tensor.to, eng._step

    def rec_to(self, *args, **kwargs):
        if recording[0]:
            calls.append((self, kwargs))
        return to(self, *args, **kwargs)

    def quiet_step(*args):
        recording[0] = False
        try:
            return step(*args)
        finally:
            recording[0] = True
    monkeypatch.setattr(eng, "_step", quiet_step)
    monkeypatch.setattr(torch.Tensor, "to", rec_to)
    pending = cache.dispatch_with(
        lambda c, s, h, w: eng.dispatch_from_cache(reqs, c, s, h, w),
        [r.client_id for r in reqs])
    monkeypatch.undo()
    (src, kwargs), = calls
    assert kwargs.get("non_blocking") is True
    shw, = pending.staging_buf
    assert src is shw and shw.dtype == torch.int32 and shw.shape == (3, 2)
    assert shw[:, 1].tolist() == [cache.slot(2), reqs[1].height, reqs[1].width]
    eng.complete(pending)
    again = cache.dispatch_with(
        lambda c, s, h, w: eng.dispatch_from_cache(reqs, c, s, h, w),
        [r.client_id for r in reqs])
    assert again.staging_buf[0] is shw
