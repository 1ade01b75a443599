"""The port's serving mesh (parallel/mesh.py) on a virtual CPU mesh, against
the JAX package's sharded counterparts on the 8 host devices that
tests/conftest.py forces: the tensor-parallel specs leaf for leaf, the
sharded forward, the meshed engine (hosted and cached, a slot on the other
shard, int8), bucket filtering and the scheduler's clamp, the single-device
fallback, the two dp2 example configs, dispatch without waiting, and a full
DetectionServer on a data = 4 mesh (the cases of tests/test_sharding.py).

A virtual mesh repeats the CPU device: `parallel.mesh.available_devices`
is replaced for the test, as the JAX tests force host devices."""

import copy
import logging
import os
import re
import socket
import time

import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jax_model  # noqa: E402
from zero_latency_yolo_tpu.parallel import mesh as jax_mesh  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import yolov8 as pt_model  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    params_from_jax, place_params)
from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache  # noqa: E402
from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96
MESHES = [(4, 2), (2, 1), (1, 2)]
CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture
def virtual(monkeypatch):
    """available_devices -> 8 repeats of the CPU (a virtual mesh)."""
    monkeypatch.setattr(pt_mesh, "available_devices",
                        lambda device="cuda": [CPU] * 8)


def _specs(tree, is_leaf, spec, path=""):
    """{path: spec} of a tree of spec leaves."""
    if is_leaf(tree):
        return {path[:-1]: spec(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_specs(v, is_leaf, spec, f"{path}{k}/"))
    return out


@pytest.mark.parametrize("variant", ["yolov8p", "yolov8n"])
@pytest.mark.parametrize("model", [2, 4])
def test_param_shardings_match_jax_leaf_for_leaf(variant, model):
    """The same spec as the JAX package's param_shardings for every leaf
    (HWIO tree); the detect-head tips replicated; a large backbone conv
    sharded."""
    from jax.sharding import NamedSharding
    tree = pt_model.init_params(0, pt_model.get_spec(variant, 4))
    want = _specs(jax_mesh.param_shardings(
        tree, jax_mesh.make_mesh(1, model, devices=jax.devices()[:model])),
        lambda x: isinstance(x, NamedSharding), lambda s: tuple(s.spec))
    got = _specs(pt_mesh.param_shardings(
        tree, pt_mesh.make_mesh(1, model, [CPU] * model)),
        lambda x: isinstance(x, tuple), lambda s: s)
    assert got == want
    assert got["m9/cv2/w"] == (None, None, None, "model")
    for branch in ("cv2", "cv3"):
        for lvl in range(3):
            for leaf in ("w", "b"):
                assert got[f"m22/{branch}/{lvl}/2/{leaf}"] == ()
    assert any(s for s in got.values()) and not all(s for s in got.values())


@pytest.mark.parametrize("variant", ["yolov8p", "yolov8n"])
@pytest.mark.parametrize("model", [2, 4])
def test_sharded_placement_slices_are_contiguous_k_major(variant, model):
    """shard_params: one tree per device; every sharded block holds its
    column of the whole block's output channels, each 1x1 slice (and each
    split C2f piece) its own contiguous K-major matrix; int8-free replicated
    blocks stay whole; the head tips are never sharded."""
    spec = pt_model.get_spec(variant, 4)
    dev = params_from_jax(pt_model.init_params(0, spec))
    mesh = pt_mesh.make_mesh(1, model, [CPU] * model)
    whole = place_params(dev, CPU, torch.float32, c2f_split=True,
                         stem_s2d=True)
    trees = pt_mesh.shard_params(dev, mesh, torch.float32, c2f_split=True,
                                 stem_s2d=True)
    assert len(trees) == model
    seen = {"w_mm": 0, "w": 0}

    def walk(parts, ref, path):
        if isinstance(ref, list):
            for i, r in enumerate(ref):
                walk([p[i] for p in parts], r, f"{path}/{i}")
            return
        if "b" not in ref:
            for k in ref:
                walk([p[k] for p in parts], ref[k], f"{path}/{k}".lstrip("/"))
            return
        sharded = "shard" in parts[0]
        assert sharded == pt_mesh.shards_conv(path, ref["b"].shape[0], model)
        if re.fullmatch(r"m22/cv[23]/\d/2", path):
            assert not sharded, path
        key = "w_mm" if "w_mm" in ref else "w"
        if not sharded:
            for p in parts:
                assert torch.equal(p[key], ref[key])
            return
        seen[key] += 1
        axis = 1 if key == "w_mm" else 0
        assert torch.equal(torch.cat([p[key] for p in parts], axis), ref[key])
        assert torch.equal(torch.cat([p["b"] for p in parts]), ref["b"])
        for c, p in enumerate(parts):
            assert p["shard"] == (c, model)
            if key == "w_mm":
                w = p["w_mm"]
                assert w.stride() == (1, w.shape[0]) and w.t().is_contiguous()
        if "w_s2d" in ref:
            assert torch.equal(torch.cat([p["w_s2d"] for p in parts]),
                               ref["w_s2d"])

    walk(trees, whole, "")
    assert seen["w_mm"] > 0 and seen["w"] > 0


def _jax_sharded_forward(tree, spec, x, data, model):
    mesh = jax_mesh.make_mesh(data, model,
                              devices=jax.devices()[:data * model])
    fn = jax.jit(lambda p, x: jax_model.forward_decoded(p, spec, x))
    return np.asarray(fn(jax_mesh.shard_params(tree, mesh),
                         jax.device_put(x, jax_mesh.batch_sharding(mesh, 4))))


def _port_sharded_forward(tree, spec, x, data, model, **kw):
    mesh = pt_mesh.make_mesh(data, model, [CPU] * (data * model))
    trees = pt_mesh.shard_params(params_from_jax(tree), mesh, torch.float32)
    x = torch.from_numpy(x)
    return torch.cat([
        pt_model.forward_decoded(pt_mesh.row_params(mesh, trees, r), spec,
                                 x[sl], conv_fn=pt_model.tp_conv, **kw)
        for r, sl in enumerate(pt_mesh.batch_rows(mesh, len(x)))]).numpy()


@pytest.mark.parametrize("data,model", MESHES)
def test_meshed_forward_matches_single_device_and_jax(data, model):
    """The port's forward on a virtual CPU mesh equals its single-device
    forward within 1e-5 (and 1e-6 of the value: the decoded pixel
    coordinates reach a few hundred, where an f32 ulp is some 3e-5, and a
    halved Cout may sum in another order) and the JAX package's sharded
    forward within tests/test_sharding.py's 2e-3."""
    spec = pt_model.get_spec("yolov8p", 4)
    tree = pt_model.init_params(0, spec)
    x = np.random.default_rng(1).uniform(0, 1, (8, SIZE, SIZE, 3)).astype(
        np.float32)
    single = pt_model.forward_decoded(
        place_params(params_from_jax(tree), CPU, torch.float32), spec,
        torch.from_numpy(x)).numpy()
    got = _port_sharded_forward(tree, spec, x, data, model)
    np.testing.assert_allclose(got, single, atol=1e-5, rtol=1e-6)
    want = _jax_sharded_forward(tree, jax_model.get_spec("yolov8p", 4), x,
                                data, model)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_meshed_forward_split_c2f_and_s2d_stem():
    """The split C2f's pieces and the s2d stem under model = 2: equal to the
    single-device forward of the same layouts."""
    spec = pt_model.get_spec("yolov8p", 4)
    dev = params_from_jax(pt_model.init_params(0, spec))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, SIZE // 2, SIZE // 2, 12)).astype(np.float32))
    kw = dict(c2f_split=True, stem_s2d=True)
    want = pt_model.forward_decoded(place_params(dev, CPU, torch.float32, **kw),
                                    spec, x, stem="s2d", c2f="split")
    mesh = pt_mesh.make_mesh(1, 2, [CPU] * 2)
    row = pt_mesh.row_params(mesh, pt_mesh.shard_params(
        dev, mesh, torch.float32, **kw), 0)
    assert "shards" in row["m0"] and "shards" in row["m2"]["cv1_pieces"][0]
    got = pt_model.forward_decoded(row, spec, x, stem="s2d", c2f="split",
                                   conv_fn=pt_model.tp_conv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_make_mesh_and_batch_rows():
    mesh = pt_mesh.make_mesh(4, 2, [CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.virtual and len(mesh.leads) == 4
    with pytest.raises(ValueError):
        pt_mesh.make_mesh(3, 2, [CPU] * 8)
    assert pt_mesh.batch_rows(mesh, 8) == [slice(0, 2), slice(2, 4),
                                           slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError):
        pt_mesh.batch_rows(mesh, 6)


# --------------------------------------------------------------- engine

def _engine_dict(md, mm, **tpu):
    return {
        "model_path": "/nonexistent.npz",
        "confidence_threshold": 0.1,
        "detection": {"model_width": SIZE, "model_height": SIZE},
        "tpu": {"variant": "yolov8p", "num_classes": 4,
                "dtype": "float32", "pre_nms_topk": 64,
                "batch_buckets": [8], "frame_buckets": [[96, 96]],
                "mesh_data": md, "mesh_model": mm, **tpu},
    }


def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (8, 96, 96, 3),
                                                np.uint8)


def _requests(cls, frames, pixels=True, ids=None):
    ids = ids or list(range(1, len(frames) + 1))
    return [cls(client_id=c, frame_id=i, timestamp=0, width=96, height=96,
                data=frames[i] if pixels else None)
            for i, c in enumerate(ids)]


def _rows(results):
    return [[(d.x, d.y, d.width, d.height, d.confidence, d.class_id)
             for d in r.detections] for r in results]


def _close(got, want, atol=1e-5):
    assert [len(r) for r in got] == [len(r) for r in want]
    for g, w in zip(got, want):
        assert [d[5] for d in g] == [d[5] for d in w]
        if g:
            np.testing.assert_allclose(np.array(g)[:, :5], np.array(w)[:, :5],
                                       atol=atol, rtol=0)


def _cached(engine, module, cache_cls, frames, ids, **kw):
    """Keyframes written into a cache for `ids`, then one batch served out
    of it through dispatch_with (either package's engine module and
    cache)."""
    cache = cache_cls(8, 96, 96, **kw)
    for i, cid in enumerate(ids):
        assert cache.acquire(cid) is not None
        assert cache.write_keyframe(cid, frames[i])
    reqs = _requests(module.InferenceRequest, frames, pixels=False, ids=ids)
    return cache, engine.complete(cache.dispatch_with(
        lambda c, s, hs, ws: engine.dispatch_from_cache(reqs, c, s, hs, ws),
        ids))


@pytest.fixture(scope="module")
def tree():
    return pt_model.init_params(2, pt_model.get_spec("yolov8p", 4))


@pytest.fixture(scope="module")
def single_results(tree):
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(1, 1)),
                                    params=tree, device="cpu")
    frames = _frames()
    return _rows(eng.infer_batch(_requests(pt_engine.InferenceRequest,
                                           frames)))


@pytest.mark.parametrize("data,model", MESHES)
def test_meshed_engine_hosted_and_cached_match_jax(virtual, tree,
                                                   single_results, data,
                                                   model):
    """The meshed engine's hosted path and its slot-sharded cached path
    against the JAX meshed engine on the same params and frames (counts
    and classes equal) and the port's single-device engine (boxes within
    1e-5), as tests/test_sharding.py:88-150. The cache's slots of every
    batch row live on the other data row's shard (clients 1..8 take slots
    7..0), so each row's gather copies across shards."""
    from zero_latency_yolo_tpu.ops.roi import DeviceFrameCache as JaxCache
    frames = _frames()
    eng = pt_engine.InferenceEngine(
        ServerConfig.from_dict(_engine_dict(data, model)), params=tree,
        device="cpu")
    assert eng.mesh is not None and eng.mesh.shape == {"data": data,
                                                       "model": model}
    st = eng.status()
    assert st["mesh"] == f"{data}x{model}" and st["mesh_virtual"] == "true"
    jeng = jax_engine.InferenceEngine(
        JaxConfig.from_dict(_engine_dict(data, model)), params=tree)
    assert jeng.mesh is not None
    want = _rows(jeng.infer_batch(_requests(jax_engine.InferenceRequest,
                                            frames)))
    got = _rows(eng.infer_batch(_requests(pt_engine.InferenceRequest, frames)))
    assert sum(map(len, want)) > 0
    assert [[d[5] for d in r] for r in got] == [[d[5] for d in r]
                                                for r in want]
    _close(got, single_results)

    ids = list(range(1, 9))
    cache, cached = _cached(eng, pt_engine, DeviceFrameCache, frames, ids,
                            device="cpu", mesh=eng.mesh)
    if data > 1:
        per = cache.num_slots // data
        for r, sl in enumerate(pt_mesh.batch_rows(eng.mesh, 8)):
            assert all(cache.slot(c) // per != r for c in ids[sl])
    _, jcached = _cached(jeng, jax_engine, JaxCache, frames, ids,
                         sharding=jeng.batch_sharding(4))
    _close(_rows(cached), single_results)
    assert [[d[5] for d in r] for r in _rows(cached)] == [
        [d[5] for d in r] for r in _rows(jcached)]
    assert eng.error_count.value == 0


def test_meshed_cache_mixed_shards_and_warmup(virtual, tree, single_results):
    """A 2x1 cache whose batch rows mix both shards (and a client order
    other than the slot order), after warmup ran the cached step; the
    cache's host-side gather reads every shard too."""
    frames = _frames()
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(2, 1)),
                                    params=tree, device="cpu")
    ids = [3, 8, 1, 6, 2, 7, 4, 5]
    cache = DeviceFrameCache(7, 96, 96, device="cpu", mesh=eng.mesh)
    assert cache.num_slots == 8 and len(cache._cache.shards) == 2
    eng.warmup(cache=cache)
    for cid in range(1, 9):
        cache.acquire(cid)
    order = [frames[c - 1] for c in ids]
    for cid, f in zip(ids, order):
        assert cache.write_keyframe(cid, f)
    reqs = _requests(pt_engine.InferenceRequest, order, pixels=False, ids=ids)
    got = eng.complete(cache.dispatch_with(
        lambda c, s, hs, ws: eng.dispatch_from_cache(reqs, c, s, hs, ws), ids))
    _close(_rows(got), [single_results[c - 1] for c in ids])
    gathered, hs, ws = cache.gather(ids)
    assert np.array_equal(gathered.numpy(), np.stack(order))
    # An ROI write lands in its slot's shard.
    cache.write_roi(8, np.full((8, 8, 3), 7, np.uint8), 4, 4)
    again, _, _ = cache.gather([8])
    assert (again.numpy()[0, 4:12, 4:12] == 7).all()


def test_meshed_engine_int8_matches_single_device_int8(virtual, tree):
    """tpu.quantize_int8 under a 1x2 mesh: calibrated whole, int8 blocks
    replicated, the float convs channel-sharded; the same detections as
    the single-device int8 engine."""
    frames = _frames(3)
    cfgs = [ServerConfig.from_dict(_engine_dict(1, m, quantize_int8=True))
            for m in (1, 2)]
    single, meshed = (pt_engine.InferenceEngine(c, params=tree, device="cpu")
                      for c in cfgs)
    assert meshed.mesh is not None
    row = meshed._params[0]
    assert "w_q" in row["m1"] and "x_scale" in row["m1"]
    assert float(row["m1"]["x_scale"]) == float(single._params["m1"]["x_scale"])
    assert "shards" in row["m0"]            # the stem stays float, sharded
    want = _rows(single.infer_batch(_requests(pt_engine.InferenceRequest,
                                              frames)))
    got = _rows(meshed.infer_batch(_requests(pt_engine.InferenceRequest,
                                             frames)))
    assert sum(map(len, want)) > 0
    _close(got, want)


def test_buckets_filtered_to_data_and_scheduler_clamps(virtual, tree):
    """Under data = 4 the batch buckets that 4 does not divide are dropped
    (none left: (4,)), and the batcher clamps its max batch (the config's
    largest bucket, 6) to the engine's buckets, as its JAX twin does."""
    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(
        4, 1, batch_buckets=[1, 2, 4, 6, 8])), params=tree, device="cpu")
    assert eng.batch_buckets == (4, 8)
    eng2 = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(
        4, 1, batch_buckets=[2, 6])), params=tree, device="cpu")
    assert eng2.batch_buckets == (4,)
    assert ContinuousBatcher(eng2, lambda results: None,
                             max_batch=6).max_batch == 4
    res = eng2.infer_batch(_requests(pt_engine.InferenceRequest,
                                     _frames()[:6]))
    assert len(res) == 6


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_mesh_wider_than_devices_serves_single_device(tree):
    """A 2x1 mesh over a one-device list (the CPU alone) serves on that one
    device with a logged warning; status() reports the mesh in use and the
    one configured."""
    rec = _Records()
    logger = logging.getLogger("zlt.engine")
    logger.addHandler(rec)
    try:
        eng = pt_engine.InferenceEngine(
            ServerConfig.from_dict(_engine_dict(2, 1)), params=tree,
            device="cpu")
    finally:
        logger.removeHandler(rec)
    assert eng.mesh is None and eng.device == CPU
    assert any("single-device" in m for m in rec.messages), rec.messages
    st = eng.status()
    assert (st["mesh"], st["mesh_requested"], st["mesh_devices"],
            st["mesh_virtual"]) == ("1x1", "2x1", "cpu", "false")
    assert eng.batch_buckets == (8,)
    assert len(eng.infer_batch(_requests(pt_engine.InferenceRequest,
                                         _frames()[:3]))) == 3


@pytest.mark.parametrize("name", ["server-64stream-dp2.json",
                                  "server-16stream-640-dp2.json"])
def test_dp2_example_configs_construct_and_serve_on_the_cpu(name,
                                                            monkeypatch):
    """Both dp2 example configs boot an engine on the CPU with their real
    weights: with one device they serve single-device, on a virtual
    two-device list on their 2x1 mesh; each serves a batch."""
    cfg = ServerConfig.load(os.path.join(REPO, "configs", "examples", name),
                            create_if_missing=False)
    cfg.model_path = os.path.join(REPO, cfg.model_path)
    assert (cfg.tpu.mesh_data, cfg.tpu.mesh_model) == (2, 1)
    booted = pt_engine.InferenceEngine(copy.deepcopy(cfg), device="cpu")
    assert not booted.simulation and booted.mesh is None
    assert booted.batch_buckets == tuple(cfg.tpu.batch_buckets)
    del booted
    # Served smaller and in f32: bf16 convs at 640 are slow on the CPU.
    cfg.tpu.dtype = "float32"
    cfg.detection.model_width = cfg.detection.model_height = 128
    frames = [np.random.default_rng(i).integers(0, 256, (120, 160, 3),
                                                np.uint8) for i in range(2)]
    reqs = [pt_engine.InferenceRequest(client_id=i + 1, frame_id=i,
                                       timestamp=0, width=160, height=120,
                                       data=f) for i, f in enumerate(frames)]
    one = pt_engine.InferenceEngine(copy.deepcopy(cfg), device="cpu")
    assert not one.simulation and one.mesh is None
    assert one.status()["mesh_requested"] == "2x1"
    monkeypatch.setattr(pt_mesh, "available_devices",
                        lambda device="cuda": [CPU] * 2)
    two = pt_engine.InferenceEngine(copy.deepcopy(cfg), device="cpu")
    assert two.mesh is not None and two.status()["mesh"] == "2x1"
    _close(_rows(two.infer_batch(copy.deepcopy(reqs))),
           _rows(one.infer_batch(copy.deepcopy(reqs))))


def test_meshed_dispatch_copies_only_staging_non_blocking(virtual, tree,
                                                          monkeypatch):
    """Under a 2x1 mesh dispatch copies each data row's frames and the
    packed heights and widths with non_blocking=True (from pinned memory
    on the card, so it returns before the device is done), and
    dispatch_from_cache its staging pair; nothing else is copied outside
    the steps."""
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(2, 1)),
                                    params=tree, device="cpu")
    frames = _frames()
    cache = DeviceFrameCache(8, 96, 96, device="cpu", mesh=eng.mesh)
    for i in range(8):
        cache.write_keyframe(i + 1, frames[i])
    cache.run_locked(lambda c: c)
    calls, recording = [], [True]
    to, step_rows = torch.Tensor.to, eng._step_rows

    def rec_to(self, *args, **kwargs):
        if recording[0]:
            calls.append(kwargs)
        return to(self, *args, **kwargs)

    def quiet(*args):
        recording[0] = False
        try:
            return step_rows(*args)
        finally:
            recording[0] = True
    monkeypatch.setattr(eng, "_step_rows", quiet)
    monkeypatch.setattr(torch.Tensor, "to", rec_to)
    hosted = eng.dispatch(_requests(pt_engine.InferenceRequest, frames))
    n_hosted = len(calls)
    reqs = _requests(pt_engine.InferenceRequest, frames, pixels=False)
    cached = cache.dispatch_with(
        lambda c, s, hs, ws: eng.dispatch_from_cache(reqs, c, s, hs, ws),
        list(range(1, 9)))
    monkeypatch.undo()
    assert n_hosted == 3 and len(calls) > n_hosted   # 2 rows + packed rows
    assert all(kw.get("non_blocking") is True for kw in calls), calls
    _close(_rows(eng.complete(hosted)), _rows(eng.complete(cached)))


# --------------------------------------------------------------- server

def _free_port(kind=socket.SOCK_DGRAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_full_server_on_a_data4_mesh_matches_single_device(virtual, tree,
                                                           tmp_path):
    """A full DetectionServer on a tpu.mesh_data = 4 virtual mesh (the
    slot-sharded cache, deferred ROI writes, the batcher and UDP together)
    serves the same results as the single-device server on the same
    frames, as tests/test_sharding.py:211."""
    from zero_latency_yolo_tpu_torch.bench_server import ServerThread
    from zero_latency_yolo_tpu_torch.models.weights import save_params
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.runtime.simulator import (
        SimClient, synthetic_frame)
    path = str(tmp_path / "m.npz")
    save_params(tree, path)

    def make_cfg(md):
        return ServerConfig.from_dict({
            "model_path": path, "port": _free_port(), "web_port": 0,
            "max_clients": 4, "worker_threads": 1,
            "confidence_threshold": 0.1,
            "network": {"timeout_ms": 120000},
            "detection": {"model_width": SIZE, "model_height": SIZE,
                          "enable_tracking": False},
            "tpu": {"variant": "yolov8p", "num_classes": 4,
                    "dtype": "float32", "pre_nms_topk": 64,
                    "batch_buckets": [4], "frame_buckets": [[96, 96]],
                    "batch_window_ms": 2.0, "mesh_data": md},
        })

    frames = {cid: synthetic_frame(96, 64, seed=cid) for cid in (1, 2)}
    regions = {cid: synthetic_frame(32, 16, seed=10 + cid) for cid in (1, 2)}
    collected = {}
    for name, md in (("mesh", 4), ("single", 1)):
        srv = ServerThread(DetectionServer(make_cfg(md), device="cpu"))
        server = srv.start(warmup=True).server
        clients = {}
        try:
            if name == "mesh":
                assert server.engine.mesh is not None
                assert server.device_cache.num_slots % 4 == 0
                assert len(server.device_cache._cache.shards) == 4
            else:
                assert server.engine.mesh is None
            for cid in (1, 2):
                c = SimClient(("127.0.0.1", server.port), screen_width=96,
                              screen_height=64)
                c.connect()
                c.start_receiver()
                clients[cid] = c
            for cid, c in clients.items():
                c.send_raw_frame(frames[cid])
            for c in clients.values():
                assert c.wait_results(1, timeout=60)
            for step_i in (0, 1):
                for cid, c in clients.items():
                    c.send_roi_update(regions[cid], x=8 * (step_i + 1), y=8)
                for c in clients.values():
                    deadline = time.monotonic() + 60
                    while (time.monotonic() < deadline
                           and len(c.results) < 2 + step_i):
                        time.sleep(0.05)
                    assert len(c.results) >= 2 + step_i
            collected[name] = {
                cid: {r.frame_id: [(d.x, d.y, d.width, d.height,
                                    d.confidence, d.class_id)
                                   for d in r.detections]
                      for r in c.results}
                for cid, c in clients.items()}
        finally:
            for c in clients.values():
                c.stop()
            srv.stop()
    for cid in (1, 2):
        mesh_r, single_r = collected["mesh"][cid], collected["single"][cid]
        shared = set(mesh_r) & set(single_r)
        assert len(shared) == 3
        assert sum(len(single_r[f]) for f in shared) > 0
        for fid in shared:
            _close([mesh_r[fid]], [single_r[fid]], atol=1e-4)


def test_meshed_hot_reload_reshards(virtual, tree, tmp_path):
    """A hot reload on a 1x2 mesh places the new file's params sharded
    again: the next batch equals a single-device engine booted on it."""
    from zero_latency_yolo_tpu_torch.models.weights import save_params
    path = tmp_path / "m.npz"
    save_params(tree, str(path))
    d = _engine_dict(1, 2)
    d["model_path"] = str(path)
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(d), device="cpu")
    assert eng.mesh is not None and not eng.simulation
    frames = _frames(4)
    eng.infer_batch(_requests(pt_engine.InferenceRequest, frames))
    new = pt_model.init_params(9, pt_model.get_spec("yolov8p", 4))
    save_params(new, str(path))
    assert eng.maybe_reload()
    got = _rows(eng.infer_batch(_requests(pt_engine.InferenceRequest, frames)))
    assert "shards" in eng._params[0]["m9"]["cv2"]
    fresh = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_dict(1, 1)),
                                      params=new, device="cpu")
    want = _rows(fresh.infer_batch(_requests(pt_engine.InferenceRequest,
                                             frames)))
    assert sum(map(len, want)) > 0
    _close(got, want)
