"""The port's step variants and weight loaders against the JAX package on the
CPU (f32, yolov8p, plain kernel versions): the letterbox, stretch and
space-to-depth preprocess and the row/column-gather letterbox; the engine with tpu.c2f="split", tpu.stem="s2d",
tpu.select="perlevel" and the other tpu.preprocess values, at both rungs of
a ladder; resolve_c2f; the kernels a step calls in each C2f form; and the
`.pt` / `.onnx` readers (the cases of tests/test_weights.py), down to an
engine serving each file as it serves the `.npz`; and every example config
booting (the mesh ones refused)."""

import copy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import weights as jax_weights  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jax_model  # noqa: E402
from zero_latency_yolo_tpu.ops import preprocess as jax_pre  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import weights as pt_weights  # noqa: E402
from zero_latency_yolo_tpu_torch.models import yolov8 as pt_model  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import preprocess as pt_pre  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

# ----------------------------------------------------------------- preprocess

_SIZES = np.array([[72, 96], [40, 90], [60, 33]], np.int32)  # (h, w) in 72x96


def _frames():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (3, 72, 96, 3), dtype=np.uint8)


@pytest.mark.parametrize("size", [64, 32])
@pytest.mark.parametrize("name,dtype", [
    ("letterbox_batch", None), ("stretch_batch", None),
    ("letterbox_batch_mxu_s2d", "float32"),
    ("letterbox_batch_mxu_s2d", "bfloat16"),
    ("letterbox_batch_rowcol", "float32")])
def test_preprocess_matches_jax(name, dtype, size):
    """Each preprocess function against the JAX one on frames padded into a
    72x96 bucket with three true sizes (edge clipping, the FILL border, the
    space-to-depth channel order), within 1e-5."""
    fr, hs, ws = _frames(), _SIZES[:, 0].copy(), _SIZES[:, 1].copy()
    extra_j = () if dtype is None else (getattr(jnp, dtype),)
    extra_p = () if dtype is None else (getattr(torch, dtype),)
    want = np.asarray(getattr(jax_pre, name)(
        jnp.asarray(fr), jnp.asarray(hs), jnp.asarray(ws), size, *extra_j))
    got = getattr(pt_pre, name)(torch.from_numpy(fr), torch.from_numpy(hs),
                                torch.from_numpy(ws), size, *extra_p).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [64, 32])
def test_rowcol_letterbox_bf16_within_one_bf16_rounding_of_jax(size):
    """letterbox_batch_rowcol's lerps in bf16: XLA keeps them in f32 inside
    its fusion and rounds where it stores, PyTorch rounds every operation;
    the two stay within one bf16 rounding of a value in [0, 255] (1.0 at
    128..255), divided by 255; and within two (the row stage's and the
    column stage's) of letterbox_batch in f32."""
    fr, hs, ws = _frames(), _SIZES[:, 0].copy(), _SIZES[:, 1].copy()
    want = np.asarray(jax_pre.letterbox_batch_rowcol(
        jnp.asarray(fr), jnp.asarray(hs), jnp.asarray(ws), size, jnp.bfloat16))
    got = pt_pre.letterbox_batch_rowcol(
        torch.from_numpy(fr), torch.from_numpy(hs), torch.from_numpy(ws),
        size, torch.bfloat16).numpy()
    f32 = pt_pre.letterbox_batch(torch.from_numpy(fr), torch.from_numpy(hs),
                                 torch.from_numpy(ws), size).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1.0 / 255, rtol=0)
    np.testing.assert_allclose(got, f32, atol=2.0 / 255, rtol=0)


# ------------------------------------------------------------- step variants

def _cfg(extra_tpu=None):
    tpu = {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
           "batch_buckets": [2, 4], "frame_buckets": [[96, 128]],
           "pre_nms_topk": 64, "serve_sizes": [64, 32]}
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


def _assert_results_close(got, want):
    """The 1e-3 gate of tests/test_model_parity.py:54-63 on engine results:
    counts and classes equal, boxes and scores within 1e-3."""
    assert len(got) == len(want)
    assert sum(len(r.detections) for r in want) > 0, "vacuous: no detections"
    for g, w in zip(got, want):
        assert (g.client_id, g.frame_id, g.serve_size) == (
            w.client_id, w.frame_id, w.serve_size)
        assert len(g.detections) == len(w.detections)
        for dg, dw in zip(g.detections, w.detections):
            assert dg.class_id == dw.class_id
            np.testing.assert_allclose(
                [dg.x, dg.y, dg.width, dg.height, dg.confidence],
                [dw.x, dw.y, dw.width, dw.height, dw.confidence], atol=1e-3)


VARIANTS = {
    "split": {"c2f": "split"},
    "s2d": {"stem": "s2d"},
    "s2d_gather": {"stem": "s2d", "preprocess": "letterbox"},
    "perlevel": {"select": "perlevel"},
    "letterbox": {"preprocess": "letterbox"},
    "stretch": {"preprocess": "stretch"},
    "stretch_perlevel": {"preprocess": "stretch", "select": "perlevel"},
    "all": {"c2f": "split", "stem": "s2d", "select": "perlevel"},
}


@pytest.mark.parametrize("rung", [64, 32])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_step_variant_matches_jax(variant, rung):
    """The port's engine and the JAX engine with the same flags, at each
    rung of the ladder, on the same frames and parameters."""
    tree = _spread_params(2)
    extra = VARIANTS[variant]
    jeng = jax_engine.InferenceEngine(JaxConfig.from_dict(_cfg(extra)),
                                      params=tree)
    peng = pt_engine.InferenceEngine(ServerConfig.from_dict(_cfg(extra)),
                                     params=tree, device="cpu")
    jeng._serve_size = peng._serve_size = rung
    want = jeng.infer_batch(_requests(jax_engine.InferenceRequest, 5))
    got = peng.infer_batch(_requests(pt_engine.InferenceRequest, 5))
    assert {r.serve_size for r in got} == {rung}
    _assert_results_close(got, want)


def test_stem_s2d_refuses_a_stretch_preprocess():
    """stem="s2d" needs a letterbox preprocess: refused when the step is
    built, as the JAX engine refuses it."""
    eng = pt_engine.InferenceEngine(
        ServerConfig.from_dict(_cfg({"stem": "s2d", "preprocess": "stretch"})),
        params=_spread_params(0), device="cpu")
    with pytest.raises(ValueError, match="letterbox"):
        eng.infer_batch(_requests(pt_engine.InferenceRequest, 1))


def test_stem_s2d_refuses_unfolded_params():
    placed = pt_weights.place_params(
        pt_weights.params_from_jax(_spread_params(0)), "cpu", torch.float32)
    m0 = dict(placed["m0"])
    del m0["b"]
    with pytest.raises(ValueError, match="BN-folded"):
        pt_model._stem_s2d(m0, torch.zeros(1, 4, 4, 12))


@pytest.mark.parametrize("flag", ["auto", "slice", "split"])
def test_resolve_c2f_matches_jax(flag):
    for variant in ("yolov8n", "yolov8s", "yolov8p"):
        for size in (320, 416, 512, 640):
            for dtype in ("bfloat16", "float32"):
                for batch in (1, 8, 16, 32, 64):
                    assert (pt_engine.resolve_c2f(flag, batch, variant, size,
                                                  dtype)
                            == jax_engine.resolve_c2f(flag, batch, variant,
                                                      size, dtype))


@pytest.mark.parametrize("form,conv1x1,bias_silu", [
    ("slice", 24, 39), ("split", 50, 47), ("s2d", 24, 39)])
def test_kernel_calls_of_each_form(form, conv1x1, bias_silu, monkeypatch):
    """The 1x1 GEMM and bias+SiLU calls of one yolov8n step in each form:
    the split C2f runs cv1 as two convs and cv2 as 2 + n convs a block and
    adds one bias+SiLU tail a block (8 blocks, 10 bottlenecks); the s2d stem
    calls the same kernels as the k3 s2 stem. tpu.c2f="auto" resolves to
    split at batch 32 for yolov8n at 416 in bf16, and places the pieces."""
    tpu = {"variant": "yolov8n", "batch_buckets": [1, 32],
           "frame_buckets": [[64, 64]], "dtype": "float32"}
    if form == "split":
        tpu["c2f"] = "split"
    if form == "s2d":
        tpu["stem"] = "s2d"
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 64, "model_height": 64}, "tpu": tpu})
    tree = pt_model.init_params(0, pt_model.get_spec("yolov8n", 4))
    eng = pt_engine.InferenceEngine(cfg, params=tree, device="cpu")
    counts = {"conv1x1": 0, "bias_silu": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(pt_model, "conv1x1_bias_act_plain",
                        counted("conv1x1", pt_model.conv1x1_bias_act_plain))
    monkeypatch.setattr(pt_model, "bias_silu_plain",
                        counted("bias_silu", pt_model.bias_silu_plain))
    frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    hw = torch.full((1,), 64, dtype=torch.int32)
    eng._build_step(1, plain=True)(eng._params, frames, hw, hw,
                                   eng._class_weights, 0.5, 0.45)
    assert counts == {"conv1x1": conv1x1, "bias_silu": bias_silu}
    assert ("cv1_pieces" in eng._params["m2"]) == (form == "split")
    auto = copy.deepcopy(cfg)
    auto.tpu.dtype, auto.detection.model_width = "bfloat16", 416
    auto.detection.model_height = 416
    eng = pt_engine.InferenceEngine(auto, params=tree, device="cpu")
    assert eng._c2f_form(32, 416) == "split"
    assert eng._c2f_form(1, 416) == ("split" if form == "split" else "slice")
    assert "cv1_pieces" in eng._params["m2"]


# -------------------------------------------------------------- weight files

def test_onnx_initializer_parser(tmp_path):
    """tests/test_weights.py's hand-built ONNX bytes: the port reads the
    initializer and turns OIHW into HWIO, as the JAX reader does."""
    w = np.random.default_rng(0).normal(size=(8, 3, 3, 3)).astype(np.float32)
    b = np.zeros(8, np.float32)
    path = tmp_path / "tiny.onnx"
    path.write_bytes(chip_smoke.onnx_initializers_bytes({
        "model.0.conv.weight": w, "model.0.conv.bias": b}))
    tensors = pt_weights.read_onnx_initializers(str(path))
    np.testing.assert_array_equal(tensors["model.0.conv.weight"], w)
    params = pt_weights.from_onnx(str(path))
    assert params["m0"]["w"].shape == (3, 3, 3, 8)
    np.testing.assert_array_equal(
        np.transpose(params["m0"]["w"], (3, 2, 0, 1)), w)
    np.testing.assert_array_equal(params["m0"]["b"], b)
    want = jax_weights.from_onnx(str(path))
    np.testing.assert_array_equal(params["m0"]["w"], want["m0"]["w"])


def test_onnx_placeholder_rejected(tmp_path):
    path = tmp_path / "fake.onnx"
    path.write_bytes(b"ONNX MODEL PLACEHOLDER")
    with pytest.raises(ValueError):
        pt_weights.from_onnx(str(path))


def test_load_model_fallbacks(tmp_path):
    """A placeholder .onnx loads as simulation; a valid .npz as the model."""
    path = tmp_path / "yolo_nano_cs16.onnx"
    path.write_bytes(b"ONNX MODEL PLACEHOLDER")
    params, spec, sim = pt_weights.load_model(str(path), "yolov8p", 4)
    assert sim and params
    good = tmp_path / "good.npz"
    np.savez(good, **pt_weights.flatten(pt_model.init_params(0, spec)))
    _, _, sim2 = pt_weights.load_model(str(good), "yolov8p", 4)
    assert not sim2


def _ultra_twin():
    from zero_latency_yolo_tpu.models.ultra import UltralyticsTwin
    spec = jax_model.get_spec("yolov8p", 4)
    return UltralyticsTwin(spec).randomize(7).eval(), spec


def _port_decoded(tree, x):
    spec = pt_model.get_spec("yolov8p", 4)
    params = pt_weights.place_params(pt_weights.params_from_jax(tree), "cpu",
                                     torch.float32)
    with torch.inference_mode():
        return pt_model.forward_decoded(params, spec,
                                        torch.from_numpy(x)).numpy()


def test_real_torch_state_dict_loads_and_matches():
    """A real nn.Module state_dict (num_batches_tracked, dfl.conv.weight,
    bare Conv2d tips) converts, BN-folds, and matches the torch model's own
    decoded output within 1e-3; the tree equals the JAX conversion's."""
    from zero_latency_yolo_tpu.models.ultra import decoded_reference
    model, _ = _ultra_twin()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert any("num_batches_tracked" in k for k in sd)
    assert any(".dfl." in k for k in sd)
    params = pt_weights.from_ultralytics_state_dict(sd)
    want_tree = jax_weights.from_ultralytics_state_dict(sd)
    got_flat = pt_weights.flatten(params)
    want_flat = jax_weights.flatten(want_tree)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k])
    x = np.random.default_rng(3).uniform(
        0.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(_port_decoded(params, x),
                               decoded_reference(model, x),
                               atol=1e-3, rtol=1e-3)


def test_real_torch_checkpoint_file_loads(tmp_path):
    """torch.save'd state_dict (the .pt drop-in flow) loads end to end."""
    model, spec = _ultra_twin()
    path = tmp_path / "real.pt"
    torch.save(model.state_dict(), str(path))
    params, spec2, simulation = pt_weights.load_model(str(path), "yolov8p", 4)
    assert not simulation
    assert np.asarray(params["m0"]["w"]).shape[3] == spec.ch(64)


def test_real_onnx_export_loads_and_matches(tmp_path):
    """A real torch.onnx.export of the fused model parses through the
    port's protobuf walker and matches the torch model within 1e-3."""
    from zero_latency_yolo_tpu.models.ultra import decoded_reference, export_onnx
    model, _ = _ultra_twin()
    x = np.random.default_rng(5).uniform(
        0.0, 1.0, (1, 64, 64, 3)).astype(np.float32)
    want = decoded_reference(model, x)
    model.fuse()
    path = tmp_path / "real_export.onnx"
    export_onnx(model, str(path), 64)
    tensors = pt_weights.read_onnx_initializers(str(path))
    assert any(k.startswith("model.0.conv.") for k in tensors)
    params, _, simulation = pt_weights.load_model(str(path), "yolov8p", 4)
    assert not simulation
    np.testing.assert_allclose(_port_decoded(params, x), want,
                               atol=1e-3, rtol=1e-3)


def test_torch_checkpoint_refuses_pickled_objects(tmp_path, monkeypatch):
    """Pickled objects are refused unless ZLT_TRUST_PICKLE=1 (the upload
    endpoint and the watcher load .pt files)."""
    path = tmp_path / "evil.pt"
    torch.save({"model": object()}, str(path))
    monkeypatch.delenv("ZLT_TRUST_PICKLE", raising=False)
    with pytest.raises(ValueError, match="pickled objects"):
        pt_weights.load_torch_checkpoint(str(path))
    params, _, sim = pt_weights.load_model(str(path), "yolov8p", 4)
    assert sim
    # The operator's opt-in lifts the refusal (this file holds no weights).
    monkeypatch.setenv("ZLT_TRUST_PICKLE", "1")
    assert pt_weights.load_torch_checkpoint(str(path)) == {}


@pytest.mark.parametrize("ext", ["pt", "onnx"])
def test_engine_serves_pt_and_onnx_as_npz(ext, tmp_path):
    """An engine booted on a `.pt` state_dict or an `.onnx` initializer file
    serves the model (not simulation), with the `.npz` engine's step output
    to the last bit; `maybe_reload` swaps such a file in."""
    tree = _spread_params(4)
    paths = chip_smoke.write_weight_files(tree, tmp_path)

    def engine(path):
        d = _cfg()
        d["model_path"] = path
        return pt_engine.InferenceEngine(ServerConfig.from_dict(d),
                                         device="cpu")
    ref, eng = engine(paths["npz"]), engine(paths[ext])
    assert not ref.simulation and not eng.simulation
    assert eng.status()["model_file"] == f"model.{ext}"
    reqs = _requests(pt_engine.InferenceRequest, 4)
    want = ref.dispatch(reqs).out.numpy()
    got = eng.dispatch(reqs).out.numpy()
    assert np.array_equal(got, want)
    assert want[:, 0].sum() > 0, "vacuous: no detections"
    # Hot reload: an engine on another file picks this one up.
    other = _spread_params(5)
    np.savez(tmp_path / "other.npz", **pt_weights.flatten(other))
    swap = engine(str(tmp_path / "other.npz"))
    swap.config.model_path = paths[ext]
    assert swap.maybe_reload()
    assert np.array_equal(swap.dispatch(reqs).out.numpy(), want)


_EXAMPLES = Path(__file__).resolve().parent.parent / "configs" / "examples"


@pytest.mark.parametrize("name", sorted(p.name for p in _EXAMPLES.glob(
    "*.json")))
def test_example_config_boots(name):
    """Every config of configs/examples/ boots the port's engine on its
    real weights (not simulation), the two dp2 mesh configs included: with
    the CPU alone they serve single-device, reporting the mesh they asked
    for. The hardened one is refused by the config's placeholder-token
    gate."""
    if name == "server-hardened.json":
        with pytest.raises(ValueError, match="placeholder"):
            ServerConfig.load(str(_EXAMPLES / name), create_if_missing=False)
        return
    cfg = ServerConfig.load(str(_EXAMPLES / name), create_if_missing=False)
    cfg.model_path = str(_EXAMPLES.parent.parent / cfg.model_path)
    eng = pt_engine.InferenceEngine(cfg, device="cpu")
    assert not eng.simulation
    assert eng.mesh is None and eng.status()["mesh_requested"] == (
        f"{cfg.tpu.mesh_data}x{cfg.tpu.mesh_model}")
    assert eng.serve_sizes[0] == cfg.detection.model_width
    assert set(eng.serve_sizes) == {cfg.detection.model_width} | {
        int(s) for s in cfg.tpu.serve_sizes}
