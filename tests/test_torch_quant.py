"""The port's int8 backbone (tpu.quantize_int8) against the JAX package's,
on the CPU at a small size (yolov8p, 64 px): weight quantization bit for
bit, the plain int8 conv against XLA's int32 conv, activation rounding on
exact ties, activation calibration, the int8 forward and the int8 engine.

The JAX package's int8 step is chaotic under f32 rounding: an activation
that lies within a rounding of a half step quantizes up in one run and down
in another, and that step moves every later conv's input. Its own jitted
and eager runs differ for that reason (calibrated scales by up to 1.6% at
yolov8n 416, tests/torch_fixtures/make_jax_fixture.py). The port runs op by
op, as JAX does without jit, and is held bit for bit or within a few f32
roundings to the JAX package run the same way; against the jitted JAX run
it is held to the JAX package's own eager-against-jit spread."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jy  # noqa: E402
from zero_latency_yolo_tpu.ops import quant as jq  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import yolov8 as ty  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    flatten, params_from_jax, place_params)
from zero_latency_yolo_tpu_torch.ops import _build  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import conv_int8_cuda as ci  # noqa: E402
from zero_latency_yolo_tpu_torch.ops import quant as tq  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

SIZE = 64
SPEC_J = jy.get_spec("yolov8p", 4)
SPEC_T = ty.get_spec("yolov8p", 4)


def _tree(seed=0):
    return ty.init_params(seed, SPEC_T, folded=True)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _sample(seed=2, n=2):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, SIZE, SIZE, 3)).astype(np.float32)


def _placed(qtree):
    return place_params(params_from_jax(qtree), "cpu", torch.float32)


def _jax_x_scales(qparams):
    return {k[:-len("/x_scale")]: float(v)
            for k, v in flatten(jax.tree.map(np.asarray, qparams)).items()
            if k.endswith("/x_scale")}


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("variant", ["yolov8p", "yolov8n"])
def test_quantize_params_bit_equal_to_jax(variant):
    spec = ty.get_spec(variant, 4)
    tree = ty.init_params(3, spec, folded=True)
    want = flatten(jax.tree.map(np.asarray, jq.quantize_params(_jax_tree(tree))))
    got = flatten(tq.quantize_params(tree))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # On tensors the same bits come back as tensors.
    t = tq.quantize_conv({"w": torch.from_numpy(tree["m1"]["w"]),
                          "b": torch.from_numpy(tree["m1"]["b"])})
    assert t["w_q"].dtype == torch.int8
    np.testing.assert_array_equal(t["w_q"].numpy(), want["m1/w_q"])
    np.testing.assert_array_equal(t["w_scale"].numpy(), want["m1/w_scale"])


def test_head_and_stem_not_quantized():
    flat = flatten(tq.quantize_params(_tree()))
    assert not any(k.startswith("m22") and "w_q" in k for k in flat)
    assert "m0/w" in flat and "m0/w_q" not in flat
    assert "m1/w_q" in flat and "m1/w_scale" in flat
    assert flat["m1/w_q"].dtype == np.int8


def test_quantize_roundtrip_error_bounded():
    params = ty.init_params(0, ty.get_spec("yolov8n", 4), folded=True)
    dq = flatten(tq.dequantize_params(tq.quantize_params(params)))
    for key, orig in flatten(params).items():
        got = dq[key]
        if orig.ndim == 4 and not key.startswith(("m22", "m0")):
            # per-channel int8: worst-case error half a quantization step
            step = np.abs(orig).max(axis=(0, 1, 2)) / 127.0
            assert (np.abs(got - orig) <= step / 2 + 1e-7).all(), key
        else:
            np.testing.assert_array_equal(got, orig)


def test_place_params_lays_out_int8_blocks():
    """Each int8 conv: a (Cout, Kp) int8 K-major matrix in (ky, kx, cin)
    order with zero K padding, its kernel size, f32 scales; no 1x1 matrix
    and no split-C2f pieces."""
    q = tq.quantize_params(_tree())
    placed = place_params(params_from_jax(q), "cpu", torch.float32,
                          c2f_split=True)
    m1 = placed["m1"]
    w_hwio = q["m1"]["w_q"]
    k, _, cin, cout = w_hwio.shape
    assert m1["k"] == 3 and m1["w_q"].dtype == torch.int8
    assert m1["w_q"].shape == (cout, ci.padded_k(3, cin))
    assert m1["w_q"].shape[1] % ci.K_STEP == 0
    want = w_hwio.transpose(3, 0, 1, 2).reshape(cout, -1)
    np.testing.assert_array_equal(m1["w_q"][:, :want.shape[1]].numpy(), want)
    assert not m1["w_q"][:, want.shape[1]:].any()
    assert m1["w_scale"].dtype == torch.float32 and "w_mm" not in m1
    cv1 = placed["m2"]["cv1"]
    assert "w_q" in cv1 and cv1["k"] == 1 and "w_mm" not in cv1
    assert "cv1_pieces" not in placed["m2"]
    # The head stays as it was: its 1x1 tips keep their matrices.
    assert "w_mm" in placed["m22"]["cv2"][0][2]
    np.testing.assert_array_equal(
        ci.unpack_weight(m1["w_q"], 3, cin).numpy(),
        w_hwio.transpose(3, 2, 0, 1))


def test_params_from_jax_takes_the_jax_quantized_tree():
    qj = jq.quantize_params(_jax_tree(_tree()))
    jq.calibrate_activations(qj, SPEC_J, _sample())
    dev = params_from_jax(jax.tree.map(np.asarray, qj))
    assert dev["m1"]["w_q"].dtype == torch.int8
    assert dev["m1"]["x_scale"].shape == ()
    assert float(dev["m1"]["x_scale"]) == float(qj["m1"]["x_scale"])
    with pytest.raises(ValueError, match="int8"):
        params_from_jax({"m1": {"w_q": np.zeros((3, 3, 8, 8), np.int32),
                                "w_scale": np.ones(8), "b": np.zeros(8)}})


# ------------------------------------------------------------ the conv

@pytest.mark.parametrize("k,stride,cin", [(1, 1, 16), (1, 1, 48), (1, 2, 24),
                                          (3, 1, 16), (3, 2, 16), (3, 1, 32),
                                          (3, 2, 40)])
def test_plain_int8_conv_bit_equal_to_xla(k, stride, cin):
    """int32 accumulators of the plain version (float64 conv, rounded) equal
    lax.conv_general_dilated over int8 with int32 accumulation, extremes
    included (all +-127)."""
    rng = np.random.default_rng(k * 100 + stride * 10 + cin)
    xq = rng.integers(-127, 128, (2, 13, 11, cin)).astype(np.int8)
    xq[0, :3] = 127
    wq = rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8)
    wq[..., 0] = 127
    pad = (k - 1) // 2
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    w = ci.pack_weight(torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()))
    got = ci.conv_int8_acc(torch.from_numpy(xq.astype(np.float32)),
                           torch.tensor(1.0), w, k, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 100000  # the extremes were reached


def test_activation_quant_rounds_ties_to_even_as_jnp_round():
    s = np.float32(0.5)
    x = np.array([2.5, -3.5, 0.5, 1.5, -0.5, 200.0, -200.0, 63.25],
                 np.float32) * s
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / s), -127, 127))
    got = ci.quantize_activations(torch.from_numpy(x), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:2].tolist() == [2.0, -4.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_int8_conv_matches_jax_conv_branch(dtype):
    """One int8 block through the port's _conv and the JAX _conv (static
    and dynamic scale, act on and off, a channel slice as input): the
    quantized values are the same, so the f32 tails agree to a few
    roundings (exp differs between XLA and PyTorch in the last bit)."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.2, (3, 3, 16, 24)).astype(np.float32)
    b = rng.normal(0, 0.1, 24).astype(np.float32)
    qj = jq.quantize_conv({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    qt = place_params(params_from_jax({"c": tq.quantize_conv(
        {"w": w, "b": b})}), "cpu", torch.float32)["c"]
    x = rng.normal(0, 1, (2, 10, 10, 32)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)[..., 16:]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    for static in (False, True):
        if static:
            qj = dict(qj, x_scale=jnp.float32(0.02))
            qt = dict(qt, x_scale=torch.tensor(0.02))
        for act in (True, False):
            for stride in (1, 2):
                want = np.asarray(jy._conv(qj, xj, stride=stride, act=act,
                                           dtype=jdt).astype(jnp.float32))
                got = ty._conv(qt, xt, stride=stride, act=act).float().numpy()
                tol = 1e-6 if dtype == torch.float32 else 2 ** -7
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_int8_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 16)
    w = ci.pack_weight(torch.zeros(8, 3, 3, 16, dtype=torch.int8))
    ws, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="unsupported device"):
        ci.conv_int8(x.to("meta"), torch.tensor(1.0), w, ws, b, 3, 1)
    assert ci.conv_int8(x, torch.tensor(1.0), w, ws, b, 3, 2).shape == (
        1, 2, 2, 8)
    for bad in (dict(k=5), dict(stride=3), dict(w=w[:, :-32].contiguous()),
                dict(ws=ws.double()), dict(xs=torch.ones(2))):
        args = dict(x=x, xs=torch.tensor(1.0), w=w, ws=ws, b=b, k=3,
                    stride=1)
        args.update(bad)
        with pytest.raises(ValueError):
            ci._launch(args["x"], args["xs"], args["w"], args["ws"],
                       args["b"], args["k"], args["stride"], True, False)


# ------------------------------------------------------------ calibration

def test_calibration_equals_the_jax_calibration_run_op_by_op():
    """f32: the port's calibrated scales equal, bit for bit, the JAX
    package's calibrate_activations run without jit (the same function, op
    by op, as the port runs it)."""
    tree, x = _tree(), _sample()
    qj = jq.quantize_params(_jax_tree(tree))
    with jax.disable_jit():
        nj = jq.calibrate_activations(qj, SPEC_J, x)
    placed = _placed(tq.quantize_params(tree))
    nt = tq.calibrate_activations(placed, SPEC_T, x)
    want, got = _jax_x_scales(qj), tq.x_scales(placed)
    assert nj == nt == len(want) == len(list(tq.int8_blocks(placed))) > 10
    assert got.keys() == want.keys()
    rel = {k: abs(got[k] / want[k] - 1) for k in want}
    print(f"port against JAX op by op: {sum(r == 0 for r in rel.values())}/"
          f"{len(rel)} scales equal, max relative difference "
          f"{max(rel.values()):.3g}")
    assert max(rel.values()) <= 1e-5


def test_calibration_against_jitted_jax_within_its_own_spread():
    """Against the JAX package's jitted calibration: the first int8 conv
    (its input the unquantized stem's output) within 1e-5 relative, and
    every conv within twice the spread of JAX's own eager calibration
    against its jitted one on the same inputs."""
    tree, x = _tree(), _sample()
    qj = jq.quantize_params(_jax_tree(tree))
    jq.calibrate_activations(qj, SPEC_J, x)
    qe = jq.quantize_params(_jax_tree(tree))
    with jax.disable_jit():
        jq.calibrate_activations(qe, SPEC_J, x)
    placed = _placed(tq.quantize_params(tree))
    tq.calibrate_activations(placed, SPEC_T, x)
    jit, eager, got = _jax_x_scales(qj), _jax_x_scales(qe), tq.x_scales(placed)
    spread = max(abs(eager[k] / jit[k] - 1) for k in jit)
    rel = {k: abs(got[k] / jit[k] - 1) for k in jit}
    print(f"JAX eager against jit: max relative {spread:.3g}; port against "
          f"jit: max relative {max(rel.values()):.3g}")
    assert rel["m1"] <= 1e-5
    assert max(rel.values()) <= 2 * spread + 1e-5


def test_calibration_formula_and_dtype():
    """x_scale = max(seen, 1e-6) * margin / 127 in float64, then f32, from
    the maxima of a dynamic-quant forward; bf16 calibrates too."""
    placed = _placed(tq.quantize_params(_tree()))
    seen = []

    def spy(p, x, stride=1, act=True, plain=False):
        if "w_q" in p:
            seen.append((p, float(x.float().abs().max())))
        return ty._conv(p, x, stride=stride, act=act, plain=plain)

    x = _sample()
    ty.forward_raw(placed, SPEC_T, torch.from_numpy(x), conv_fn=spy)
    tq.calibrate_activations(placed, SPEC_T, x, margin=1.25)
    for p, m in seen:
        assert float(p["x_scale"]) == float(np.float32(max(m, 1e-6) * 1.25
                                                       / 127.0))
    bf = place_params(params_from_jax(tq.quantize_params(_tree())), "cpu",
                      torch.bfloat16)
    assert tq.calibrate_activations(bf, SPEC_T, x, dtype=torch.bfloat16) > 10
    assert all(b["x_scale"].dtype == torch.float32
               for _, b in tq.int8_blocks(bf))


def test_set_x_scales_carries_a_calibration_across():
    qj = jq.quantize_params(_jax_tree(_tree()))
    jq.calibrate_activations(qj, SPEC_J, _sample())
    placed = _placed(tq.quantize_params(_tree()))
    assert tq.set_x_scales(placed, _jax_x_scales(qj)) > 10
    assert tq.x_scales(placed) == _jax_x_scales(qj)
    with pytest.raises(ValueError, match="int8 blocks"):
        tq.set_x_scales(placed, {"m1": 1.0})


# ------------------------------------------------------------ forward

def test_forward_matches_jax_with_its_calibrated_tree():
    """The JAX package's quantized and calibrated tree, carried across:
    the port's plain int8 forward_decoded against JAX's (op by op), within
    1e-3 on boxes (pixels) and class probabilities; and every int8 conv's
    quantized input compared (printed: how many differ)."""
    x = _sample(seed=4)
    qj = jq.quantize_params(_jax_tree(_tree()))
    jq.calibrate_activations(qj, SPEC_J, _sample())
    placed = _placed(jax.tree.map(np.asarray, qj))
    qvals_j, qvals_t = [], []

    def rec_j(p, xx, stride=1, act=True, dtype=jnp.float32, **kw):
        if "w_q" in p:
            qvals_j.append(np.asarray(jnp.clip(jnp.round(
                xx.astype(jnp.float32) / p["x_scale"]), -127, 127)))
        return jy._conv(p, xx, stride=stride, act=act, dtype=dtype, **kw)

    def rec_t(p, xx, stride=1, act=True, plain=False):
        if "w_q" in p:
            qvals_t.append(ci.quantize_activations(xx, p["x_scale"]).numpy())
        return ty._conv(p, xx, stride=stride, act=act, plain=plain)

    want = np.asarray(jy.decode_outputs(SPEC_J, jy.forward_raw(
        qj, SPEC_J, jnp.asarray(x), conv_fn=rec_j)))
    got = ty.decode_outputs(SPEC_T, ty.forward_raw(
        placed, SPEC_T, torch.from_numpy(x), conv_fn=rec_t)).numpy()
    differ = sum(int((a != b).sum()) for a, b in zip(qvals_j, qvals_t))
    total = sum(a.size for a in qvals_j)
    print(f"int8 activations that differ from JAX's: {differ} of {total}; "
          f"max output difference {np.abs(got - want).max():.3g}")
    assert len(qvals_j) == len(qvals_t) == 44
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_static_calibration_matches_dynamic():
    """As tests/test_quant.py: static scales calibrated on the same
    distribution stay close to dynamic quant."""
    x = _sample()
    dyn = ty.forward_decoded(_placed(tq.quantize_params(_tree())), SPEC_T,
                             torch.from_numpy(x)).numpy()
    static_p = _placed(tq.quantize_params(_tree()))
    assert tq.calibrate_activations(static_p, SPEC_T, x) > 10
    static = ty.forward_decoded(static_p, SPEC_T, torch.from_numpy(x)).numpy()
    assert np.abs(dyn[..., 4:] - static[..., 4:]).mean() < 0.03
    assert np.isfinite(static).all()


def test_int8_forward_close_to_f32():
    """As tests/test_quant.py: int8 is lossy, probabilities stay close and
    boxes sane."""
    spec = ty.get_spec("yolov8n", 4)
    tree = ty.init_params(0, spec, folded=True)
    x = torch.from_numpy(_sample(seed=1, n=1))
    ref = ty.forward_decoded(place_params(params_from_jax(tree), "cpu",
                                          torch.float32), spec, x).numpy()
    got = ty.forward_decoded(_placed(tq.quantize_params(tree)), spec,
                             x).numpy()
    assert np.abs(ref[..., 4:] - got[..., 4:]).mean() < 0.05
    assert np.median(np.abs(ref[..., :4] - got[..., :4]) / SIZE) < 0.05


def test_c2f_split_falls_back_to_slice_for_int8_blocks():
    """c2f='split' with int8 blocks runs the slice form (no pieces are laid
    out for them): the same result, and the same int8 conv calls."""
    placed = _placed(tq.quantize_params(_tree()))
    x = torch.from_numpy(_sample())
    calls = {}

    def counting(form):
        def conv(p, xx, stride=1, act=True, plain=False):
            calls[form] = calls.get(form, 0) + ("w_q" in p)
            return ty._conv(p, xx, stride=stride, act=act, plain=plain)
        return conv
    a = ty.forward_raw(placed, SPEC_T, x, c2f="slice",
                       conv_fn=counting("slice"))
    b = ty.forward_raw(placed, SPEC_T, x, c2f="split",
                       conv_fn=counting("split"))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert calls["slice"] == calls["split"] == 44


# ------------------------------------------------------------ engine

def _engine_cfg(extra_tpu=None, **top):
    tpu = {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
           "batch_buckets": [1, 2], "frame_buckets": [[96, 96]],
           "pre_nms_topk": 64, "quantize_int8": True}
    tpu.update(extra_tpu or {})
    return {"model_path": "/nonexistent.npz", "confidence_threshold": 0.3,
            "nms_threshold": 0.45,
            "detection": {"model_width": 64, "model_height": 64},
            "tpu": tpu, **top}


def _req(cls, i, seed):
    rng = np.random.default_rng(seed)
    return cls(client_id=i + 1, frame_id=i, timestamp=i, width=96, height=64,
               data=rng.integers(0, 256, (64, 96, 3), np.uint8))


def _rows(results):
    return [[(d.x, d.y, d.width, d.height, d.confidence, d.class_id)
             for d in r.detections] for r in results]


def test_int8_engine_path():
    """tests/test_engine.py's int8 case on the port's engine, device='cpu':
    quantized at construction, calibrated, serving."""
    eng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                    params=_tree(), device="cpu")
    out = eng.infer_batch([_req(pt_engine.InferenceRequest, 1, 11)])
    assert len(out) == 1
    for d in out[0].detections:
        assert 0 <= d.x <= 1 and d.confidence > 0
    assert eng._params["m1"]["w_q"].dtype == torch.int8
    assert len(tq.x_scales(eng._params)) == 44


def test_int8_engine_equals_the_jax_int8_engine_run_op_by_op():
    """The port's int8 f32 engine and the JAX package's on the same tree,
    the JAX engine without jit: the same calibrated scales, and the same
    detections within the 1e-3 gate."""
    tree = _tree(5)
    with jax.disable_jit():
        jeng = jax_engine.InferenceEngine(
            JaxConfig.from_dict(_engine_cfg({"nms": "xla"})), params=tree)
        want = jeng.infer_batch([_req(jax_engine.InferenceRequest, i, 30 + i)
                                 for i in range(2)])
    peng = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                     params=tree, device="cpu")
    got = peng.infer_batch([_req(pt_engine.InferenceRequest, i, 30 + i)
                            for i in range(2)])
    assert tq.x_scales(peng._params) == _jax_x_scales(jeng._params)
    assert sum(len(r) for r in _rows(want)) > 0
    for g, w in zip(_rows(got), _rows(want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a[5] == b[5]
            np.testing.assert_allclose(a[:5], b[:5], atol=1e-3)


@pytest.mark.parametrize("c2f", ["split", "auto"])
def test_int8_engine_with_split_c2f_takes_the_slice_form(c2f):
    """An int8 engine whose C2f form resolves to split (explicitly, or auto
    at (yolov8n, 416, bf16) batch 32) lays out no pieces and serves the
    slice form: its steps equal a slice engine's."""
    tree = _tree(2)
    cfg = _engine_cfg({"c2f": c2f, "batch_buckets": [1, 32]})
    if c2f == "auto":  # an auto table split entry at this test's size
        pt_engine.C2F_AUTO_SPLIT[("yolov8p", 64, "float32")] = frozenset({32})
    try:
        eng = pt_engine.InferenceEngine(ServerConfig.from_dict(cfg),
                                        params=tree, device="cpu")
        assert eng._c2f_form(32, 64) == "split"
        assert "cv1_pieces" not in eng._params["m2"]
        ref = pt_engine.InferenceEngine(
            ServerConfig.from_dict(_engine_cfg({"batch_buckets": [1, 32]})),
            params=tree, device="cpu")
        reqs = [_req(pt_engine.InferenceRequest, i, 40 + i) for i in range(3)]
        assert _rows(eng.infer_batch(reqs)) == _rows(ref.infer_batch(reqs))
        eng.warmup(batches=[32])
    finally:
        pt_engine.C2F_AUTO_SPLIT.pop(("yolov8p", 64, "float32"), None)


def test_maybe_reload_requantizes_on_the_dispatch_thread(tmp_path):
    """A staged .npz is quantized and calibrated when the dispatch thread
    applies it: the engine then serves what a fresh int8 engine of the new
    file serves."""
    path = tmp_path / "m.npz"
    a, b = _tree(0), _tree(1)
    np.savez(path, **flatten(a))
    cfg = ServerConfig.from_dict(_engine_cfg(model_path=str(path)))
    eng = pt_engine.InferenceEngine(cfg, device="cpu")
    assert not eng.simulation
    reqs = [_req(pt_engine.InferenceRequest, i, 50 + i) for i in range(2)]
    np.savez(path, **flatten(b))
    import os
    import time
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 10 ** 9))
    calls = []
    real = pt_engine.quantize_params

    def spy(tree):
        calls.append(tree)
        return real(tree)
    pt_engine.quantize_params = spy
    try:
        assert eng.maybe_reload()
        assert not calls                       # staged only, on the host
        got = _rows(eng.infer_batch(reqs))
        assert len(calls) == 1
    finally:
        pt_engine.quantize_params = real
    fresh = pt_engine.InferenceEngine(ServerConfig.from_dict(_engine_cfg()),
                                      params=b, device="cpu")
    assert got == _rows(fresh.infer_batch(reqs))
    assert tq.x_scales(eng._params) == tq.x_scales(fresh._params)


def test_check_supported_refuses_only_the_mesh():
    pt_engine._check_supported(ServerConfig.from_dict(_engine_cfg()))
    for extra in ({"mesh_data": 2}, {"mesh_model": 2}):
        with pytest.raises(ValueError, match="mesh"):
            pt_engine._check_supported(ServerConfig.from_dict(
                _engine_cfg(extra)))


def test_simulation_engine_turns_int8_off():
    eng = pt_engine.SimulationEngine(ServerConfig.from_dict(_engine_cfg()),
                                     device="cpu")
    assert eng.simulation and not eng.config.tpu.quantize_int8


def test_calibration_failure_falls_back_but_kernel_errors_raise(monkeypatch):
    """A calibration that fails leaves dynamic quant (no x_scale) and the
    engine serves; a kernel build or launch error raises instead."""
    cfg = ServerConfig.from_dict(_engine_cfg())

    def broken(*a, **k):
        raise ArithmeticError("calibration broke")
    monkeypatch.setattr(pt_engine, "calibrate_activations", broken)
    eng = pt_engine.InferenceEngine(cfg, params=_tree(), device="cpu")
    assert not tq.x_scales(eng._params)
    assert len(eng.infer_batch([_req(pt_engine.InferenceRequest, 0, 3)])) == 1

    def kernel_broken(*a, **k):
        raise _build.KernelError("conv_int8: CUDA error 1 (invalid argument)")
    monkeypatch.setattr(pt_engine, "calibrate_activations", kernel_broken)
    with pytest.raises(_build.KernelError):
        pt_engine.InferenceEngine(cfg, params=_tree(), device="cpu")
