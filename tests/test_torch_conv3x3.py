"""The k=3 conv with its bias + SiLU fused (ops/conv3x3_cuda.py,
csrc/conv3x3_sm90.cu) on the CPU: its plain version against the JAX
package's `_conv` at k=3, the tile plan that routes a call to the kernel
(every k=3 call of the yolov8n 416 and yolov8s 640 bf16 steps and of the
serving mesh's half-width shards), the K-major weight layout that
`place_params` gives it, which calls `_conv` sends to it, and the port's
bf16 step with the new route against the JAX package's bf16 step at
detection level. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import functools
import os

import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_serving_shapes import (  # noqa: E402
    N416_CONV3X3, S640_CONV3X3)
from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jax_model  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models import yolov8 as ym  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    params_from_jax, place_params)
from zero_latency_yolo_tpu_torch.ops import conv3x3_cuda  # noqa: E402
from zero_latency_yolo_tpu_torch.parallel import mesh as pt_mesh  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import engine as pt_engine  # noqa: E402

H100_SMS = 132
# The most dynamic shared memory one block may have on Hopper (227 KB),
# and what an SM offers all its blocks (228 KB).
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
CPU = torch.device("cpu")


def _block(rng, cin, cout):
    """A folded k=3 block: HWIO weight and bias, seeded."""
    w = (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2.0 / (9 * cin)))
    return {"w": w.astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.5).astype(np.float32)}


def _oihw(w_hwio, dtype):
    """The HWIO kernel as place_params places it: OIHW in channels-last
    memory, in `dtype`."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(
        3, 2, 0, 1))).to(dtype).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------- plain version

CASES = [  # (batch, H, W, Cin, Cout, stride)
    (1, 9, 11, 16, 24, 1), (3, 9, 11, 16, 24, 2), (1, 13, 7, 32, 16, 2),
    (3, 8, 8, 8, 40, 1), (1, 5, 5, 64, 8, 1), (3, 7, 9, 24, 32, 2)]


@pytest.mark.parametrize("n,h,w,cin,cout,stride", CASES)
def test_plain_matches_jax_conv_f32(n, h, w, cin, cout, stride):
    """f32: conv (pad 1) + b, SiLU, as the JAX package's `_conv` at k=3,
    within 1e-5 (the same sums in another order)."""
    rng = np.random.default_rng(cin * 31 + h)
    p = _block(rng, cin, cout)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    want = np.asarray(jax_model._conv(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        stride=stride, act=True, dtype=jnp.float32))
    got = conv3x3_cuda.conv3x3_bias_act_plain(
        torch.from_numpy(x), _oihw(p["w"], torch.float32),
        torch.from_numpy(p["b"]), stride).numpy()
    assert got.shape == want.shape == (n, (h - 1) // stride + 1,
                                       (w - 1) // stride + 1, cout)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,h,w,cin,cout,stride", CASES)
def test_plain_matches_jax_conv_bf16(n, h, w, cin, cout, stride):
    """bf16: the plain version rounds once, after conv, bias and SiLU in
    f32; the JAX package's serving path rounds the conv's output to bf16,
    adds the bias in bf16 and applies SiLU in bf16: three roundings of at
    most half a bf16 ulp (2^-9 relative) each, on values and on sums of
    comparable size. Within 4 bf16 ulps of the larger (2^-6 relative) plus
    2^-6 absolute, where SiLU's values near 0 come from cancelling sums."""
    rng = np.random.default_rng(cin * 17 + w)
    p = _block(rng, cin, cout)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_model._conv(
        {k: jnp.asarray(v) for k, v in p.items()}, xb, stride=stride,
        act=True, dtype=jnp.bfloat16)).astype(np.float32)
    got = conv3x3_cuda.conv3x3_bias_act_plain(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
            torch.bfloat16),
        _oihw(p["w"], torch.bfloat16), torch.from_numpy(p["b"]),
        stride)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -6, rtol=2.0 ** -6)


def test_plain_reads_a_channel_slice_where_it_lies():
    """x may be a channel slice of a wider tensor (C2f's y[..., c:]): the
    plain version and the plan take it without a copy, with its pixel
    stride."""
    rng = np.random.default_rng(5)
    p = _block(rng, 16, 24)
    full = torch.from_numpy(rng.standard_normal((2, 9, 9, 32)).astype(
        np.float32)).to(torch.bfloat16)
    x = full[..., 16:]
    assert conv3x3_cuda.pixel_stride(x) == 32
    w = _oihw(p["w"], torch.bfloat16)
    b = torch.from_numpy(p["b"])
    torch.testing.assert_close(
        conv3x3_cuda.conv3x3_bias_act_plain(x, w, b, 1),
        conv3x3_cuda.conv3x3_bias_act_plain(x.contiguous(), w, b, 1),
        atol=0, rtol=0)
    assert conv3x3_cuda.conv3x3_plan(x, w, 1).route == "wgmma"


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch."""
    rng = np.random.default_rng(6)
    p = _block(rng, 16, 16)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 16)).astype(
        np.float32)).to(torch.bfloat16)
    w, b = _oihw(p["w"], torch.bfloat16), torch.from_numpy(p["b"])
    n0 = conv3x3_cuda.launches
    torch.testing.assert_close(conv3x3_cuda.conv3x3_bias_act(x, w, b, 2),
                               conv3x3_cuda.conv3x3_bias_act_plain(x, w, b, 2),
                               atol=0, rtol=0)
    assert conv3x3_cuda.launches == n0


# ---------------------------------------------------------------- the plan

def _check_plan(n, h, w, cin, ldx, cout, stride):
    """A call the kernel takes: its tiles cover the output, its shared
    memory fits a block and an SM, the grid is one resident wave at most,
    and every offset is within 32 bits."""
    plan = conv3x3_cuda.plan_conv3x3(n, h, w, cin, cout, stride,
                                     torch.bfloat16, ldx)
    assert plan.route == "wgmma"
    ho, wo = conv3x3_cuda.out_hw(h, w, stride)
    m = n * ho * wo
    assert (plan.bm, plan.bn) in conv3x3_cuda.TILES
    assert plan.stages == conv3x3_cuda.TILES[(plan.bm, plan.bn)]
    assert plan.bk == 64
    assert plan.tiles_m * plan.bm >= m > (plan.tiles_m - 1) * plan.bm
    assert plan.tiles_n * plan.bn >= cout > (plan.tiles_n - 1) * plan.bn
    assert plan.bn <= 2 * max(cout, 8)  # no N tile past twice Cout
    assert plan.bm == 64 or 32 <= plan.bn <= 64
    assert plan.smem == conv3x3_cuda.smem_bytes(plan.bm, plan.bn, plan.stages)
    assert plan.smem <= SMEM_LIMIT
    per_sm = min(conv3x3_cuda.BLOCKS_PER_SM, SMEM_PER_SM // (plan.smem + 1024))
    assert per_sm >= 1
    assert 1 <= plan.grid <= min(plan.tiles, per_sm * H100_SMS)
    assert n * h * w * ldx < 2 ** 31 and m * cout < 2 ** 31
    return plan


@functools.cache
def _k3_calls(variant, size, c2f="slice", model=1):
    """The k=3 calls of one plain bf16 forward at batch 1 (default yolov8n at
    416), as (H, W, Cin, pixel stride, Cout, stride), in step order; with
    model > 1, of data row 0 of a (1, model) serving mesh over the CPU
    (each channel-sharded block's slices)."""
    spec = ym.get_spec(variant, 4)
    tree = params_from_jax(ym.init_params(0, spec))
    if model > 1:
        mesh = pt_mesh.make_mesh(1, model, [CPU] * model)
        params = pt_mesh.row_params(mesh, pt_mesh.shard_params(
            tree, mesh, torch.bfloat16, c2f_split=(c2f == "split")), 0)
    else:
        params = place_params(tree, "cpu", torch.bfloat16,
                              c2f_split=(c2f == "split"))
    calls = []
    saved = ym.conv3x3_bias_act_plain

    def rec(x, w, b, stride=1):
        calls.append((x.shape[1], x.shape[2], x.shape[3],
                      conv3x3_cuda.pixel_stride(x), w.shape[0], stride))
        return saved(x, w, b, stride)

    ym.conv3x3_bias_act_plain = rec
    try:
        with torch.inference_mode():
            ym.forward_raw(params, spec, torch.rand(1, size, size, 3),
                           dtype=torch.bfloat16, plain=True, c2f=c2f,
                           conv_fn=ym.tp_conv if model > 1 else None)
    finally:
        ym.conv3x3_bias_act_plain = saved
    return tuple(calls)


def test_recorded_k3_calls_are_the_steps():
    """Every k=3 conv of the bf16 step but the stem (Cin 3) takes the
    kernel: 38 a step, at the shapes the card tests run."""
    assert list(_k3_calls("yolov8n", 416)) == N416_CONV3X3
    assert list(_k3_calls("yolov8s", 640)) == S640_CONV3X3
    split = _k3_calls("yolov8n", 416, "split")
    assert len(split) == 38
    # The split C2f's pieces are their own tensors: no channel slice.
    assert all(ldx == cin for _, _, cin, ldx, _, _ in split)


@pytest.mark.parametrize("batch", [1, 8, 16, 32])
@pytest.mark.parametrize("variant,size,c2f", [
    ("yolov8n", 416, "slice"), ("yolov8n", 416, "split"),
    ("yolov8s", 640, "slice")])
def test_plan_takes_every_k3_call(variant, size, c2f, batch):
    for h, w, cin, ldx, cout, stride in _k3_calls(variant, size, c2f):
        _check_plan(batch, h, w, cin, ldx, cout, stride)


@pytest.mark.parametrize("variant,size", [("yolov8n", 416),
                                          ("yolov8s", 640)])
def test_plan_takes_the_mesh_shards(variant, size):
    """The serving mesh's 1x2 shards: each sharded k=3 block's half of
    Cout, on the same input, at batch 8 (yolov8n's Cout 16 halves to 8)."""
    calls = _k3_calls(variant, size, model=2)
    full = _k3_calls(variant, size)
    assert len(calls) == 2 * len(full)
    assert [c[4] for c in calls[::2]] == [c[4] // 2 for c in full]
    assert min(c[4] for c in calls) == (8 if variant == "yolov8n" else 16)
    for h, w, cin, ldx, cout, stride in calls:
        _check_plan(8, h, w, cin, ldx, cout, stride)


def test_plan_guards_32_bit_offsets():
    """Past 2^31 input elements (yolov8s 640's first k=3 conv at batch
    1024) the call stays on F.conv2d; just under, the kernel takes it."""
    h, w, cin, ldx, cout, stride = S640_CONV3X3[0]
    limit = 2 ** 31 // (h * w * ldx)
    assert conv3x3_cuda.plan_conv3x3(limit, h, w, cin, cout, stride,
                                     torch.bfloat16, ldx).route == "wgmma"
    assert conv3x3_cuda.plan_conv3x3(limit + 1, h, w, cin, cout, stride,
                                     torch.bfloat16, ldx).route == "conv2d"
    big = 2 ** 31 // 72  # Cout past which the (Cout, 9 * 8) weight is too
    assert conv3x3_cuda.plan_conv3x3(1, 4, 4, 8, big, 1,
                                     torch.bfloat16).route == "wgmma"
    assert conv3x3_cuda.plan_conv3x3(1, 4, 4, 8, big + 1, 1,
                                     torch.bfloat16).route == "conv2d"


@pytest.mark.parametrize("kwargs", [
    dict(dtype=torch.float32), dict(cin=3), dict(cin=12), dict(cin=20),
    dict(ldx=36), dict(stride=3), dict(aligned=False), dict(w_kmajor=False),
    dict(n=0)], ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_plan_refuses(kwargs):
    """f32, the stem's Cin 3 (and the s2d stem's 12), Cin or the pixel
    stride not a multiple of 8, other strides, misaligned buffers, a
    weight not laid out K-major, an empty batch: F.conv2d."""
    args = dict(n=2, h=16, w=16, cin=32, cout=32, stride=1,
                dtype=torch.bfloat16, ldx=0, aligned=True, w_kmajor=True)
    args.update(kwargs)
    assert conv3x3_cuda.plan_conv3x3(**args).route == "conv2d"
    assert conv3x3_cuda.plan_conv3x3(2, 16, 16, 32, 32, 1,
                                     torch.bfloat16).route == "wgmma"


# ---------------------------------------------------------------- the weight

def test_placed_weight_is_the_k_major_matrix():
    """place_params lays every k=3 kernel out OIHW in channels-last memory:
    its bytes are the (Cout, 9 * Cin) matrix in (ky, kx, ci) order, read
    by the kernel as a view; each mesh shard is its own contiguous copy of
    its rows."""
    spec = ym.get_spec("yolov8p", 4)
    tree = ym.init_params(0, spec)
    dev = params_from_jax(tree)
    placed = place_params(dev, "cpu", torch.bfloat16)
    shards = [place_params(dev, "cpu", torch.bfloat16, shard=(i, 2))
              for i in range(2)]
    hwio = tree["m19"]["w"]
    cout = hwio.shape[3]
    want = torch.from_numpy(np.ascontiguousarray(
        hwio.transpose(3, 0, 1, 2).reshape(cout, -1))).to(torch.bfloat16)
    w = placed["m19"]["w"]
    assert conv3x3_cuda.is_k_major(w)
    km = _k_major(w)
    assert km.data_ptr() == w.data_ptr() and km.is_contiguous()
    torch.testing.assert_close(km, want, atol=0, rtol=0)
    for i, sh in enumerate(shards):
        ws = sh["m19"]["w"]
        assert sh["m19"]["shard"] == (i, 2)
        assert conv3x3_cuda.is_k_major(ws)
        torch.testing.assert_close(_k_major(ws),
                                   want[i * cout // 2:(i + 1) * cout // 2],
                                   atol=0, rtol=0)
    n_k3 = 0
    for path, blk in _conv_blocks(placed):
        if "w" in blk and blk["w"].shape[-1] == 3:
            n_k3 += 1
            assert conv3x3_cuda.is_k_major(blk["w"]), path
    assert n_k3 == 39


def _k_major(w):
    """The (Cout, 9 * Cin) matrix the kernel reads of OIHW w: a view of
    its memory when w lies in channels-last memory."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _conv_blocks(node, path=""):
    if isinstance(node, list):
        for i, v in enumerate(node):
            yield from _conv_blocks(v, f"{path}/{i}")
    elif "b" in node:
        yield path, node
    else:
        for k, v in node.items():
            yield from _conv_blocks(v, f"{path}/{k}")


# ---------------------------------------------------------------- routing

def _counting(monkeypatch, plain=True):
    """Counts of `_conv`'s calls of the k=3, bias+SiLU and int8 functions:
    their plain versions (a step built with plain=True) or their wrappers,
    which on the CPU run the plain versions."""
    counts = {"conv3x3": 0, "bias_silu": 0, "conv_int8": 0}
    suffix = "_plain" if plain else ""

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    for name, attr in (("conv3x3", "conv3x3_bias_act"),
                       ("bias_silu", "bias_silu"), ("conv_int8", "conv_int8")):
        monkeypatch.setattr(ym, attr + suffix,
                            counted(name, getattr(ym, attr + suffix)))
    return counts


@pytest.mark.parametrize("case,routed", [
    ("bf16", True), ("f32", False), ("act_false", False), ("stem", False),
    ("int8", False), ("row_major_w", False)])
def test_conv_routes_to_the_kernel(case, routed, monkeypatch):
    """`_conv` sends a folded k=3 bf16 block with SiLU whose shape the plan
    takes to the kernel; f32, act=False, the stem's Cin 3, an int8 block
    and a weight not laid out K-major keep their routes."""
    from zero_latency_yolo_tpu_torch.ops.quant import quantize_params
    rng = np.random.default_rng(9)
    cin = 3 if case == "stem" else 16
    p = _block(rng, cin, 16)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    if case == "int8":
        q = quantize_params({"m1": {"w": p["w"], "b": p["b"]}})["m1"]
        blk = place_params(params_from_jax({"m1": q}), "cpu", dtype)["m1"]
    else:
        blk = place_params(params_from_jax({"m1": p}), "cpu", dtype)["m1"]
    if case == "row_major_w":
        blk = dict(blk, w=blk["w"].contiguous())
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, cin)).astype(
        np.float32)).to(dtype)
    counts = _counting(monkeypatch)
    y = ym._conv(blk, x, stride=2, act=(case != "act_false"), plain=True)
    assert y.shape == (2, 4, 4, 16) and y.dtype == dtype
    assert counts["conv3x3"] == int(routed)
    assert counts["bias_silu"] == int(case in ("f32", "stem", "row_major_w"))
    assert counts["conv_int8"] == int(case == "int8")


# ---------------------------------------------------------------- the step

TRAINED_416 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "yolov8n_trained_416.npz")


def _engine_cfg(dtype, size):
    return {"model_path": "/nonexistent.npz", "confidence_threshold": 0.5,
            "nms_threshold": 0.45,
            "detection": {"model_width": size, "model_height": size},
            "tpu": {"variant": "yolov8n", "num_classes": 4, "dtype": dtype,
                    "batch_buckets": [4], "frame_buckets": [[size, size]],
                    "pre_nms_topk": 64, "nms": "pallas_interpret"}}


def test_bf16_step_matches_jax_bf16_step(monkeypatch):
    """The port's bf16 step, its k=3 convs on the new route (the plain
    version on the CPU: one rounding after conv, bias and SiLU), against
    the JAX package's bf16 step (conv, bias and SiLU each rounded to bf16)
    at detection level, on the trained deployment weights (yolov8n) at 160
    px over frames of the task they were trained on: counts and classes
    equal, boxes and confidences within 0.03 (normalized; chip_smoke's
    bf16_gate confidence limit). The route runs: 38 k=3 calls a step go
    to the kernel's wrapper, and only the stem's bias+SiLU is left."""
    from zero_latency_yolo_tpu.models.weights import load_params
    from zero_latency_yolo_tpu.train.loop import synthetic_batches
    size = 160
    tree = load_params(TRAINED_416)
    jeng = jax_engine.InferenceEngine(
        JaxConfig.from_dict(_engine_cfg("bfloat16", size)), params=tree)
    peng = pt_engine.InferenceEngine(
        ServerConfig.from_dict(_engine_cfg("bfloat16", size)), params=tree,
        device="cpu")
    x, _ = next(synthetic_batches(4, size, seed=777))
    frames = np.round(np.asarray(x) * 255).astype(np.uint8)

    def requests(cls):
        return [cls(client_id=i + 1, frame_id=i, timestamp=i, width=size,
                    height=size, data=f) for i, f in enumerate(frames)]
    counts = _counting(monkeypatch, plain=False)
    want = jeng.infer_batch(requests(jax_engine.InferenceRequest))
    got = peng.infer_batch(requests(pt_engine.InferenceRequest))
    assert counts == {"conv3x3": 38, "bias_silu": 1, "conv_int8": 0}
    assert sum(len(r.detections) for r in want) > 0, "vacuous: no detections"
    for g, w in zip(got, want):
        assert len(g.detections) == len(w.detections)
        for dg, dw in zip(g.detections, w.detections):
            assert dg.class_id == dw.class_id
            np.testing.assert_allclose(
                [dg.x, dg.y, dg.width, dg.height, dg.confidence],
                [dw.x, dw.y, dw.width, dw.height, dw.confidence], atol=0.03)


# ---------------------------------------------------------------- the probe

def test_probe_cuts_each_part_of_the_kernel():
    """conv3x3_probe's variants: each cuts its parts out of the kernel's
    source as it ships (every text it cuts is there once), and the full
    variant is the source itself."""
    from pathlib import Path
    from zero_latency_yolo_tpu_torch import conv3x3_probe
    src = (Path(conv3x3_cuda.__file__).resolve().parent.parent / "csrc"
           / "conv3x3_sm90.cu").read_text()
    out = conv3x3_probe.variant_sources(src)
    assert set(out) == set(conv3x3_probe.VARIANTS)
    assert out["full"] == src
    assert len({text for text in out.values()}) == len(out)
    assert "silu_fast(d" not in out["no_silu"]
    assert "cp_async16(a_base" not in out["no_gather"]
    assert "tma_load_2d(sm.b" not in out["no_weight"]
    assert "wgmma_bf16<BN>(d" not in out["no_mma"]
    with pytest.raises(ValueError, match="not 1"):
        conv3x3_probe.variant_sources(src.replace("silu_fast(d", "silu(d"))
