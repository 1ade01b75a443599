"""The host side of the port's kernels, which decides what runs on the card:
the 1x1 GEMM's route and tile plan (ops/conv1x1_cuda.py), a NumPy model of
the bias+SiLU kernel's thread -> vector mapping (ops/act_cuda.py), the
K-major weight layout that place_params gives the tensor-core kernel, and
the NMS kernel's plan with a NumPy model of its bit layout and scan
(ops/nms_cuda.py, csrc/nms_sm90.cu).
Shapes are recorded from the port's own forward at the deployed model
(yolov8n, 4 classes, 416 px). CPU only."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_nms_cases  # noqa: E402
from test_torch_serving_shapes import (  # noqa: E402
    S640_BIAS_SILU_B1, S640_CONV1X1_B1, SERVING_BIAS_SILU_B8,
    INT8_N416_CONV_B1, SERVING_CONV1X1_B8, SPLIT_N416_BIAS_SILU_B1,
    SPLIT_N416_CONV1X1_B1)
from zero_latency_yolo_tpu_torch.models import yolov8 as ym  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import (  # noqa: E402
    params_from_jax, place_params)
from zero_latency_yolo_tpu_torch.ops import act_cuda, conv1x1_cuda, nms_cuda  # noqa: E402

BATCHES = (1, 2, 4, 8)
H100_SMS = 132
# One resident wave of the bias+SiLU vector kernel on an H100 if 8 blocks
# of 256 threads fit an SM; the model below also runs a much smaller wave,
# where each thread takes many vectors.
WAVES = (H100_SMS * 8 * 256, 1000)
# The most dynamic shared memory one block may have on Hopper (227 KB).
SMEM_LIMIT = 232448


@functools.cache
def _path_calls(batch: int, variant: str = "yolov8n", size: int = 416,
                c2f: str = "slice"):
    """(1x1 calls as (M, Cin, Cout, act), bias+SiLU input shapes) of one
    plain f32 forward (default yolov8n at 416 px), in the order the step
    makes them."""
    spec = ym.get_spec(variant, 4)
    params = place_params(params_from_jax(ym.init_params(0, spec)), "cpu",
                          torch.float32, c2f_split=(c2f == "split"))
    conv, act = [], []
    saved = ym.conv1x1_bias_act_plain, ym.bias_silu_plain

    def rec_conv(x, w, b, act=True):
        conv.append((x.shape[0], x.shape[1], w.shape[1], act))
        return saved[0](x, w, b, act=act)

    def rec_act(y, b):
        act.append(tuple(y.shape))
        return saved[1](y, b)

    ym.conv1x1_bias_act_plain, ym.bias_silu_plain = rec_conv, rec_act
    try:
        with torch.inference_mode():
            ym.forward_raw(params, spec, torch.rand(batch, size, size, 3),
                           plain=True, c2f=c2f)
    finally:
        ym.conv1x1_bias_act_plain, ym.bias_silu_plain = saved
    return conv, act


@functools.cache
def _bf16_counts(batch: int, variant: str = "yolov8n", size: int = 416,
                 c2f: str = "slice"):
    """(1x1 calls, k=3 kernel calls, bias+SiLU calls) of one plain bf16
    forward: every k=3 conv but the stem's (Cin 3) takes the fused k=3
    kernel, so bias+SiLU is left the stem and the split C2f's tails."""
    spec = ym.get_spec(variant, 4)
    params = place_params(params_from_jax(ym.init_params(0, spec)), "cpu",
                          torch.bfloat16, c2f_split=(c2f == "split"))
    counts = [0, 0, 0]
    names = ("conv1x1_bias_act_plain", "conv3x3_bias_act_plain",
             "bias_silu_plain")
    saved = [getattr(ym, n) for n in names]

    def counting(i):
        def rec(*a, **k):
            counts[i] += 1
            return saved[i](*a, **k)
        return rec
    for i, n in enumerate(names):
        setattr(ym, n, counting(i))
    try:
        with torch.inference_mode():
            ym.forward_raw(params, spec, torch.rand(batch, size, size, 3),
                           dtype=torch.bfloat16, plain=True, c2f=c2f)
    finally:
        for n, fn in zip(names, saved):
            setattr(ym, n, fn)
    return tuple(counts)


@pytest.mark.parametrize("c2f", ["slice", "split"])
def test_int8_path_has_the_recorded_calls(c2f):
    """The int8 step (yolov8n at 416, tpu.quantize_int8) calls the int8
    conv 44 times (18 1x1, 26 k=3) at the shapes the card tests run, in
    either C2f form (int8 blocks take the slice form); the unquantized
    stem and head keep 6 1x1 calls and 13 bias+SiLU passes."""
    from zero_latency_yolo_tpu_torch.ops import conv_int8_cuda
    from zero_latency_yolo_tpu_torch.ops.quant import quantize_params
    spec = ym.get_spec("yolov8n", 4)
    params = place_params(params_from_jax(quantize_params(ym.init_params(
        0, spec))), "cpu", torch.float32, c2f_split=(c2f == "split"))
    calls, counts = [], {"conv1x1": 0, "bias_silu": 0}
    saved = (ym.conv_int8_plain, ym.conv1x1_bias_act_plain,
             ym.bias_silu_plain)

    def rec_int8(x, x_scale, w, w_scale, b, k, stride, act=True):
        calls.append((x.shape[1], x.shape[2], x.shape[3], x.stride(2),
                      w.shape[0], k, stride))
        return saved[0](x, x_scale, w, w_scale, b, k, stride, act)

    def counting(name, fn):
        def rec(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return rec
    ym.conv_int8_plain = rec_int8
    ym.conv1x1_bias_act_plain = counting("conv1x1", saved[1])
    ym.bias_silu_plain = counting("bias_silu", saved[2])
    try:
        with torch.inference_mode():
            ym.forward_raw(params, spec, torch.rand(1, 416, 416, 3),
                           plain=True, c2f=c2f)
    finally:
        (ym.conv_int8_plain, ym.conv1x1_bias_act_plain,
         ym.bias_silu_plain) = saved
    assert calls == INT8_N416_CONV_B1
    assert sum(c[5] == 1 for c in calls) == 18
    assert sum(c[5] == 3 for c in calls) == 26
    assert counts == {"conv1x1": 6, "bias_silu": 13}
    assert all(conv_int8_cuda.padded_k(k, cin) % conv_int8_cuda.K_STEP == 0
               for _, _, cin, _, _, k, _ in calls)


@pytest.mark.parametrize("batch", BATCHES)
def test_path_has_the_recorded_calls(batch):
    """24 1x1 convs and 39 bias+SiLU passes a step (f32); at batch 8
    exactly the shapes the card tests (tests/test_torch_cuda.py) run. In
    bf16 the k=3 kernel takes 38 of the 39 (all but the stem's): 24 1x1, 38
    k=3 and 1 bias+SiLU calls a step."""
    conv, act = _path_calls(batch)
    assert len(conv) == 24 and len(act) == 39
    want_conv = [(m * batch // 8, cin, cout, a)
                 for m, cin, cout, a in SERVING_CONV1X1_B8]
    assert conv == want_conv
    assert act == [(batch,) + s[1:] for s in SERVING_BIAS_SILU_B8]
    assert _bf16_counts(batch) == (24, 38, 1)


@pytest.mark.parametrize("index", range(24))
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_conv1x1_serving_call(batch, index):
    m, cin, cout, act = _path_calls(batch)[0][index]
    _check_tensor_core_plan(m, cin, cout)


# The serve-size ladder's paths at their largest batch bucket: yolov8s at
# 640 and its 512 rung (batch 16), yolov8n at 416 and its 320 rung (batch
# 32, where tpu.c2f="auto" picks the split C2f at 416).
LADDER_PATHS = [("yolov8s", 640, 16, "slice", S640_CONV1X1_B1,
                 S640_BIAS_SILU_B1),
                ("yolov8s", 512, 16, "slice", None, None),
                ("yolov8n", 416, 32, "split", SPLIT_N416_CONV1X1_B1,
                 SPLIT_N416_BIAS_SILU_B1),
                ("yolov8n", 320, 32, "slice", None, None)]


@pytest.mark.parametrize("variant,size,batch,c2f,conv_b1,act_b1",
                         LADDER_PATHS, ids=lambda v: str(v)[:12])
def test_ladder_paths_plan_onto_the_tensor_cores(variant, size, batch, c2f,
                                                 conv_b1, act_b1):
    """Each 1x1 call of a ladder path plans onto the tensor cores in bf16
    within the 32-bit indexing guard, and each bias+SiLU pass onto the
    vector kernel; the calls are the recorded ones (24 + 39 a step in the
    slice form, 50 + 47 in the split form: cv1 as two convs and cv2 as
    2 + n a block, one tail a block). In bf16 the k=3 kernel takes the 38
    k=3 convs but the stem's: 24 + 38 + 1 a step (slice), 50 + 38 + 9
    (split)."""
    conv, act = _path_calls(1, variant, size, c2f)
    assert (len(conv), len(act)) == ((50, 47) if c2f == "split" else (24, 39))
    assert _bf16_counts(1, variant, size, c2f) == (
        (50, 38, 9) if c2f == "split" else (24, 38, 1))
    if conv_b1 is not None:
        assert conv == conv_b1 and act == act_b1
    for m, cin, cout, _ in conv:
        m *= batch
        assert m < 2 ** 31 and m * cout < 2 ** 31 and cin * cout < 2 ** 31
        _check_tensor_core_plan(m, cin, cout)
    for shape in act:
        n, c = batch * int(np.prod(shape)), shape[-1]
        assert act_cuda.plan_bias_silu(n, c, 2, True, WAVES[0]).vec


def _check_tensor_core_plan(m, cin, cout):
    assert conv1x1_cuda.plan_conv1x1(m, cin, cout, torch.float32).route == "simt"
    plan = conv1x1_cuda.plan_conv1x1(m, cin, cout, torch.bfloat16,
                                     sms=H100_SMS)
    assert plan.route == "wgmma"
    assert plan.bn in conv1x1_cuda.N_TILES
    assert plan.stages == conv1x1_cuda.N_TILES[plan.bn]
    # The N tile: a multiple of 8 (wgmma's n), holding Cout or dividing it.
    assert plan.bn % 8 == 0 and (plan.bn >= cout or cout % plan.bn == 0)
    # Tiles cover M x Cout exactly once: the grid of BM x BN tiles reaches
    # past each edge by less than one tile, and tile t -> (t // tiles_n,
    # t % tiles_n) is a bijection onto it.
    assert (plan.tiles_m - 1) * plan.bm < m <= plan.tiles_m * plan.bm
    assert (plan.tiles_n - 1) * plan.bn < cout <= plan.tiles_n * plan.bn
    t = np.arange(plan.tiles)
    cells = (t // plan.tiles_n) * plan.tiles_n + t % plan.tiles_n
    assert np.array_equal(np.sort(cells), t)
    # The persistent blocks take tiles block, block + grid, ...: every tile
    # exactly once.
    assert 1 <= plan.grid <= plan.tiles
    walked = np.concatenate([np.arange(b, plan.tiles, plan.grid)
                             for b in range(plan.grid)])
    assert np.array_equal(np.sort(walked), t)
    assert plan.smem == conv1x1_cuda.wgmma_smem_bytes(plan.bn, plan.stages)
    assert plan.smem <= SMEM_LIMIT
    # One resident wave at most: the blocks an SM holds by shared memory.
    per_sm = min(conv1x1_cuda.BLOCKS_PER_SM,
                 conv1x1_cuda.SMEM_PER_SM // (plan.smem + 1024))
    assert per_sm >= 1 and plan.grid <= per_sm * H100_SMS


@pytest.mark.parametrize("bn,stages", sorted(conv1x1_cuda.N_TILES.items()))
def test_every_tile_instance_fits_two_blocks_an_sm(bn, stages):
    smem = conv1x1_cuda.wgmma_smem_bytes(bn, stages)
    assert smem % 1024 == 0 and 2 * (smem + 1024) <= conv1x1_cuda.SMEM_PER_SM


def _x(m, cin, dtype, offset=0):
    flat = torch.zeros(m * cin + offset, dtype=dtype)
    return flat[offset:].view(m, cin)


@pytest.mark.parametrize("m,cin,cout,dtype,offset,kmajor,route", [
    (5408, 192, 128, torch.bfloat16, 0, True, "wgmma"),
    (5408, 192, 128, torch.float32, 0, True, "simt"),     # f32: CUDA cores
    (5408, 12, 128, torch.bfloat16, 0, True, "simt"),     # Cin % 8 != 0
    (1352, 3, 4, torch.bfloat16, 0, True, "simt"),
    (5408, 192, 128, torch.bfloat16, 1, True, "simt"),    # x 2 bytes off 16
    (5408, 192, 128, torch.bfloat16, 8, True, "wgmma"),   # x 16 bytes off
    (5408, 192, 128, torch.bfloat16, 0, False, "simt"),   # w row-major
    (1352, 64, 4, torch.bfloat16, 0, False, "simt"),
])
def test_route_by_type_shape_and_alignment(m, cin, cout, dtype, offset,
                                           kmajor, route):
    x = _x(m, cin, dtype, offset)
    w = torch.zeros(cin, cout, dtype=dtype)
    if kmajor:
        w = conv1x1_cuda.k_major(w)
    assert conv1x1_cuda.conv1x1_plan(x, w).route == route


def test_misaligned_weight_copy_routes_to_cuda_cores():
    x = _x(64, 64, torch.bfloat16)
    w_t = torch.zeros(64 * 64 + 4, dtype=torch.bfloat16)[4:].view(64, 64)
    assert conv1x1_cuda.conv1x1_plan(x, w_t.t()).route == "simt"
    assert conv1x1_cuda.conv1x1_plan(x, w_t.clone().t()).route == "wgmma"


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100, 16, generator=g).bfloat16()
    w = torch.randn(16, 8, generator=g).bfloat16()
    b = torch.randn(8, generator=g)
    before = (conv1x1_cuda.launches, dict(conv1x1_cuda.launches_by_route))
    for ww in (w, conv1x1_cuda.k_major(w)):
        got = conv1x1_cuda.conv1x1_bias_act(x, ww, b)
        assert torch.equal(got, conv1x1_cuda.conv1x1_bias_act_plain(x, w, b))
    assert (conv1x1_cuda.launches, conv1x1_cuda.launches_by_route) == before


def _bias_silu_model(plan, c, width):
    """The vector kernel's loop (csrc/kernels.cu bias_silu_vec_kernel) over
    all threads at once: thread t starts at vector t and steps UNROLL *
    stride, taking vectors v + u * stride. Returns, per vector, how many
    threads took it, and whether each take kept the thread's channel
    group (the kernel loads the biases of channels (t % groups) * width
    once)."""
    unroll = act_cuda.UNROLL
    taken = np.zeros(plan.nvec, np.int64)
    same_group = True
    t = np.arange(plan.stride)
    for v0 in range(0, plan.nvec, unroll * plan.stride):
        for u in range(unroll):
            v = t + v0 + u * plan.stride
            v = v[v < plan.nvec]
            np.add.at(taken, v, 1)
            # vector v holds channels (v * width) % c .. + width
            same_group &= bool(np.all((v * width) % c
                                      == (v % plan.stride % plan.groups) * width))
    return taken, same_group


EDGE_SHAPES = [(1, 1, 1, 8), (1, 1, 1, 16), (1, 2, 3, 16), (2, 5, 7, 24),
               (3, 9, 9, 64), (1, 4, 4, 256), (2, 13, 13, 8), (1, 1, 2, 256)]


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SERVING_BIAS_SILU_B8 + EDGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bias_silu_mapping_covers_each_vector_once(shape, dtype, wave):
    n, c = int(np.prod(shape)), shape[-1]
    size = torch.empty((), dtype=dtype).element_size()
    width = 16 // size
    plan = act_cuda.plan_bias_silu(n, c, size, True, wave)
    assert plan.vec
    assert plan.nvec == n // width and plan.groups == c // width
    assert plan.stride % plan.groups == 0
    assert plan.stride <= max(plan.nvec, plan.groups)
    assert plan.stride <= max(wave, plan.groups)
    taken, same_group = _bias_silu_model(plan, c, width)
    assert np.all(taken == 1)
    assert same_group


@pytest.mark.parametrize("c,elem,aligned", [(12, 2, True), (6, 4, True),
                                            (3, 2, True), (64, 2, False),
                                            (64, 4, False)])
def test_bias_silu_scalar_kernel_where_vectors_do_not_fit(c, elem, aligned):
    n = 7 * c
    plan = act_cuda.plan_bias_silu(n, c, elem, aligned, WAVES[0])
    assert not plan.vec and plan.stride == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_place_params_makes_the_k_major_copy(dtype):
    """Every 1x1 matrix is placed once, K-major, with its values; no
    second copy."""
    spec = ym.get_spec("yolov8p", 4)
    tree = params_from_jax(ym.init_params(1, spec))
    placed = place_params(tree, "cpu", dtype)
    pairs = []

    def walk(src, dst):
        if isinstance(src, list):
            for s_, d_ in zip(src, dst):
                walk(s_, d_)
        elif "b" in src:
            pairs.append((src, dst))
        else:
            for k in src:
                walk(src[k], dst[k])
    walk(tree, placed)
    mm = [(s_, d_) for s_, d_ in pairs if "w_mm" in s_]
    assert mm
    for src, dst in mm:
        assert set(dst) == {"w_mm", "b"}
        cin, cout = src["w_mm"].shape
        w = dst["w_mm"]
        assert w.shape == (cin, cout) and w.dtype == dtype
        assert w.stride() == (1, cin) and w.t().is_contiguous()
        assert torch.equal(w, src["w_mm"].to(dtype))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 37, 84, 256, 513, 1000, 1024])
def test_nms_plan_fits_one_block(k):
    """Threads a multiple of 32 up to 1024, the mask's row stride 1 mod 32
    (the scan's 32 lanes read 32 distinct banks), every word of a row held,
    the layout within the 227 KB a block may have."""
    plan = nms_cuda.plan_nms_keep(k)
    assert 32 * plan.words >= k > 32 * (plan.words - 1)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads <= max(32, 32 * plan.words * k)
    assert plan.stride % 32 == 1 and plan.stride >= 32 * plan.words
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == 4 * (plan.words * plan.stride + 6 * k + plan.words)


def _max_nan(a, b):
    return np.where(np.isnan(a) | (a > b), a, b)


def _min_nan(a, b):
    return np.where(np.isnan(a) | (a < b), a, b)


def _clamp_min(v, lo):
    return np.where(v < lo, np.float32(lo), v)


def _nms_model(boxes, classes, valid, thr):
    """NumPy model of csrc/nms_sm90.cu nms_keep_kernel, frame by frame, in
    its own f32 arithmetic and bit layout: stage, the words (w, i) of the
    mask that it computes (valid rows only, words holding some j > i), the
    one-warp scan, word by word: the word's keep bits as the fixed point of
    rounds of a warp-wide OR of the diagonal rows of the bits still set,
    then the kept candidates' rows cleared from the later words. The mask
    starts as "never written" (-1), and reading such a word fails.
    Returns the (B, K) keep mask and the scan's rounds a frame."""
    f = np.float32
    b, k, _ = boxes.shape
    plan = nms_cuda.plan_nms_keep(k)
    thr = f(thr)
    keep = np.zeros((b, k), bool)
    steps = []
    bit = np.arange(32)
    for fr in range(b):
        cx, cy, w, h = (boxes[fr, :, c] for c in range(4))
        hw, hh = w / f(2), h / f(2)
        x1, y1, x2, y2 = cx - hw, cy - hh, cx + hw, cy + hh
        area = _clamp_min(w, 0) * _clamp_min(h, 0)
        cls = classes[fr]
        v = np.zeros(32 * plan.words, bool)
        v[:k] = valid[fr]
        vbits = [int((v[32 * wd:32 * wd + 32].astype(np.int64) << bit).sum())
                 for wd in range(plan.words)]
        mask = np.full((plan.words, plan.stride), -1, np.int64)
        i = np.arange(k)
        for wd in range(plan.words):
            js = 32 * wd + bit
            jc = np.minimum(js, k - 1)
            rows = valid[fr] & (wd >= (i + 1) >> 5)
            cand = (js < k)[None, :] & v[jc][None, :] & (js[None, :] > i[:, None])
            same = cls[jc][None, :] == cls[:, None]
            iw = _clamp_min(_min_nan(x2[:, None], x2[jc][None, :])
                            - _max_nan(x1[:, None], x1[jc][None, :]), 0)
            ih = _clamp_min(_min_nan(y2[:, None], y2[jc][None, :])
                            - _max_nan(y1[:, None], y1[jc][None, :]), 0)
            inter = iw * ih
            hit = inter > 0  # only these pairs are divided
            uni = _clamp_min((area[:, None] + area[jc][None, :]) - inter,
                             f(1e-9))
            iou = np.divide(inter, uni, out=np.zeros_like(inter), where=hit)
            sup = cand & same & hit & (iou > thr)
            mask[wd, :k] = np.where(rows, (sup.astype(np.int64) << bit).sum(1),
                                    -1)
        kept = vbits + [0] * (32 - plan.words)  # lane w: keep word w
        n = 0

        def read(w_, i_):
            row = int(mask[w_, i_])
            assert row >= 0, f"scan read mask word ({w_}, {i_}) never written"
            return row

        for wl in range(plan.words):
            todo = kept[wl]
            if not todo:
                continue
            lanes = [32 * wl + r for r in range(32)]
            diag = [read(wl, i_) if todo >> r & 1 and r < 31 else 0
                    for r, i_ in enumerate(lanes)]
            word, last, rounds = todo, None, 0
            while word != last:  # the warp-wide OR, round by round
                last = word
                sup = 0
                for r in range(32):
                    if word >> r & 1:
                        sup |= diag[r]
                word = todo & ~sup
                rounds += 1
            assert rounds <= bin(todo).count("1") + 1
            n += rounds
            kept[wl] = word
            for lane in range(wl + 1, plan.words):
                sup = 0
                for r, i_ in enumerate(lanes):
                    if word >> r & 1:
                        sup |= read(lane, i_)
                kept[lane] &= ~sup
        assert not any(kept[plan.words:])
        keep[fr] = [(kept[j >> 5] >> (j & 31)) & 1 for j in range(k)]
        steps.append(n)
    return keep, steps


def _nms_cases():
    cases = {f"seed{s}_k{k}": torch_nms_cases.seeded(s, 2, k)
             for s in (0, 1, 2) for k in (1, 37, 84, 256)}
    cases.update(torch_nms_cases.edge_cases())
    return cases


@pytest.mark.parametrize("name", sorted(_nms_cases()))
def test_nms_model_matches_plain(name):
    """The kernel's bit layout and word-by-word scan give the plain
    version's keep mask bit for bit, in fewer serial rounds than valid
    candidates once a frame has more than a word of them."""
    boxes, classes, valid = _nms_cases()[name]
    with np.errstate(invalid="ignore", over="ignore"):
        got, rounds = _nms_model(boxes, classes, valid, torch_nms_cases.THRESH)
    want = nms_cuda.nms_keep_plain(torch.from_numpy(boxes),
                                   torch.from_numpy(classes),
                                   torch.from_numpy(valid),
                                   torch_nms_cases.THRESH).numpy()
    np.testing.assert_array_equal(got, want)
    for n, v in zip(rounds, valid.sum(axis=1)):
        assert n <= v + (v + 31) // 32 and (n < v or v <= 32)
    assert not (want & ~valid).any()


def test_nms_cases_at_threshold_are_exact():
    """The at-threshold pair's IoU is np.float32(0.45) exactly, so it is not
    suppressed; moved a quarter pixel closer, it is."""
    boxes, classes, valid = torch_nms_cases.edge_cases()["at_threshold"]
    iou = nms_cuda._iou_matrix_center(torch.from_numpy(boxes))
    assert iou[0, 0, 1].item() == float(np.float32(torch_nms_cases.THRESH))
    assert iou[1, 0, 1].item() > float(np.float32(torch_nms_cases.THRESH))
    keep = nms_cuda.nms_keep_plain(torch.from_numpy(boxes),
                                   torch.from_numpy(classes),
                                   torch.from_numpy(valid),
                                   torch_nms_cases.THRESH)
    assert keep.tolist() == [[True, True], [True, False]]
