"""The port's measurement tools on the CPU, at ZLT_BENCH_SMOKE sizes (yolov8p,
64-96 px, `--device cpu`): each tool's JSON has the JAX script's keys, and
what a tool runs is held against the JAX package on the same numpy inputs
(f32, at most one JAX compile a tool; counts and classes equal, boxes and
scores within 1e-3, `chip_smoke.kernels_vs_plain`): `conv1x1_compare`'s
library route and `floor_split_bench`'s two rungs against the JAX
package's `get_step_cached`, `pack_proxy`'s (B/4, 2S) forward against its
`forward_decoded`. Also `trace_analyze`'s rollup of a hand-built Chrome
trace and of one `utils/profiling.trace` wrote, `lane_physics`'s
accounting and top-bucket rule, `spmd_overhead` on a virtual 2x1 mesh over
the CPU, `wire_ceiling`'s knee rule and one 2-stream rung, and a failed row
making a sweep exit 1."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import kernels_vs_plain  # noqa: E402
from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig  # noqa: E402
from zero_latency_yolo_tpu.models import yolov8 as jax_model  # noqa: E402
from zero_latency_yolo_tpu.runtime import engine as jax_engine  # noqa: E402
from zero_latency_yolo_tpu_torch import (  # noqa: E402
    conv1x1_compare, floor_split_bench, lane_physics, layout_compare,
    pack_proxy, perf_sweep, spmd_overhead, step_ladder, trace_analyze,
    width_ladder, wire_ceiling)
from zero_latency_yolo_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from zero_latency_yolo_tpu_torch.utils import bench_util  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = 0.01  # the steps' runtime threshold in the JAX comparisons


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setenv("ZLT_BENCH_SMOKE", "1")


def run_tool(mod, argv):
    """mod.main(argv) in this process: (rc, its stdout's JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]


def jax_cached_outputs(cfg_dict, tree, steps, frames, hw):
    """The JAX engine's get_step_cached for each (batch, size) of `steps`
    on the same frame cache, in ONE jitted program (one compile)."""
    eng = jax_engine.InferenceEngine(JaxConfig.from_dict(cfg_dict),
                                     params=tree)
    bucket = frames.shape[1:3]
    fns = [eng.get_step_cached(b, bucket, sz) for b, sz in steps]
    shws = [jnp.asarray(np.stack([np.arange(b, dtype=np.int32)
                                  % len(frames),
                                  np.full((b,), hw[0], np.int32),
                                  np.full((b,), hw[1], np.int32)]))
            for b, _ in steps]

    @jax.jit
    def run(params, cache):
        return [f(params, cache, s, eng._class_weights, jnp.float32(CONF),
                  eng._iou) for f, s in zip(fns, shws)]
    return [np.asarray(o) for o in run(eng._params, jnp.asarray(frames))]


def port_cached_output(engine, batch, size, frames, hw, conv1x1="kernel"):
    shw = torch.from_numpy(np.stack([
        np.arange(batch, dtype=np.int32) % len(frames),
        np.full((batch,), hw[0], np.int32),
        np.full((batch,), hw[1], np.int32)]))
    step = engine.get_step_cached(batch, frames.shape[1:3], size,
                                  conv1x1=conv1x1)
    return step(engine._params, torch.from_numpy(frames), shw,
                engine._class_weights, CONF,
                engine.config.nms_threshold).numpy()


# ---------------------------------------------------------------------------
# step_ladder
# ---------------------------------------------------------------------------

def test_step_ladder_as_a_process(tmp_path):
    """`python -m ...step_ladder --device cpu` in smoke mode: the JAX keys,
    one entry a batch, the same object in --out; --help needs no device."""
    out = tmp_path / "ladder.json"
    env = dict(os.environ, ZLT_BENCH_SMOKE="1", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch.step_ladder",
         "--device", "cpu", "--out", str(out)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(doc) == {"ladder", "variant", "size", "device"}
    assert sorted(doc["ladder"]) == ["1", "2"]
    assert all(v > 0 for v in doc["ladder"].values())
    assert (doc["variant"], doc["size"], doc["device"]) == ("yolov8p", 64,
                                                           "cpu")
    assert json.loads(out.read_text()) == doc
    helped = subprocess.run(
        [sys.executable, "-m", "zero_latency_yolo_tpu_torch.step_ladder",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert helped.returncode == 0 and "ZLT_LADDER" in helped.stdout


def test_step_ladder_topk_key_and_failed_batch(smoke, monkeypatch):
    """ZLT_LADDER_TOPK adds pre_nms_topk; a batch that fails is left out of
    the ladder and the tool exits 1."""
    monkeypatch.setenv("ZLT_LADDER_TOPK", "32")
    real = bench_util.measure_cached_step

    def flaky(engine, batch, *a, **kw):
        if batch == 2:
            raise RuntimeError("injected")
        return real(engine, batch, *a, **kw)
    monkeypatch.setattr(bench_util, "measure_cached_step", flaky)
    rc, lines = run_tool(step_ladder, ["--device", "cpu"])
    assert rc == 1
    assert lines[-1]["pre_nms_topk"] == 32
    assert sorted(lines[-1]["ladder"]) == ["1"]


# ---------------------------------------------------------------------------
# the A/B sweeps
# ---------------------------------------------------------------------------

def test_conv1x1_compare_keys_and_per_call_rows(smoke):
    rc, lines = run_tool(conv1x1_compare, ["--device", "cpu"])
    assert rc == 0
    out, calls = lines[-1], lines[:-1]
    assert {"rows", "device"} <= set(out) and out["device"] == "cpu"
    assert [r["tag"] for r in out["rows"]] == ["kernel", "library",
                                               "kernel-repeat"]
    for r in out["rows"]:
        assert {"batch", "conv1x1", "tag", "step_ms", "fps",
                "relay_rtt_ms"} <= set(r)
        # CPU tensors run the plain versions: no kernel launches.
        assert not any(r["launches"].values())
    shapes = {(c["m"], c["cin"], c["cout"], c["act"]) for c in calls}
    assert len(shapes) == len(calls) > 0
    assert sum(c["count"] for c in calls) == 24  # yolov8p's 1x1 convs, slice


def test_conv1x1_library_route_matches_jax_step():
    """The step with every 1x1 conv as torch.addmm + F.silu (f32) against
    the JAX package's cached step on the same frames and params, and against
    the port's kernel route."""
    bucket, hw = (96, 96), (64, 96)
    cfg = bench_util.serving_config_dict("yolov8p", 64, [2], bucket,
                                         dtype="float32")
    tree = bench_util.seeded_params("yolov8p")
    frames = np.random.default_rng(3).integers(0, 256, (2,) + bucket + (3,),
                                               dtype=np.uint8)
    eng = InferenceEngine(bench_util.serving_config("yolov8p", 64, [2],
                                                    bucket, dtype="float32"),
                          params=tree, device="cpu")
    lib = port_cached_output(eng, 2, 64, frames, hw, conv1x1="library")
    kern = port_cached_output(eng, 2, 64, frames, hw)
    (want,) = jax_cached_outputs(cfg, tree, [(2, 64)], frames, hw)
    assert want[:, 0].sum() > 0, "vacuous: no detections"
    kernels_vs_plain(lib, want, "library route", against="JAX")
    kernels_vs_plain(lib, kern, "library route", against="kernel route")
    with pytest.raises(ValueError, match="conv1x1 route"):
        port_cached_output(eng, 2, 64, frames, hw, conv1x1="cublas")


def test_layout_compare_keys(smoke):
    rc, lines = run_tool(layout_compare, ["--device", "cpu"])
    assert rc == 0
    out = lines[-1]
    assert {"rows", "variant", "size", "pre_nms_topk", "device"} <= set(out)
    assert [r["tag"] for r in out["rows"]] == [
        "concat+slice", "perlevel+slice", "concat+split", "perlevel+split",
        "concat+slice+repeat"]
    assert all({"batch", "select", "c2f", "tag", "step_ms", "fps",
                "relay_rtt_ms"} <= set(r) for r in out["rows"])


def test_perf_sweep_keys_and_same_route_rows(tmp_path):
    rc, lines = run_tool(perf_sweep, [
        "--device", "cpu", "--batch", "2", "--size", "64", "--variant",
        "yolov8p", "--dtype", "float32", "--bucket-h", "96", "--bucket-w",
        "96", "--height", "64", "--width", "96"])
    assert rc == 0
    out = lines[-1]
    assert {"metric", "batch", "size", "device", "results"} <= set(out)
    res = out["results"]
    assert res["dot1x1"] == {"same_route_as": "baseline"}
    assert res["s2d+dot1x1"] == {"same_route_as": "s2d"}
    assert res["baseline"]["step_ms"] > 0 and res["s2d"]["step_ms"] > 0


def test_width_ladder_keys(smoke):
    rc, lines = run_tool(width_ladder, ["--device", "cpu"])
    assert rc == 0
    rows = lines[-1]["rows"]
    assert [r["tag"] for r in rows] == ["w0.125", "w0.1", "w0.125-repeat"]
    assert all({"batch", "width", "tag", "step_ms", "fps",
                "relay_rtt_ms"} <= set(r) for r in rows)


def test_floor_split_bench_keys_and_rungs_match_jax(smoke):
    rc, lines = run_tool(floor_split_bench, ["--device", "cpu"])
    assert rc == 0
    out = lines[-1]
    assert {"rows", "variant", "size", "rung", "device"} <= set(out)
    assert [r["cycle"] for r in out["rows"]] == ["b1@32", "b1@64+b1@32"]
    assert all({"cycle", "ms", "rtt_ms"} <= set(r) for r in out["rows"])
    # Both rungs of the tool's engine, in f32, against the JAX engine.
    su = floor_split_bench.setup(True, "float32", "cpu")
    frames = np.random.default_rng(4).integers(
        0, 256, (2,) + tuple(su.bucket) + (3,), dtype=np.uint8)
    steps = [(2, su.size), (2, su.rung)]
    want = jax_cached_outputs(su.config, bench_util.seeded_params(su.variant),
                              steps, frames, su.hw)
    for (b, sz), w in zip(steps, want):
        assert w[:, 0].sum() > 0, f"vacuous at {sz}"
        got = port_cached_output(su.engine, b, sz, frames, su.hw)
        kernels_vs_plain(got, w, f"rung {sz}", against="JAX")


def test_pack_proxy_keys_and_packed_forward_matches_jax(smoke):
    rc, lines = run_tool(pack_proxy, ["--device", "cpu"])
    assert rc == 0
    (pair,) = lines[-1]["pairs"]
    assert set(pair) == {"variant", "batch", "size", "flat_ms",
                         "flat_rtt_ms", "packed_ms", "packed_rtt_ms",
                         "packed_speedup"}
    # The packed shape (B/4, 2S) of the smoke row, f32.
    x = np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    got = pack_proxy.forward_runner("yolov8p", x, torch.float32,
                                    "cpu")().numpy()
    spec = jax_model.get_spec("yolov8p", 4)
    want = np.asarray(jax.jit(lambda p, xx: jax_model.forward_decoded(
        p, spec, xx))(bench_util.seeded_params("yolov8p"), jnp.asarray(x)))
    assert got.shape == want.shape
    box = np.abs(got[..., :4] - want[..., :4]).max() / 128
    prob = np.abs(got[..., 4:] - want[..., 4:]).max()
    assert box < 1e-3 and prob < 1e-3, (box, prob)


def test_a_failed_row_makes_the_sweep_exit_1(smoke, monkeypatch):
    """The rows that ran are kept and printed; the one that failed is
    FAILED on stderr and the exit code is 1."""
    real = bench_util.pipeline_step_seconds
    calls = []

    def flaky(run_once, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return real(run_once, **kw)
    monkeypatch.setattr(bench_util, "pipeline_step_seconds", flaky)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, lines = run_tool(floor_split_bench, ["--device", "cpu"])
    assert rc == 1
    assert [r["cycle"] for r in lines[-1]["rows"]] == ["b1@32"]
    assert "b1@64+b1@32 FAILED: RuntimeError: injected" in err.getvalue()


# ---------------------------------------------------------------------------
# trace_analyze
# ---------------------------------------------------------------------------

def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
            "ts": ts, "dur": dur}


HAND_TRACE = [
    # step 1
    _ev("void (anonymous namespace)::conv1x1_wgmma_kernel<64, 4>(x)", 0, 10),
    _ev("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc", 12, 8),
    _ev("void (anonymous namespace)::bias_silu_vec_kernel<bf16>(y)", 20, 4),
    _ev("Memcpy HtoD (Pinned -> Device)", 30, 5, "gpu_memcpy"),
    _ev("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 35, 3),
    _ev("void at::native::reduce_kernel<128, 4>(r)", 38, 2),
    _ev("void at::native::vectorized_elementwise_kernel<4>(e)", 40, 1),
    _ev("void at::native::max_pool_forward_nhwc<bf16>(p)", 41, 1),
    _ev("void (anonymous namespace)::nms_keep_kernel(k)", 44, 2),
    # step 2: the 1x1 kernel twice, overlapping the conv (a second stream)
    _ev("void (anonymous namespace)::conv1x1_wgmma_kernel<64, 4>(x)", 100, 6),
    _ev("void (anonymous namespace)::conv1x1_wgmma_kernel<64, 4>(x)", 106, 6),
    _ev("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc", 110, 4),
    # not device work: host ops, a range on the device timeline, metadata
    _ev("aten::conv2d", 0, 500, "cpu_op"),
    _ev("zlt_nms_and_compact", 40, 10, "gpu_user_annotation"),
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "gpu"}},
]


def test_trace_rollup_of_a_hand_built_trace(tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": HAND_TRACE}))
    r = trace_analyze.rollup(trace_analyze.read_trace(str(tmp_path)), 2)
    assert r["lane"] == "device" and r["events"] == 12
    # Device total 52 us over 2 steps.
    assert r["ms_per_step"] == pytest.approx(0.026)
    cats = {c: v["ms"] for c, v in r["categories"].items()}
    assert cats == pytest.approx({
        "port:conv1x1_bias_act": 0.011, "conv": 0.006,
        "port:bias_silu": 0.002, "copy/layout": 0.0025, "gemm": 0.0015,
        "reduction": 0.001, "elementwise": 0.0005, "other": 0.0005,
        "port:nms_keep": 0.001})
    # Launches a step round down; the totals keep the odd launches.
    assert r["port_kernels"] == {
        "conv1x1_bias_act": {"ms": pytest.approx(0.011), "launches": 1,
                             "launches_total": 3},
        "bias_silu": {"ms": pytest.approx(0.002), "launches": 0,
                      "launches_total": 1},
        "nms_keep": {"ms": pytest.approx(0.001), "launches": 0,
                     "launches_total": 1}}
    assert r["top"][0][2].startswith("void (anonymous namespace)::conv1x1")
    # Busy: [0,10] [12,24] [30,42] [44,46] [100,114] = 50 us of a 114 us
    # window.
    assert r["busy_ms"] == pytest.approx(0.050)
    assert r["window_ms"] == pytest.approx(0.114)
    assert r["idle_share"] == pytest.approx(1 - 50 / 114)
    sums = sum(v["share"] for v in r["categories"].values())
    assert sums == pytest.approx(1.0)


def test_trace_analyze_reads_a_cpu_trace_of_profiling_trace(tmp_path):
    """A trace utils/profiling.trace wrote on the CPU has no device events:
    the tool rolls up the host lane's outermost operators (and says so)."""
    from zero_latency_yolo_tpu_torch.utils.profiling import trace
    x = torch.randn(32, 32)
    with trace(str(tmp_path)):
        for _ in range(3):
            torch.nn.functional.silu(x @ x + 1.0)
    rc, lines = run_tool(trace_analyze, ["--analyze-only", str(tmp_path),
                                         "--steps", "3"])
    assert rc == 0
    r = lines[-1]
    assert r["lane"] == "host" and r["device"] is None
    names = {name for _, _, name in r["top"]}
    assert {"aten::matmul", "aten::add", "aten::silu"} <= names
    # Outermost only: aten::mm runs inside aten::matmul.
    assert "aten::mm" not in names
    assert {n: c for _, c, n in r["top"]}["aten::matmul"] == 1
    assert 0.0 <= r["idle_share"] < 1.0


def test_trace_analyze_traces_the_cached_step_on_the_cpu(tmp_path):
    rc, lines = run_tool(trace_analyze, [
        "--device", "cpu", "--batch", "1", "--size", "64", "--variant",
        "yolov8p", "--dtype", "float32", "--steps", "2", "--bucket-h", "96",
        "--bucket-w", "96", "--height", "64", "--width", "96",
        "--trace-dir", str(tmp_path / "t")])
    assert rc == 0
    r = lines[-1]
    assert r["lane"] == "host" and r["device"] == "cpu" and r["batch"] == 1
    assert (tmp_path / "t" / "trace.json").exists()


# ---------------------------------------------------------------------------
# lane_physics, spmd_overhead, wire_ceiling
# ---------------------------------------------------------------------------

def test_lane_physics_accounts_for_every_request(tmp_path):
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps({"ladder": {"2": 1.0, "8": 2.0},
                                "variant": "yolov8n", "size": 416,
                                "device": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    rc, rows = run_tool(lane_physics, [str(path), "--battery", "single",
                                       "--streams", "8", "--fps", "60",
                                       "--duration", "1"])
    assert rc == 0
    (row,) = rows
    assert {"ladder", "window_ms", "offered_fps", "streams", "served_fps",
            "detect_avg_ms", "detect_p50_ms", "detect_p99_ms", "dropped",
            "cpu_steal_pct"} <= set(row)
    assert row["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert row["submitted"] > 0 and row["results"] > 0
    assert row["unaccounted"] == 0
    assert row["submitted"] == row["results"] + row["dropped"]


def test_lane_physics_top_bucket_rule_and_no_default_ladder(tmp_path):
    assert lane_physics.ladder_buckets({"2": 1.0, "16": 3.0}) == (2, 4, 8, 16)
    assert lane_physics.ladder_buckets({"1": 1.0}) == (1,)
    assert lane_physics.ladder_buckets({"128": 9.0}) == (2, 4, 8, 16, 32, 64)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            lane_physics.main([])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"variant": "yolov8n"}))
    with contextlib.redirect_stderr(io.StringIO()):
        rc, rows = run_tool(lane_physics, [str(bad)])
    assert rc == 1 and rows == []


def test_spmd_overhead_on_a_virtual_2x1_cpu_mesh():
    rc, lines = run_tool(spmd_overhead, [
        "--device", "cpu", "--mode", "equal-total", "--reps", "1",
        "--duration", "0.5"])
    assert rc == 0
    out = lines[-1]
    assert {"method", "single", "dp2", "reps", "detect_avg_delta_ms",
            "detect_p99_delta_ms", "pipeline_avg_delta_ms"} <= set(out)
    assert out["virtual"] is True and out["mesh"] == "2x1"
    assert out["results_equal"]["equal"]
    assert out["results_equal"]["detections"] > 0
    for arm in ("single", "dp2"):
        assert out[arm]["results"] > 0


def test_wire_ceiling_knee_rule():
    def row(s, p99, served, offered, **kw):
        return dict(streams=s, detect_p99_ms=p99, served_fps=served,
                    offered_fps=offered, **kw)
    rows = [row(8, 3.0, 480.0, 480.0), row(16, 9.0, 960.0, 960.0),
            row(24, 7.0, 1400.0, 1440.0),   # 97.2% served: not under
            row(32, 7.5, 1900.0, 1920.0),   # 98.96%: under
            {"streams": 40, "error": "boom"},
            row(48, 2.0, 100.0, 2000.0, client_saturated=True),
            row(56, 1.0, 3360.0, 3360.0)]   # past the saturated rung
    assert wire_ceiling.knee(rows, 8.0) == 32
    assert wire_ceiling.knee(rows, 2.0) == 0
    assert wire_ceiling.knee(rows[:1], 8.0) == 8
    assert wire_ceiling.knee([], 8.0) == 0


def test_wire_ceiling_one_rung_and_no_default_ladder(tmp_path):
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            wire_ceiling.main(["--device", "cpu"])
    path = tmp_path / "ladder.json"
    path.write_text(json.dumps({"ladder": {"1": 1.0, "2": 1.5},
                                "variant": "yolov8n", "device": "cpu"}))
    rc, lines = run_tool(wire_ceiling, [
        "--ladder", str(path), "--device", "cpu", "--start", "2",
        "--max-streams", "2", "--fps", "20", "--duration", "1"])
    assert rc == 0
    out = lines[-1]
    assert {"method", "ladder", "fps_per_stream", "rows", "fleet_rows",
            "knee_streams_under_slo", "slo_ms"} <= set(out)
    (r,) = out["rows"]
    assert r["streams"] == 2 and r["results_received"] > 0
    # Every offered frame served or counted, but those still in flight.
    assert 0 <= r["short"] <= 2 + r["socket_drops"]


def test_no_tool_reads_the_committed_tpu_ladders():
    """No string in a measurement tool's code (its docstrings aside) names
    artifacts/, whose step ladders are a TPU's."""
    import ast
    for mod in (step_ladder, trace_analyze, conv1x1_compare, layout_compare,
                perf_sweep, width_ladder, floor_split_bench, pack_proxy,
                lane_physics, spmd_overhead, wire_ceiling):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        strings = [n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)
                   and id(n) not in docs]
        assert not [x for x in strings if "artifacts" in x], mod.__name__


@pytest.mark.parametrize("cin,cout,k,stride,h,w", [
    (3, 16, 3, 2, 13, 11), (16, 32, 3, 1, 9, 9), (8, 8, 3, 2, 8, 8),
    (32, 16, 1, 1, 5, 7)])
def test_int8_im2col_columns_give_the_int8_conv(cin, cout, k, stride, h, w):
    """chip_smoke.int8_im2col, the int8 library yardstick's columns, times
    the packed weight equals the int8 conv's int32 accumulators (its plain
    version), so the yardstick computes the kernel's function."""
    from chip_smoke import int8_im2col
    from zero_latency_yolo_tpu_torch.ops import conv_int8_cuda as ci
    g = torch.Generator().manual_seed(cin + k)
    x = torch.randn(2, h, w, cin, generator=g)
    xs = torch.tensor(0.02)
    wp = ci.pack_weight(torch.randint(-127, 128, (cout, k, k, cin),
                                      generator=g, dtype=torch.int8))
    xq = ci.quantize_activations(x, xs).to(torch.int8)
    cols = int8_im2col(torch, xq, k, stride, wp.shape[1])
    acc = ci.conv_int8_acc_plain(x, xs, wp, k, stride)
    got = (cols.long() @ wp.t().long()).view(acc.shape)
    assert torch.equal(got.to(acc.dtype), acc)
