"""Adaptive-resolution serving in the PyTorch port, on the CPU: the port's
counterpart of every case of tests/test_adaptive.py but the two of the
serving mesh (tpu.serve_sizes / tpu.adaptive_slo_ms: size-keyed steps, the
SLO-driven ladder policy with its hysteresis and upshift holddown, warmup
over every rung, accuracy floors, the synthetic step, the server's wire
paths), with the same yolov8p engine, 64/32/96 rungs and synthetic ladders;
and the port's step at each rung against the JAX step at that rung."""

import asyncio
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)
from zero_latency_yolo_tpu_torch.config import ServerConfig  # noqa: E402
from zero_latency_yolo_tpu_torch.models.weights import flatten  # noqa: E402
from zero_latency_yolo_tpu_torch.models.yolov8 import (  # noqa: E402
    get_spec, init_params)
from zero_latency_yolo_tpu_torch.runtime.engine import (  # noqa: E402
    InferenceEngine, InferenceRequest, SimulationEngine)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_server import ServerHarness, free_port  # noqa: E402


def _cfg(**tpu_over):
    tpu = {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
           "batch_buckets": [1, 2], "frame_buckets": [[96, 96]],
           "pre_nms_topk": 64, "serve_sizes": [64, 32]}
    tpu.update(tpu_over)
    return ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "confidence_threshold": 0.25,
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": tpu,
    })


def _params(seed):
    return init_params(seed, get_spec("yolov8p", 4), folded=True)


def _engine(cfg, seed):
    return InferenceEngine(cfg, params=_params(seed), device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine(_cfg(), 0)


def _req(cid, fid, seed=0):
    rng = np.random.default_rng(seed)
    return InferenceRequest(
        client_id=cid, frame_id=fid, timestamp=1000 + fid, width=96,
        height=72, data=rng.integers(0, 256, (72, 96, 3), dtype=np.uint8))


def _sizes(eng):
    return {k[-1] for k in eng._step_cache if not isinstance(k[0], str)}


def test_config_rejects_bad_sizes():
    with pytest.raises(ValueError, match="multiple of 32"):
        _cfg(serve_sizes=[64, 48])
    with pytest.raises(ValueError, match="ladder"):
        ServerConfig.from_dict({
            "detection": {"model_width": 64},
            "tpu": {"adaptive_slo_ms": 8.0}})


def test_ladder_includes_model_size(engine):
    assert engine.serve_sizes == (64, 32)
    assert engine._serve_size == 64


def test_serves_every_rung_with_consistent_boxes(engine):
    """The same frame through both rungs: two steps, boxes normalized to the
    source frame."""
    r64 = engine.infer_batch([_req(1, 1, seed=3)])[0]
    engine._serve_size = 32
    try:
        r32 = engine.infer_batch([_req(1, 2, seed=3)])[0]
    finally:
        engine._serve_size = 64
    assert (r64.serve_size, r32.serve_size) == (64, 32)
    for r in (r64, r32):
        for d in r.detections:
            assert 0 <= d.x <= 1 and 0 <= d.y <= 1
    assert {32, 64} <= _sizes(engine)


def test_warmup_compiles_all_rungs_when_policy_enabled():
    eng = _engine(_cfg(batch_buckets=[1], adaptive_slo_ms=8.0), 1)
    eng.warmup(batches=[1], buckets=[(96, 96)])
    assert _sizes(eng) == {32, 64}


def test_warmup_skips_unreachable_rungs_without_slo():
    """serve_sizes without adaptive_slo_ms: nothing can switch sizes, so
    warmup runs only the current rung."""
    eng = _engine(_cfg(batch_buckets=[1]), 2)
    eng.warmup(batches=[1], buckets=[(96, 96)])
    assert _sizes(eng) == {64}


def _prime(engine, ms, n=32):
    for _ in range(n):
        engine._adapt_stats.record(ms)


def test_policy_downshifts_then_recovers(engine):
    engine.adaptive_slo_ms = 8.0
    try:
        _prime(engine, 20.0)
        engine._adapt_next_check = 0.0
        engine._maybe_adapt()
        assert engine._serve_size == 64  # hysteresis: the first hot check holds
        engine._adapt_next_check = 0.0
        engine._maybe_adapt()
        assert engine._serve_size == 32
        assert engine.size_downshifts >= 1
        assert engine._adapt_stats.snapshot()["count"] == 0
        for _ in range(8):
            _prime(engine, 2.0)
            engine._adapt_next_check = 0.0
            engine._maybe_adapt()
        assert engine._serve_size == 64
        assert engine.size_upshifts >= 1
    finally:
        engine.adaptive_slo_ms = 0.0
        engine._serve_size = 64


def test_policy_neutral_band_resets_counters(engine):
    engine.adaptive_slo_ms = 8.0
    try:
        _prime(engine, 20.0)
        engine._adapt_next_check = 0.0
        engine._maybe_adapt()
        assert engine._adapt_hot == 1
        engine._adapt_stats = type(engine._adapt_stats)(window=256)
        _prime(engine, 6.0)
        engine._adapt_next_check = 0.0
        engine._maybe_adapt()
        assert engine._adapt_hot == 0 and engine._serve_size == 64
    finally:
        engine.adaptive_slo_ms = 0.0
        engine._serve_size = 64


def test_simulation_never_adapts():
    eng = InferenceEngine(_cfg(adaptive_slo_ms=8.0), device="cpu")
    assert eng.simulation
    _prime(eng, 50.0)
    for _ in range(4):
        eng._adapt_next_check = 0.0
        eng._maybe_adapt()
    assert eng._serve_size == 64


def test_downshift_through_real_completion_path():
    """Through infer_batch -> dispatch -> complete -> _convert: with an
    impossible SLO every completion feeds the policy, and the engine steps
    down without anyone calling _maybe_adapt."""
    eng = _engine(_cfg(adaptive_slo_ms=0.001, batch_buckets=[1, 8]), 3)
    assert eng._serve_size == 64
    i = 0
    while eng._serve_size == 64 and i < 30:
        eng.infer_batch([_req(c + 1, i * 8 + c, seed=i) for c in range(8)])
        eng._adapt_next_check = 0.0
        i += 1
    assert eng._serve_size == 32
    assert eng.size_downshifts == 1
    assert eng.status()["serve_size"] == "32"
    out = eng.infer_batch([_req(99, 1, seed=1)])[0]
    assert out.serve_size == 32
    for d in out.detections:
        assert 0 <= d.x <= 1 and 0 <= d.y <= 1


def test_status_reports_serve_size(engine):
    st = engine.status()
    assert st["serve_size"] == "64"
    assert st["size_downshifts"] == str(engine.size_downshifts)
    assert st["size_upshifts"] == str(engine.size_upshifts)


def test_synthetic_per_size_profiles_drive_policy():
    """Per-size synthetic ladders: the fake lane reads the current serve
    size and the policy runs on it, without a device."""
    cfg = _cfg(adaptive_slo_ms=8.0,
               synthetic_step_profiles={"64": {"1": 20.0, "8": 20.0},
                                        "32": {"1": 2.0, "8": 2.0}},
               batch_buckets=[1, 8])
    eng = InferenceEngine(cfg, device="cpu")
    assert eng.simulation and eng._params is None
    assert eng._synthetic_step(1) == 20.0
    i = 0
    while eng._serve_size == 64 and i < 40:
        eng.infer_batch([_req(c + 1, i * 8 + c) for c in range(8)])
        eng._adapt_next_check = 0.0
        i += 1
    assert eng._serve_size == 32 and eng.size_downshifts == 1
    assert eng._synthetic_step(1) == 2.0
    st = eng.status()
    assert st["synthetic_step_ms"] == "20.00" and "synthetic_host_p99_ms" in st


def test_synthetic_profiles_must_cover_ladder():
    with pytest.raises(ValueError, match="missing ladders"):
        InferenceEngine(_cfg(
            adaptive_slo_ms=8.0,
            synthetic_step_profiles={"64": {"1": 5.0}},
            batch_buckets=[1]), device="cpu")


def test_runtime_slo_guarded_by_warmed_rungs():
    params = _params(4)
    eng = InferenceEngine(_cfg(batch_buckets=[1]), params=params,
                          device="cpu")
    eng.warmup(batches=[1], buckets=[(96, 96)])
    assert not eng.update_adaptive_slo(8.0)
    assert eng.adaptive_slo_ms == 0.0
    eng2 = InferenceEngine(_cfg(batch_buckets=[1], adaptive_slo_ms=8.0),
                           params=params, device="cpu")
    eng2.warmup(batches=[1], buckets=[(96, 96)])
    assert eng2.update_adaptive_slo(12.0)
    eng2._apply_staged_slo()
    assert eng2.adaptive_slo_ms == 12.0
    eng2._serve_size = 32
    assert eng2.update_adaptive_slo(0.0)
    eng2._apply_staged_slo()
    assert eng2._serve_size == 64


def test_runtime_slo_refused_without_ladder():
    cfg = _cfg(batch_buckets=[1])
    cfg.tpu.serve_sizes = ()
    eng = InferenceEngine(cfg, params=_params(5), device="cpu")
    assert not eng.update_adaptive_slo(8.0)


def test_track_ids_survive_a_size_switch(tmp_path):
    """A downshift is invisible to clients: boxes stay normalized to the
    source frame, so the tracker keeps matching and track ids persist."""
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.runtime.simulator import (
        SimClient, synthetic_frame)
    model_path = str(tmp_path / "pico.npz")
    np.savez(model_path, **flatten(_params(0)))
    cfg = _cfg(adaptive_slo_ms=8.0)
    cfg.model_path = model_path
    cfg.network.port = free_port()
    cfg.network.web_port = 0
    cfg.use_cpu_affinity = False
    cfg.use_high_priority = False
    cfg.detection.enable_tracking = True
    server = DetectionServer(cfg, device="cpu")
    assert not server.engine.simulation
    server.engine.warmup(cache=server.device_cache)
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(10)
    c = SimClient(("127.0.0.1", server.port), screen_width=96,
                  screen_height=64)
    try:
        c.connect()
        c.start_receiver()
        frame = synthetic_frame(96, 64, seed=5)

        def ids_of(fid, results):
            r = [x for x in results if x.frame_id == fid]
            assert r, f"no result for frame {fid}"
            return sorted(d.track_id for d in r[0].detections)

        f1 = c.send_raw_frame(frame)
        before = ids_of(f1, c.wait_results(1, timeout=30.0))
        server.engine._serve_size = 32
        time.sleep(0.1)
        f2 = c.send_raw_frame(frame)
        after = ids_of(f2, c.wait_results(2, timeout=30.0))
        assert before, "expected detections from the random-weights model"
        assert set(before) & set(after), (before, after)
    finally:
        c.stop()
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)


def _wire_server(cfg):
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    cfg.network.port = free_port()
    cfg.network.web_port = 0
    cfg.use_cpu_affinity = False
    cfg.use_high_priority = False
    h = ServerHarness(DetectionServer(cfg, device="cpu"))
    return h, h.start()


def _get_config(c, timeout=5.0):
    from zero_latency_yolo_tpu_torch.protocol import (CommandPacket,
                                                      CommandType)
    with c._lock:
        c.commands.clear()
    c._send(CommandPacket(command_type=CommandType.GET_CONFIG).serialize())
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with c._lock:
            for pkt in c.commands:
                if pkt.command_type == CommandType.GET_CONFIG:
                    return json.loads(pkt.command_data.decode())
        time.sleep(0.05)
    return None


def _set_config(c, settings):
    from zero_latency_yolo_tpu_torch.protocol import (CommandPacket,
                                                      CommandType)
    c._send(CommandPacket(command_type=CommandType.SET_CONFIG,
                          command_data=json.dumps(settings).encode()
                          ).serialize())


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def test_set_config_adaptive_slo_over_the_wire():
    """SET_CONFIG carrying adaptive_slo_ms in simulation (cold rungs) is
    refused atomically, the threshold not applied; a threshold-only update
    applies; GET_CONFIG echoes the adaptive state."""
    from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient
    h, server = _wire_server(_cfg())
    c = SimClient(("127.0.0.1", server.port), screen_width=96,
                  screen_height=64)
    try:
        c.connect()
        c.start_receiver()
        _set_config(c, {"confidence_threshold": 0.9, "adaptive_slo_ms": 8.0})
        time.sleep(0.5)
        assert server.engine.config.confidence_threshold != 0.9
        assert server.engine.adaptive_slo_ms == 0.0
        _set_config(c, {"confidence_threshold": 0.9})
        assert _wait(lambda: server.engine.config.confidence_threshold == 0.9)
        echo = _get_config(c)
        assert echo is not None
        assert "adaptive_slo_ms" in echo and "serve_size" in echo
    finally:
        c.stop()
        h.stop()


def test_set_config_adaptive_slo_reaches_a_warmed_ladder(tmp_path):
    """With real weights and a warmed ladder, the wire's SET_CONFIG
    adaptive_slo_ms reaches update_adaptive_slo and the dispatch thread
    applies it (GET_CONFIG and /statusz follow)."""
    from zero_latency_yolo_tpu_torch.runtime.simulator import (
        SimClient, synthetic_frame)
    model_path = str(tmp_path / "pico.npz")
    np.savez(model_path, **flatten(_params(0)))
    cfg = _cfg(adaptive_slo_ms=50.0)
    cfg.model_path = model_path
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    cfg.network.port = free_port()
    cfg.network.web_port = 0
    h = ServerHarness(DetectionServer(cfg, device="cpu"))
    server = h.start(warmup=True)
    assert server.engine._warmed_sizes == (64, 32)
    c = SimClient(("127.0.0.1", server.port), screen_width=96,
                  screen_height=64)
    try:
        c.connect()
        c.start_receiver()
        _set_config(c, {"adaptive_slo_ms": 12.5})
        assert _wait(lambda: server.engine._staged_slo == 12.5
                     or server.engine.adaptive_slo_ms == 12.5)
        c.send_raw_frame(synthetic_frame(96, 64, seed=1))
        assert c.wait_results(1, timeout=30.0)
        assert _wait(lambda: server.engine.adaptive_slo_ms == 12.5)
        assert _get_config(c)["adaptive_slo_ms"] == 12.5
        st = server.status()["engine"]
        assert st["serve_size"] == "64" and "size_downshifts" in st
    finally:
        c.stop()
        h.stop()


def test_serve_sizes_above_model_size_dropped():
    eng = _engine(_cfg(serve_sizes=[32, 64, 96], batch_buckets=[1],
                       adaptive_slo_ms=8.0), 6)
    assert eng.serve_sizes == (64, 32)
    eng.adaptive_slo_ms = 100.0
    _prime(eng, 1.0)
    eng._adapt_cool = 7
    eng._adapt_next_check = 0.0
    eng._maybe_adapt()
    assert eng._serve_size == 64


def test_runtime_slo_enable_allowed_in_synthetic_harness():
    eng = SimulationEngine(_cfg(synthetic_step_profiles={
        "64": {"1": 5.0}, "32": {"1": 3.0}}), device="cpu")
    assert eng.synthetic_step_ms > 0
    assert eng.update_adaptive_slo(8.0)
    eng._apply_staged_slo()
    assert eng.adaptive_slo_ms == 8.0
    eng2 = SimulationEngine(_cfg(), device="cpu")
    assert not eng2.update_adaptive_slo(8.0)


def test_runtime_slo_enable_resets_stats_window():
    eng = _engine(_cfg(batch_buckets=[1], adaptive_slo_ms=8.0), 7)
    eng.warmup(batches=[1], buckets=[(96, 96)])
    _prime(eng, 500.0, n=64)
    assert eng.update_adaptive_slo(12.0)
    eng._apply_staged_slo()
    assert eng._adapt_stats.snapshot()["count"] == 0


def test_failed_upshift_probe_arms_exponential_holddown(engine):
    def _check(ms):
        _prime(engine, ms)
        engine._adapt_next_check = 0.0
        engine._maybe_adapt()

    engine.adaptive_slo_ms = 8.0
    engine._upshift_fail_streak = 0
    engine._upshift_block_until = 0.0
    engine._last_upshift_t = -1e9
    try:
        _check(20.0)
        _check(20.0)
        assert engine._serve_size == 32
        for _ in range(8):
            _check(2.0)
        assert engine._serve_size == 64
        assert engine._upshift_fail_streak == 0
        _check(20.0)
        _check(20.0)
        assert engine._serve_size == 32
        assert engine._upshift_fail_streak == 1
        assert engine._upshift_block_until > 0
        for _ in range(10):
            _check(2.0)
        assert engine._serve_size == 32, "holddown must block the re-probe"
        engine._upshift_block_until = 0.0
        for _ in range(8):
            _check(2.0)
        assert engine._serve_size == 64
        _check(20.0)
        _check(20.0)
        assert engine._upshift_fail_streak == 2
        assert engine._upshift_block_until - time.perf_counter() > 30.0 * 1.5
    finally:
        engine.adaptive_slo_ms = 0.0
        engine._serve_size = 64
        engine._upshift_fail_streak = 0
        engine._upshift_block_until = 0.0
        engine._last_upshift_t = -1e9


def test_slo_change_clears_upshift_holddown(engine):
    engine.adaptive_slo_ms = 8.0
    engine._upshift_fail_streak = 3
    engine._upshift_block_until = 1e12
    try:
        with engine._slo_lock:
            engine._staged_slo = 9.0
        engine._apply_staged_slo()
        assert engine.adaptive_slo_ms == 9.0
        assert engine._upshift_fail_streak == 0
        assert engine._upshift_block_until == 0.0
    finally:
        engine.adaptive_slo_ms = 0.0
        engine._serve_size = 64


def test_cascade_downshift_counts_one_probe_failure():
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 96, "model_height": 96},
        "tpu": {"variant": "yolov8p", "num_classes": 4,
                "batch_buckets": [1], "frame_buckets": [[96, 96]],
                "serve_sizes": [96, 64, 32],
                "synthetic_step_profiles": {"96": {"1": 5.0},
                                            "64": {"1": 3.0},
                                            "32": {"1": 1.0}}},
    })
    eng = InferenceEngine(cfg, device="cpu")
    eng.adaptive_slo_ms = 8.0

    def _check(ms):
        for _ in range(32):
            eng._adapt_stats.record(ms)
        eng._adapt_next_check = 0.0
        eng._maybe_adapt()

    _check(20.0)
    _check(20.0)
    assert eng._serve_size == 64 and eng._upshift_fail_streak == 0
    for _ in range(8):
        _check(2.0)
    assert eng._serve_size == 96
    _check(20.0)
    _check(20.0)
    assert eng._serve_size == 64
    assert eng._upshift_fail_streak == 1
    _check(20.0)
    _check(20.0)
    assert eng._serve_size == 32
    assert eng._upshift_fail_streak == 1, "cascade must not double the streak"


def test_effective_serve_size_snaps_up(engine):
    engine._serve_size = 32
    try:
        assert engine.effective_serve_size(0) == 32
        assert engine.effective_serve_size(32) == 32
        assert engine.effective_serve_size(33) == 64
        assert engine.effective_serve_size(64) == 64
    finally:
        engine._serve_size = 64
    assert engine.effective_serve_size(64) == 64
    assert engine.effective_serve_size(0) == 64


def test_floored_request_served_at_higher_rung(engine):
    engine._serve_size = 32
    try:
        ra = _req(1, 1, seed=5)
        ra.min_size = 64
        rb = _req(2, 2, seed=6)
        out = engine.infer_batch([ra, rb])
        assert len(out) == 2
        by_cid = {r.client_id: r for r in out}
        assert by_cid[1].serve_size == 64
        assert by_cid[2].serve_size == 32
    finally:
        engine._serve_size = 64


def test_scheduler_splits_batch_by_floor():
    """Through the batcher: client 1 holds a floor-64 SLA while the fleet
    rung is 32; every result of client 1 serves at 64, the other's at 32."""
    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    cfg = _cfg(adaptive_slo_ms=8.0,
               synthetic_step_profiles={"64": {"1": 2.0, "8": 2.0},
                                        "32": {"1": 1.0, "8": 1.0}},
               batch_buckets=[1, 8])
    eng = InferenceEngine(cfg, device="cpu")
    assert eng.simulation
    eng._serve_size = 32
    got = []
    cv = threading.Condition()

    def on_result(results):
        with cv:
            got.extend(results)
            cv.notify()

    b = ContinuousBatcher(eng, on_result, max_batch=8, batch_window_ms=1.0)
    b.start()
    try:
        for fid in range(6):
            ra = _req(1, fid)
            ra.min_size = 64
            rb = _req(2, fid)
            b.submit(ra)
            b.submit(rb)
            with cv:
                cv.wait_for(lambda: len(got) >= (fid + 1) * 2, timeout=5)
        assert len(got) >= 12
        for r in got:
            assert r.serve_size == (64 if r.client_id == 1 else 32), \
                f"client {r.client_id} served at {r.serve_size}"
    finally:
        b.stop()


def test_floored_group_dispatched_at_its_rung_on_both_branches(tmp_path):
    """Real steps through the batcher's hosted and cached branches: with the
    fleet at 32, a floored client's group is dispatched at 64 and equals
    infer_batch at 64; the other client's equals infer_batch at 32."""
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    eng = _engine(_cfg(batch_buckets=[1, 2]), 8)
    cache = DeviceFrameCache(2, 96, 96, device="cpu")
    eng._serve_size = 32
    ra, rb = _req(1, 1, seed=21), _req(2, 2, seed=22)
    ra.min_size = 64
    for r in (ra, rb):
        assert cache.write_keyframe(r.client_id, r.data)
    want = {r.client_id: r for r in eng.infer_batch([ra, rb])}
    batcher = ContinuousBatcher(eng, lambda r: None, max_batch=2,
                                device_cache=cache)
    for cached in (False, True):
        reqs = [InferenceRequest(client_id=r.client_id, frame_id=r.frame_id,
                                 timestamp=r.timestamp, width=r.width,
                                 height=r.height, min_size=r.min_size,
                                 data=None if cached else r.data)
                for r in (ra, rb)]
        pending = batcher._dispatch(reqs)
        assert sorted(p.serve_size for p in pending) == [32, 64]
        for p in pending:
            for res in eng.complete(p):
                w = want[res.client_id]
                assert res.serve_size == w.serve_size
                assert [(d.class_id, d.x, d.y, d.confidence)
                        for d in res.detections] == [
                    (d.class_id, d.x, d.y, d.confidence)
                    for d in w.detections]


def test_min_serve_size_over_the_wire():
    """SET_CONFIG min_serve_size applies per session, out-of-range floors
    are refused atomically, a floor below the operator's default is
    refused, GET_CONFIG echoes the session's floor, /status counts it."""
    from zero_latency_yolo_tpu_torch.runtime.simulator import SimClient
    cfg = _cfg()
    cfg.detection.min_serve_size = 32
    h, server = _wire_server(cfg)
    c = SimClient(("127.0.0.1", server.port), screen_width=96,
                  screen_height=64)
    try:
        c.connect()
        c.start_receiver()
        sess = next(iter(server._sessions.values()))
        assert sess.min_serve_size == 32
        _set_config(c, {"min_serve_size": 64})
        assert _wait(lambda: sess.min_serve_size == 64)
        _set_config(c, {"min_serve_size": 128, "confidence_threshold": 0.31})
        time.sleep(0.5)
        assert sess.min_serve_size == 64
        assert server.engine.config.confidence_threshold != 0.31
        _set_config(c, {"min_serve_size": 0})
        time.sleep(0.5)
        assert sess.min_serve_size == 64
        _set_config(c, {"min_serve_size": 32})
        assert _wait(lambda: sess.min_serve_size == 32)
        _set_config(c, {"min_serve_size": 64})
        assert _wait(lambda: sess.min_serve_size == 64)
        echo = _get_config(c)
        assert echo is not None and echo.get("min_serve_size") == 64
        st = server.status()
        assert st["clients_floored"] == 1
        assert st["max_client_floor"] == 64
    finally:
        c.stop()
        h.stop()


def test_floored_samples_do_not_steer_fleet_policy(engine):
    engine._serve_size = 32
    try:
        engine._adapt_stats = type(engine._adapt_stats)(window=256)
        ra = _req(1, 1, seed=7)
        ra.min_size = 64
        engine.infer_batch([ra])
        assert engine._adapt_stats.snapshot()["count"] == 0
        engine.infer_batch([_req(2, 2, seed=8)])
        assert engine._adapt_stats.snapshot()["count"] == 1
    finally:
        engine._serve_size = 64
        engine._adapt_stats = type(engine._adapt_stats)(window=256)


def test_stale_rung_completions_stay_out_of_policy_window():
    cfg = _cfg(adaptive_slo_ms=8.0,
               synthetic_step_profiles={"64": {"1": 5.0}, "32": {"1": 1.0}},
               batch_buckets=[1])
    eng = InferenceEngine(cfg, device="cpu")
    eng._serve_size = 32
    pb = eng.dispatch([_req(1, 1)])
    eng._serve_size = 64
    eng._adapt_stats = type(eng._adapt_stats)(window=256)
    eng.complete(pb)
    assert eng._adapt_stats.snapshot()["count"] == 0
    eng.complete(eng.dispatch([_req(1, 2)]))
    assert eng._adapt_stats.snapshot()["count"] == 1


def test_dispatch_from_cache_rejects_non_bucket_count():
    eng = _engine(_cfg(batch_buckets=[2, 4]), 9)
    cache = torch.zeros((4, 96, 96, 3), dtype=torch.uint8)
    reqs = [_req(i + 1, i) for i in range(3)]
    with pytest.raises(ValueError, match="batch bucket"):
        eng.dispatch_from_cache(
            reqs, cache, np.arange(3), np.full(3, 72), np.full(3, 96))
    with pytest.raises(ValueError, match="serve size"):
        eng.dispatch_from_cache(reqs[:2], cache, np.arange(2),
                                np.full(2, 72), np.full(2, 96), size=48)


def test_partial_warmup_does_not_certify_rungs():
    eng = _engine(_cfg(batch_buckets=[1, 2], adaptive_slo_ms=8.0), 10)
    eng.warmup(batches=[1], buckets=[(96, 96)])
    assert eng._warmed_sizes == ()
    assert not eng.update_adaptive_slo(12.0)
    eng.warmup(batches=[1, 2], buckets=[(96, 96)])
    assert set(eng._warmed_sizes) == {32, 64}
    assert eng.update_adaptive_slo(12.0)


@pytest.mark.parametrize("rung", [64, 32])
def test_step_at_each_rung_matches_jax(rung):
    """The port's step at a rung against the JAX step at that rung, f32, on
    seeded frames: counts and classes equal, boxes and scores within 1e-3
    (the gate of tests/test_model_parity.py:54-63)."""
    from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig
    from zero_latency_yolo_tpu.models import yolov8 as jax_model
    from zero_latency_yolo_tpu.runtime import engine as jax_engine
    tree = jax_model.init_params(2, jax_model.get_spec("yolov8p", 4),
                                 device=False)
    for lvl in tree["m22"]["cv3"]:  # spread the scores: no near-ties
        lvl[2]["w"] = lvl[2]["w"] * 8.0
        lvl[2]["b"] = np.linspace(-2, 2, 4).astype(np.float32)
    d = {"model_path": "/nonexistent.npz", "confidence_threshold": 0.5,
         "detection": {"model_width": 64, "model_height": 64},
         "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                 "batch_buckets": [1, 4], "frame_buckets": [[96, 96]],
                 "pre_nms_topk": 64, "serve_sizes": [64, 32],
                 "adaptive_slo_ms": 8.0}}
    jeng = jax_engine.InferenceEngine(JaxConfig.from_dict(d), params=tree)
    peng = InferenceEngine(ServerConfig.from_dict(d), params=tree,
                           device="cpu")
    rng = np.random.default_rng(31)
    frames = rng.integers(0, 256, (4, 72, 96, 3), dtype=np.uint8)

    def reqs(cls):
        return [cls(client_id=i + 1, frame_id=i, timestamp=i, width=96,
                    height=72, data=frames[i]) for i in range(4)]
    want = np.asarray(jeng.dispatch(reqs(jax_engine.InferenceRequest),
                                    size=rung).out)
    got = peng.dispatch(reqs(InferenceRequest), size=rung)
    assert got.serve_size == rung
    got = got.out.numpy()
    assert np.array_equal(got[:, 0], want[:, 0])
    assert want[:, 0].sum() > 0, "vacuous: no detections"
    n = want[:, 0].astype(int)
    valid = np.arange(32)[None, :] < n[:, None]
    gb, wb = got[:, 1:129].reshape(4, 32, 4), want[:, 1:129].reshape(4, 32, 4)
    assert np.abs(gb - wb)[valid].max() < 1e-3
    assert np.abs(got[:, 129:161] - want[:, 129:161])[valid].max() < 1e-3
    assert np.array_equal(got[:, 161:][valid], want[:, 161:][valid])
