"""The engine surface the port's server calls, on the CPU: the registry
under the JAX package's names, SimulationEngine, the refusals of what is
not ported (serve-size ladders, adaptive SLO, the device frame cache), hot
reload staged on the watcher thread and applied by the dispatch thread, and
dataset capture through the server. Where the JAX engine has the same
surface, both are held to the same answers."""

import os
import threading
import time

import numpy as np
import pytest

from zero_latency_yolo_tpu_torch.config import ServerConfig
from zero_latency_yolo_tpu_torch.models.weights import flatten
from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
from zero_latency_yolo_tpu_torch.runtime import engine as eng_mod
from zero_latency_yolo_tpu_torch.runtime.engine import (
    ENGINE_REGISTRY, InferenceEngine, InferenceRequest, SimulationEngine,
    create_engine,
)


def _cfg(model_path="/nonexistent.npz", **top):
    return ServerConfig.from_dict({
        "model_path": model_path,
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                "pre_nms_topk": 64, "frame_buckets": [[96, 96]],
                "batch_buckets": [1, 2]},
        **top})


def _save(params, path):
    np.savez(path, **flatten(params))


def _req(fid=0, seed=0):
    rng = np.random.default_rng(seed)
    return InferenceRequest(client_id=1, frame_id=fid, timestamp=fid,
                            width=96, height=64,
                            data=rng.integers(0, 256, (64, 96, 3), np.uint8))


def _rows(results):
    return [[(d.x, d.y, d.width, d.height, d.confidence, d.class_id)
             for d in r.detections] for r in results]


@pytest.mark.parametrize("name,cls", [("jax", InferenceEngine),
                                      ("onnx", InferenceEngine),
                                      ("simulation", SimulationEngine),
                                      ("  Simulation ", SimulationEngine),
                                      ("no-such-engine", InferenceEngine)])
def test_create_engine_uses_the_jax_registry_names(name, cls):
    eng = create_engine(_cfg(inference_engine=name), device="cpu")
    assert type(eng) is cls
    assert eng.simulation  # no model file: simulation either way


def test_registry_names_match_the_jax_package():
    jax_engine = pytest.importorskip("zero_latency_yolo_tpu.runtime.engine")
    assert set(ENGINE_REGISTRY) == set(jax_engine.ENGINE_REGISTRY)


def test_simulation_engine_ignores_a_model_file(tmp_path):
    path = tmp_path / "m.npz"
    _save(init_params(0, get_spec("yolov8p", 4)), path)
    sim = SimulationEngine(_cfg(str(path)), device="cpu")
    assert sim.simulation and sim._params is None
    assert not sim.maybe_reload()
    res = sim.complete(sim.dispatch([_req()]))
    assert len(res) == 1 and res[0].serve_size == 64
    assert not InferenceEngine(_cfg(str(path)), device="cpu").simulation


def test_refusals_of_what_is_not_ported():
    eng = InferenceEngine(_cfg(), params=init_params(0, get_spec("yolov8p", 4)),
                          device="cpu")
    assert eng.serve_sizes == (64,) and eng.max_inflight == 2
    assert eng.effective_serve_size() == eng.effective_serve_size(1000) == 64
    assert not eng.update_adaptive_slo(5.0)
    assert eng.update_adaptive_slo(0.0)
    with pytest.raises(ValueError, match="frame cache"):
        eng.warmup(cache=object())
    with pytest.raises(ValueError, match="serve size"):
        eng.dispatch([_req()], size=32)
    req = _req()
    req.data = None
    with pytest.raises(ValueError, match="frame cache"):
        eng.dispatch([req])
    assert eng.warmup([1], [(96, 96)], None, 2) >= 0.0 and eng.warmed
    assert len(eng.complete(eng.dispatch([_req()], size=64))) == 1


def test_refusals_match_the_jax_engine_without_a_ladder():
    """The JAX engine without a serve-size ladder answers the server's
    calls the same way."""
    jax_engine = pytest.importorskip("zero_latency_yolo_tpu.runtime.engine")
    from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig
    d = {"model_path": "/nonexistent.npz",
         "detection": {"model_width": 64, "model_height": 64},
         "tpu": {"variant": "yolov8p", "num_classes": 4,
                 "frame_buckets": [[96, 96]], "batch_buckets": [1, 2]}}
    ref = jax_engine.SimulationEngine(JaxConfig.from_dict(d))
    mine = SimulationEngine(ServerConfig.from_dict(d), device="cpu")
    for slo in (5.0, 0.0):
        assert mine.update_adaptive_slo(slo) == ref.update_adaptive_slo(slo)
    for floor in (0, 32, 64, 1000):
        assert (mine.effective_serve_size(floor)
                == ref.effective_serve_size(floor))
    assert mine.serve_sizes == ref.serve_sizes
    assert mine.max_inflight == ref.max_inflight


def test_hot_reload_stages_then_swaps_on_the_dispatch_thread(tmp_path):
    """maybe_reload hashes the file and stages the new params on the host;
    the device copy is made by the next dispatch, on the dispatching
    thread; an unchanged file, an unloadable one and another geometry are
    refused."""
    spec = get_spec("yolov8p", 4)
    a, b = init_params(0, spec), init_params(1, spec)
    path = tmp_path / "m.npz"
    _save(a, path)
    eng = InferenceEngine(_cfg(str(path)), device="cpu")
    ref_a = InferenceEngine(_cfg(), params=a, device="cpu")
    ref_b = InferenceEngine(_cfg(), params=b, device="cpu")
    reqs = [_req(i, seed=i) for i in range(2)]
    want_a = _rows(ref_a.infer_batch(reqs))
    want_b = _rows(ref_b.infer_batch(reqs))
    assert want_a != want_b
    assert _rows(eng.infer_batch(reqs)) == want_a
    assert not eng.maybe_reload()          # same file: nothing staged

    _save(b, path)
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 10 ** 9))
    placed = []
    real_place = eng_mod.place_params

    def spy(params, device, dtype):
        placed.append(threading.current_thread().name)
        return real_place(params, device, dtype)
    eng_mod.place_params = spy
    try:
        watcher = threading.Thread(target=lambda: placed.append(
            ("staged", eng.maybe_reload())), name="watcher")
        watcher.start()
        watcher.join()
        assert placed == [("staged", True)]  # nothing placed on the watcher
        assert _rows(eng.infer_batch(reqs)) == want_b
        assert placed[1:] == [threading.current_thread().name]
    finally:
        eng_mod.place_params = real_place
    assert not eng.maybe_reload()

    (tmp_path / "bad.npz").write_bytes(b"not an npz")
    eng.config.model_path = str(tmp_path / "bad.npz")
    assert not eng.maybe_reload() and eng._failed_hash
    other = tmp_path / "n.npz"
    _save(init_params(0, get_spec("yolov8n", 4)), other)
    eng.config.model_path = str(other)
    assert not eng.maybe_reload()          # another geometry: restart
    assert _rows(eng.infer_batch(reqs)) == want_b


def test_hot_reload_leaves_simulation(tmp_path):
    path = tmp_path / "m.npz"
    eng = InferenceEngine(_cfg(str(path)), device="cpu")
    assert eng.simulation and not eng.maybe_reload()
    params = init_params(2, get_spec("yolov8p", 4))
    _save(params, path)
    assert eng.maybe_reload()
    assert eng.simulation                  # until the next dispatch
    got = _rows(eng.infer_batch([_req()]))
    assert not eng.simulation
    ref = InferenceEngine(_cfg(), params=params, device="cpu")
    assert got == _rows(ref.infer_batch([_req()]))


def test_capture_through_the_server(tmp_path):
    """Dataset capture: served raw frames are written with their
    detections as a YOLO directory."""
    from test_torch_server import ServerHarness, free_port
    from zero_latency_yolo_tpu_torch.runtime.server import DetectionServer
    from zero_latency_yolo_tpu_torch.runtime.simulator import (
        SimClient, synthetic_frame)
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent/model.npz",
        "port": free_port(), "web_port": 0, "max_clients": 2,
        "analytics": {"capture_dir": str(tmp_path),
                      "capture_sample_every": 1,
                      "capture_min_confidence": 0.0},
        "tpu": {"batch_window_ms": 1.0, "frame_buckets": [[64, 96]],
                "batch_buckets": [1, 2]}})
    h = ServerHarness(DetectionServer(cfg, device="cpu"))
    server = h.start()
    c = SimClient(("127.0.0.1", server.port), screen_width=96,
                  screen_height=64)
    try:
        c.connect()
        c.start_receiver()
        for seed in range(3):  # one at a time: none superseded
            c.send_raw_frame(synthetic_frame(96, 64, seed=seed))
            assert len(c.wait_results(seed + 1, timeout=20.0)) == seed + 1
        deadline = time.time() + 20
        while time.time() < deadline and server._capture.written < 3:
            time.sleep(0.02)
        st = server.status()["capture"]
        assert st["written"] == 3 and st["dir"] == str(tmp_path)
    finally:
        c.stop()
        h.stop()
    imgs = sorted(os.listdir(tmp_path / "images"))
    lbls = sorted(os.listdir(tmp_path / "labels"))
    assert len(imgs) == len(lbls) == 3
    assert all(i.endswith(".jpg") for i in imgs)
