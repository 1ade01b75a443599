"""The port's ContinuousBatcher: the cases of tests/test_scheduler.py on the
port's engine (simulation, or the real step on the CPU), and its admission
policy held to the JAX batcher's on the same seeded submit sequences."""

import threading
import time

import numpy as np
import pytest

from zero_latency_yolo_tpu_torch.config import ServerConfig
from zero_latency_yolo_tpu_torch.runtime.engine import (
    InferenceEngine, InferenceRequest, PendingBatch, SimulationEngine,
)
from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher

CFG = {
    "model_path": "/nonexistent.npz",
    "detection": {"model_width": 64, "model_height": 64},
    "tpu": {"variant": "yolov8p", "num_classes": 4,
            "batch_buckets": [1, 2, 4], "frame_buckets": [[96, 96]]},
}


def _cfg(**tpu):
    return ServerConfig.from_dict({**CFG, "tpu": {**CFG["tpu"], **tpu}})


def _req(cid, fid, keyframe=False, cls=InferenceRequest, w=96, h=64):
    return cls(client_id=cid, frame_id=fid, timestamp=fid, width=w, height=h,
               data=np.zeros((h, w, 3), np.uint8), keyframe=keyframe)


def _batcher(max_batch, **kw):
    return ContinuousBatcher(SimulationEngine(_cfg(), device="cpu"),
                             lambda r: None, max_batch=max_batch, **kw)


def test_keyframe_priority_when_oversubscribed():
    b = _batcher(max_batch=2)
    b.submit(_req(1, 1))
    b.submit(_req(2, 2, keyframe=True))
    b.submit(_req(3, 3))
    b.submit(_req(4, 4, keyframe=True))
    assert [r.client_id for r in b._collect()] == [2, 4]
    assert [r.client_id for r in b._collect()] == [1, 3]


def test_round_robin_fairness_without_keyframes():
    b = _batcher(max_batch=2)
    for cid in (1, 2, 3):
        b.submit(_req(cid, cid))
    assert [r.client_id for r in b._collect()] == [1, 2]
    b.submit(_req(1, 10))
    assert [r.client_id for r in b._collect()] == [3, 1]


def test_max_batch_clamped_to_engine_buckets():
    eng = SimulationEngine(_cfg(), device="cpu")
    assert max(eng.batch_buckets) == 4
    b = ContinuousBatcher(eng, lambda r: None, max_batch=64)
    assert b.max_batch == 4
    for cid in range(1, 7):
        b.submit(_req(cid, cid))
    assert len(b._collect()) == 4


def test_supersede_counts_drops():
    b = _batcher(max_batch=4)
    before = b.engine.frames_dropped.value
    for fid in (1, 2, 3):
        b.submit(_req(1, fid))
    assert [r.frame_id for r in b._collect()] == [3]
    assert b.engine.frames_dropped.value == before + 2
    assert b.queue_depth() == 0


def test_removed_and_discarded_frames_are_counted_out():
    """remove_client and discard_pending return the frames they forget, so
    that the server can count them as drops."""
    b = _batcher(max_batch=4)
    for fid in (1, 2, 3):
        b.submit(_req(1, fid))
    b.submit(_req(2, 4))
    b.submit(_req(3, 5))
    assert b.remove_client(1) == 3
    assert b.remove_client(1) == 0
    assert b.queue_depth() == 2
    assert b.discard_pending() == 2
    assert b.queue_depth() == 0 and b._collect() == []


def test_max_queue_zero_clamped():
    b = _batcher(max_batch=2, max_queue_per_client=0)
    assert b.max_queue == 1
    assert b.submit(_req(1, 1)) is True
    assert [r.frame_id for r in b._collect()] == [1]


def test_max_inflight_one_means_no_pipelining():
    b = _batcher(max_batch=2, batch_window_ms=1.0, max_inflight=1)
    drains = []
    orig = b._complete_n

    def spy(k):
        drains.append((k, len(b._inflight)))
        return orig(k)

    b._complete_n = spy
    b.start()
    try:
        for fid in range(6):
            b.submit(_req(1, fid))
            time.sleep(0.02)
        time.sleep(0.3)
    finally:
        b.stop()
    assert len(b._inflight) == 0
    full = [(k, n) for k, n in drains if n >= 1]
    assert full and all(k >= n for k, n in full), drains


def _pico_engine(**tpu):
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    cfg = _cfg(dtype="float32", pre_nms_topk=64, **tpu)
    return InferenceEngine(cfg, params=init_params(0, get_spec("yolov8p", 4),
                                                   folded=True), device="cpu")


@pytest.mark.parametrize("inflight", [2, 8])
def test_pipeline_real_compute(inflight):
    """The batcher at pipeline depth 2 (copy started at dispatch) and 8
    (drained through complete_many) with the real step on the CPU: frames
    from four clients, everything drained at stop, staging buffers reused,
    no errors, sane detections."""
    eng = _pico_engine(max_inflight=inflight)
    got = []
    b = ContinuousBatcher(eng, lambda rs: got.extend(rs), max_batch=4,
                          batch_window_ms=2.0, max_inflight=inflight)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(4)]
    b.start()
    try:
        deadline = time.time() + 1.5
        i = 0
        while time.time() < deadline:
            for cid in range(1, 5):
                b.submit(InferenceRequest(client_id=cid, frame_id=i,
                                          timestamp=i, width=96, height=64,
                                          data=frames[cid - 1]))
            i += 1
            time.sleep(0.02)
        time.sleep(0.5)
    finally:
        b.stop()
    assert len(got) >= 8, len(got)
    assert len(b._inflight) == 0
    assert eng.error_count.value == 0
    assert sum(len(v) for v in eng._staging.values()) <= inflight + 1
    assert all(0 <= d.x <= 1 for r in got for d in r.detections)


def test_device_stall_visibility():
    b = _batcher(max_batch=2)
    assert b.device_stall_s() == 0.0
    now = time.perf_counter()
    b._inflight.append(PendingBatch(requests=[], out=object(),
                                    t0=now - 10.0, n=1))
    assert 9.5 < b.device_stall_s() < 11.0
    b._inflight.clear()
    b._inflight.append(PendingBatch(requests=[], out=object(), t0=now - 10.0,
                                    n=1, ready_at=now + 1.0))
    assert b.device_stall_s() == 0.0
    b._inflight.clear()
    b._inflight.append(PendingBatch(requests=[], out=None, t0=now - 10.0,
                                    n=1, simulated=[]))
    assert b.device_stall_s() == 0.0
    b._inflight.clear()
    b._completing_since = now - 7.0
    assert 6.5 < b.device_stall_s() < 8.0
    b._completing_since = None
    b._dispatching_since = now - 3.0
    assert 2.5 < b.device_stall_s() < 4.0


def test_partial_dispatch_failure_keeps_launched_groups():
    """A batch split into two dispatch groups (here two frame buckets)
    keeps the group already launched when the other's dispatch raises; the
    failed group is counted as dropped and as an error."""
    eng = SimulationEngine(_cfg(batch_buckets=[1, 2],
                                frame_buckets=[[96, 96], [64, 128]]),
                           device="cpu")
    real = eng.dispatch

    def flaky(requests, size=None):
        if requests[0].width == 128:
            raise RuntimeError("injected dispatch failure")
        return real(requests, size=size)

    eng.dispatch = flaky
    got = []
    cv = threading.Condition()

    def on_result(results):
        with cv:
            got.extend(results)
            cv.notify()

    b = ContinuousBatcher(eng, on_result, max_batch=2, batch_window_ms=1.0)
    b.start()
    try:
        drops0, err0 = eng.frames_dropped.value, eng.error_count.value
        b.submit(_req(1, 1, w=128, h=64))
        b.submit(_req(2, 2, w=96, h=72))
        with cv:
            cv.wait_for(lambda: len(got) >= 1, timeout=10)
        assert [r.client_id for r in got] == [2]
        assert eng.frames_dropped.value == drops0 + 1
        assert eng.error_count.value == err0 + 1
    finally:
        b.stop()


def test_requests_without_pixels_raise():
    """A request served from the device frame cache (data=None) with no
    cache configured raises, with the JAX batcher's message, instead of
    serving."""
    b = _batcher(max_batch=2)
    req = _req(1, 1)
    req.data = None
    with pytest.raises(RuntimeError, match="no device cache configured"):
        b._dispatch([req])


def test_mixed_cached_and_hosted_batch_dispatches_both_groups():
    """One batch of cached requests (data=None) and hosted ones: the cached
    group is padded to a batch bucket and served from the cache, the hosted
    group from its pixels; every request gets its own result, each equal
    to infer_batch on the same frame."""
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    from zero_latency_yolo_tpu_torch.ops.roi import DeviceFrameCache
    eng = InferenceEngine(_cfg(dtype="float32", pre_nms_topk=64),
                          params=init_params(0, get_spec("yolov8p", 4)),
                          device="cpu")
    cache = DeviceFrameCache(4, 96, 96, device="cpu")
    rng = np.random.default_rng(3)
    frames = {c: rng.integers(0, 256, (64, 96, 3), np.uint8)
              for c in (1, 2, 3, 4)}
    for c in (1, 2, 3):
        assert cache.write_keyframe(c, frames[c])
    reqs = [_req(c, 10 + c) for c in (1, 2, 3, 4)]
    for r in reqs:
        r.data = frames[r.client_id] if r.client_id == 4 else None
    b = ContinuousBatcher(eng, lambda r: None, max_batch=4,
                          device_cache=cache)
    gathered = []
    gather = eng.gather_from_cache
    eng.gather_from_cache = lambda c, s, h, w: gathered.append(
        list(s)) or gather(c, s, h, w)
    pend = b._dispatch(reqs)
    assert [len(p.requests) for p in pend] == [3, 1]
    slots = [cache.slot(c) for c in (1, 2, 3)]
    assert gathered == [slots + slots[:1]]  # padded to the bucket 4
    got = {r.client_id: r for rs in eng.complete_many(pend) for r in rs}
    assert sorted(got) == [1, 2, 3, 4]
    for c in (1, 2, 3, 4):
        want = eng.infer_batch([InferenceRequest(
            client_id=c, frame_id=10 + c, timestamp=10 + c, width=96,
            height=64, data=frames[c])])[0]
        assert got[c].frame_id == 10 + c
        assert [d.class_id for d in got[c].detections] == [
            d.class_id for d in want.detections]
        np.testing.assert_allclose(
            [[d.x, d.y, d.width, d.height, d.confidence]
             for d in got[c].detections],
            [[d.x, d.y, d.width, d.height, d.confidence]
             for d in want.detections], atol=1e-5)
    assert eng.error_count.value == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_matches_jax_batcher(seed):
    """Seeded submit / collect sequences (keyframes, several clients, queue
    overflow, oversubscription) admit the same frames in the same order in
    both packages' batchers, with the same drop counts."""
    jax_sched = pytest.importorskip("zero_latency_yolo_tpu.runtime.scheduler")
    from zero_latency_yolo_tpu.config import ServerConfig as JaxConfig
    from zero_latency_yolo_tpu.runtime import engine as jax_engine
    ours = ContinuousBatcher(SimulationEngine(_cfg(), device="cpu"),
                             lambda r: None, max_batch=3,
                             max_queue_per_client=2)
    theirs = jax_sched.ContinuousBatcher(
        jax_engine.SimulationEngine(JaxConfig.from_dict(CFG)),
        lambda r: None, max_batch=3, max_queue_per_client=2)
    rng = np.random.default_rng(seed)
    fid = 0
    for _ in range(60):
        if rng.random() < 0.3:
            a, b = ours._collect(), theirs._collect()
            assert ([(r.client_id, r.frame_id) for r in a]
                    == [(r.client_id, r.frame_id) for r in b])
            continue
        fid += 1
        cid = int(rng.integers(1, 7))
        kf = bool(rng.random() < 0.3)
        assert ours.submit(_req(cid, fid, kf)) == theirs.submit(
            _req(cid, fid, kf, cls=jax_engine.InferenceRequest))
        assert ours.queue_depth() == theirs.queue_depth()
    assert (ours.engine.frames_dropped.value
            == theirs.engine.frames_dropped.value)
