"""The port's DeviceFrameCache against the JAX package's, on the CPU.

The same seeded write sequences go through both caches (the port's with
device="cpu"); after every flush their arrays are byte-equal and their
counters, slot tables and frozen sets equal. The cases are those of
tests/test_frames_roi.py, then sequences drawn by hypothesis; then the
port's own: a flush uploads only through its pinned staging with
non_blocking copies, and the batcher runs the step outside the cache lock.
"""

import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import zero_latency_yolo_tpu.ops.roi as jax_roi
import zero_latency_yolo_tpu_torch.ops.roi as pt_roi

torch = pytest.importorskip("torch")

import torch_fixtures.cpu_threads  # noqa: E402,F401  (caps torch's CPU threads)

def synthetic(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


class Pair:
    """A JAX cache and a port cache of one geometry, driven together:
    every call goes to both, must return the same, and after every flush
    both caches must hold the same bytes, counters and slot state."""

    def __init__(self, num_slots, height, width, **attrs):
        self.jax = jax_roi.DeviceFrameCache(num_slots, height, width)
        self.pt = pt_roi.DeviceFrameCache(num_slots, height, width,
                                          device="cpu")
        for k, v in attrs.items():
            setattr(self.jax, k, v)
            setattr(self.pt, k, v)

    def call(self, name, *args):
        got = getattr(self.pt, name)(*args)
        want = getattr(self.jax, name)(*args)
        assert got == want, (name, got, want)
        return got

    def flush(self):
        """run_locked on both (a flush), then the full comparison."""
        self.pt.run_locked(lambda c: c)
        self.jax.run_locked(lambda c: c)
        self.check()

    def gather(self, ids):
        f_pt, h_pt, w_pt = self.pt.gather(ids)
        f_jax, h_jax, w_jax = self.jax.gather(ids)
        np.testing.assert_array_equal(h_pt, h_jax)
        np.testing.assert_array_equal(w_pt, w_jax)
        assert np.array_equal(f_pt.numpy(), np.asarray(f_jax))
        self.check()
        return f_pt.numpy(), h_pt, w_pt

    def check(self):
        a, b = self.pt, self.jax
        assert a._cache.dtype == torch.uint8
        assert np.array_equal(a._cache.numpy(), np.asarray(b._cache)), \
            "cache bytes differ"
        for k in ("flushes", "writes_flushed", "writes_shed", "_free",
                  "_slot_of", "_dims", "_needs_kf", "_newly_frozen",
                  "_pending_bytes", "_cache_dead"):
            assert getattr(a, k) == getattr(b, k), k
        assert sorted(a.frozen_clients()) == sorted(b.frozen_clients())


# ----------------------------------- the cases of tests/test_frames_roi.py

def test_keyframe_roundtrip():
    p = Pair(2, 64, 64)
    frame = synthetic(48, 32, 4)
    assert p.call("write_keyframe", 7, frame)
    frames, hs, ws = p.gather([7])
    assert (hs[0], ws[0]) == (32, 48)
    np.testing.assert_array_equal(frames[0, :32, :48], frame)
    assert frames[0, 32:].sum() == 0 and frames[0, :, 48:].sum() == 0


def test_roi_paste():
    p = Pair(2, 64, 64)
    assert p.call("write_keyframe", 1, np.zeros((64, 64, 3), np.uint8))
    region = np.full((16, 24, 3), 200, np.uint8)
    assert p.call("write_roi", 1, region, 8, 40)
    out = p.gather([1])[0][0]
    np.testing.assert_array_equal(out[40:56, 8:32], region)
    assert out.sum() == region.astype(np.int64).sum()


def test_roi_before_keyframe_refused():
    p = Pair(1, 64, 64)
    assert not p.call("write_roi", 5, np.zeros((8, 8, 3), np.uint8), 0, 0)
    assert not p.call("has_frame", 5)
    p.flush()


@pytest.mark.parametrize("x,y", [(54, 54), (0, 54), (54, 0), (0, 0)])
def test_roi_at_edges(x, y):
    p = Pair(1, 64, 64)
    p.call("write_keyframe", 1, synthetic(64, 64, 1))
    assert p.call("write_roi", 1, np.full((10, 10, 3), 99, np.uint8), x, y)
    for past in ((55, y), (x, 55)):  # one row or column past: refused
        assert not p.call("write_roi", 1, np.ones((10, 10, 3), np.uint8),
                          *past)
    out = p.gather([1])[0][0]
    assert (out[y:y + 10, x:x + 10] == 99).all()


def test_slot_exhaustion_and_release_then_reuse():
    p = Pair(1, 16, 16)
    assert p.call("write_keyframe", 1, synthetic(16, 16, 1))
    assert not p.call("write_keyframe", 2, synthetic(16, 16, 2))
    p.flush()
    p.call("release", 1)
    assert p.call("slot", 1) is None
    assert p.call("write_keyframe", 2, synthetic(12, 10, 3))
    frames = p.gather([2, 1])[0]  # 1 released: resolves to slot 0, 1x1
    np.testing.assert_array_equal(frames[0, :10, :12], synthetic(12, 10, 3))


@pytest.mark.parametrize("shape,dtype", [((32, 32, 3), np.uint8),
                                         ((32, 32), np.uint8),
                                         ((32, 32, 3), np.float32),
                                         ((0, 64, 3), np.uint8),
                                         ((64, 0, 3), np.uint8),
                                         ((17, 16, 3), np.uint8)])
def test_oversized_malformed_and_zero_area_writes(shape, dtype):
    p = Pair(1, 16, 16)
    arr = np.zeros(shape, dtype)
    assert not p.call("write_keyframe", 1, arr)
    assert not p.call("has_frame", 1)
    assert p.call("write_keyframe", 1, synthetic(16, 16, 1))
    assert not p.call("write_roi", 1, arr, 0, 0)
    p.flush()


def test_flush_order_overlapping_writes_and_keyframe_supersedes():
    p = Pair(2, 64, 64)
    assert p.call("write_keyframe", 1, np.zeros((64, 64, 3), np.uint8))
    r1 = np.full((8, 8, 3), 10, np.uint8)
    r2 = np.full((8, 8, 3), 20, np.uint8)
    assert p.call("write_roi", 1, r1, 4, 4)
    assert p.call("write_roi", 1, r2, 8, 8)   # overlaps r1; must win
    assert p.pt.flushes == 0                  # nothing applied yet
    img = p.gather([1])[0][0]
    assert p.pt.flushes == 2 and p.pt.writes_flushed == 3
    assert img[5, 5].tolist() == [10] * 3 and img[10, 10].tolist() == [20] * 3
    assert p.call("write_roi", 1, r1, 0, 0)
    assert p.call("write_keyframe", 1, np.full((64, 64, 3), 77, np.uint8))
    assert p.gather([1])[0][0, 0, 0].tolist() == [77] * 3


def test_many_overlapping_writes_in_one_group_land_in_order():
    """40 writes to overlapping rects of one slot, one bucket class, one
    flush: each lands over the ones before it."""
    p = Pair(2, 64, 64)
    assert p.call("write_keyframe", 3, synthetic(64, 64, 0))
    rng = np.random.default_rng(7)
    for i in range(40):
        y, x = (int(v) for v in rng.integers(0, 49, 2))
        assert p.call("write_roi", 3, synthetic(14, 15, 100 + i), x, y)
    p.flush()
    assert p.pt.flushes == 2 and p.pt.writes_flushed == 41


def _recording(monkeypatch, mod, name, out, key):
    real = getattr(mod, name)

    def rec(*args):
        out.append(key(*args))
        return real(*args)
    monkeypatch.setattr(mod, name, rec)


def test_groups_by_bucket_class(monkeypatch):
    """The same write batches, in the same order: one per bucket class and
    run of a slot, as the JAX cache flushes them."""
    p = Pair(4, 256, 256)
    jax_shapes, pt_shapes = [], []
    _recording(monkeypatch, jax_roi, "_paste_many", jax_shapes,
               lambda c, regions, meta: tuple(int(d) for d in regions.shape[1:3]))
    _recording(monkeypatch, pt_roi, "_paste_many", pt_shapes,
               lambda c, regions, meta: (
                   pt_roi._roi_bucket(max(m[3] for m in meta), 256),
                   pt_roi._roi_bucket(max(m[4] for m in meta), 256)))
    for cid in (1, 2):
        assert p.call("write_keyframe", cid, np.zeros((256, 256, 3), np.uint8))
    p.flush()
    big = np.full((200, 200, 3), 50, np.uint8)
    small = np.full((8, 8, 3), 10, np.uint8)
    assert p.call("write_roi", 1, big, 0, 0)
    for i in range(5):
        assert p.call("write_roi", 2, small, 16 * i, 0)
    p.flush()
    a = np.full((100, 100, 3), 60, np.uint8)
    for args in ((a, 0, 0), (np.full((8, 8, 3), 70, np.uint8), 0, 0),
                 (np.full((8, 8, 3), 80, np.uint8), 0, 0), (a, 0, 0),
                 (np.full((8, 8, 3), 90, np.uint8), 4, 4)):
        assert p.call("write_roi", 1, *args)
    p.flush()
    assert pt_shapes == jax_shapes
    assert sorted(pt_shapes[:2]) == [(16, 16), (256, 256)]
    # Slot 1's runs split at class transitions, flushed in phase order.
    assert pt_shapes[2:] == [(128, 128), (16, 16), (128, 128), (16, 16)]


def test_full_extent_count_ladder():
    p = Pair(4, 64, 96)
    assert p.call("write_keyframe", 1, np.zeros((64, 96, 3), np.uint8))
    p.flush()
    for n in (1, 3, 17):
        for i in range(n):
            assert p.call("write_roi", 1, synthetic(90, 60, i), 0, 0)
        p.flush()


def test_keyframe_flush_chunks():
    """17 keyframes on a 64-slot cache: two batches of at most 16."""
    p = Pair(64, 16, 16)
    for cid in range(1, 18):
        assert p.call("write_keyframe", cid, synthetic(16, 16 - cid % 5, cid))
    p.flush()
    assert p.pt.flushes == 2 and p.pt.writes_flushed == 17


@pytest.mark.parametrize("bound", ["count", "bytes"])
def test_shed_freezes_and_keyframe_reanchors(bound):
    attrs = ({"_max_pending": 8} if bound == "count"
             else {"_max_pending_bytes": 4096})
    p = Pair(4, 64, 64, **attrs)
    for cid in (1, 2):
        assert p.call("write_keyframe", cid, synthetic(64, 64, cid))
    p.gather([1, 2])
    region = np.full((32, 32, 3), 200, np.uint8)
    for _ in range(8):
        assert p.call("write_roi", 1, region, 0, 0)
    assert p.call("write_roi", 2, region[:8, :8], 8, 8)
    assert p.pt.writes_shed > 0
    assert p.call("write_roi", 1, region, 16, 16)  # frozen: accepted, shed
    p.check()
    p.gather([1, 2])
    assert p.call("drain_frozen") == [1]
    assert p.call("drain_frozen") == []
    assert p.call("write_keyframe", 1, synthetic(64, 64, 9))
    assert p.call("write_roi", 1, region[:8, :8], 0, 0)
    p.gather([1])
    assert p.call("frozen_clients") == []


def test_frozen_notification():
    p = Pair(4, 64, 64, _max_pending=0)
    for cid in (1, 2):
        assert p.call("write_keyframe", cid, synthetic(64, 64, cid))
    p.gather([1, 2])
    region = np.full((8, 8, 3), 9, np.uint8)
    assert p.call("write_roi", 1, region, 0, 0)
    assert p.call("frozen_clients") == [1]
    assert p.call("drain_frozen") == [1]
    assert p.call("drain_frozen") == []
    assert p.call("write_roi", 2, region, 0, 0)
    assert p.call("write_keyframe", 2, synthetic(64, 64, 5))
    assert 2 not in p.call("drain_frozen")
    assert p.call("frozen_clients") == [1]
    p.flush()


def test_failure_freezes_touched_slots(monkeypatch):
    """A flush that fails midway freezes the slots it touched and re-raises;
    the next touch zeroes the cache and freezes every active slot; fresh
    keyframes re-anchor."""
    p = Pair(4, 32, 32)
    assert p.call("write_keyframe", 1, synthetic(32, 32, 1))
    assert p.call("write_keyframe", 2, synthetic(32, 32, 2))
    p.flush()
    assert p.call("write_roi", 1, synthetic(8, 8, 3), 4, 4)

    def boom(*a, **k):
        raise RuntimeError("device failed")
    monkeypatch.setattr(jax_roi, "_paste_many", boom)
    monkeypatch.setattr(pt_roi, "_paste_many", boom)
    for c in (p.pt, p.jax):
        with pytest.raises(RuntimeError, match="device failed"):
            c.run_locked(lambda a: a)
    monkeypatch.undo()
    assert p.call("frozen_clients") == [1]
    assert p.call("drain_frozen") == [1]
    assert p.call("write_roi", 1, synthetic(8, 8, 4), 0, 0)
    p.flush()  # revives: zeroed, every active slot frozen
    assert sorted(p.call("frozen_clients")) == [1, 2]
    assert p.call("drain_frozen") == [2]
    assert p.call("write_keyframe", 1, synthetic(32, 32, 5))
    assert p.call("write_keyframe", 2, synthetic(32, 32, 6))
    p.flush()
    assert p.call("frozen_clients") == []


def test_apply_diff_pastes_like_roi():
    p = Pair(2, 32, 32)
    assert p.call("write_keyframe", 1, np.zeros((32, 32, 3), np.uint8))
    assert p.call("apply_diff", 1, np.full((8, 8, 3), 9, np.uint8), 4, 4)
    img = p.gather([1])[0][0]
    assert img[4, 4].tolist() == [9] * 3 and img[0, 0].tolist() == [0] * 3


def test_dispatch_with_survives_mid_batch_eviction():
    p = Pair(2, 32, 32)
    assert p.call("write_keyframe", 1, synthetic(32, 32, 1))
    assert p.call("write_keyframe", 2, synthetic(32, 32, 2))
    p.call("release", 2)
    p.gather([1, 2])

    def slots(c, s, hs, ws):
        return tuple(map(tuple, (s, hs, ws))) + (tuple(c.shape),)
    assert p.pt.dispatch_with(slots, [1, 2]) == p.jax.dispatch_with(slots, [1, 2])


def test_warm_keeps_the_slots_in_use():
    p = Pair(3, 32, 32)
    assert p.call("write_keyframe", 1, synthetic(32, 32, 1))
    assert p.call("write_keyframe", 2, synthetic(32, 32, 2))
    p.flush()
    p.call("release", 2)  # its slot, now free, holds the old frame
    p.pt.warm()
    p.jax.warm()
    p.check()


# ------------------------------------------------- hypothesis sequences

H, W, SLOTS = 40, 56, 3

_frame = st.tuples(st.one_of(st.just(W), st.integers(1, W)),
                   st.one_of(st.just(H), st.integers(1, H)),
                   st.integers(0, 999))
# ROI edges mostly in the 16 px class, so that one flush's group often
# holds overlapping writes to one slot.
_region = st.tuples(st.one_of(st.integers(1, 16), st.integers(1, W)),
                    st.one_of(st.integers(1, 16), st.integers(1, H)),
                    st.integers(0, 999))
_roi = st.tuples(st.just("roi"), st.integers(1, 4), _region,
                 st.integers(0, W // 4), st.integers(0, H // 4))
_ops = st.one_of(
    st.tuples(st.just("kf"), st.integers(1, 4), _frame),
    _roi, _roi, _roi,
    st.tuples(st.just("release"), st.integers(1, 4)),
    st.tuples(st.just("flush")),
    st.tuples(st.just("drain")),
)


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(_ops, min_size=8, max_size=40),
       max_pending=st.sampled_from([1000, 3, 0]))
def test_random_sequences_match_jax(ops, max_pending):
    p = Pair(SLOTS, H, W, _max_pending=max_pending)
    for cid in range(1, SLOTS + 1):  # whole-slot keyframes to paste over
        p.call("write_keyframe", cid, synthetic(W, H, cid))
    for op in ops:
        if op[0] == "kf":
            w, h, seed = op[2]
            p.call("write_keyframe", op[1], synthetic(w, h, seed))
        elif op[0] == "roi":
            w, h, seed = op[2]
            p.call("write_roi", op[1], synthetic(w, h, seed), op[3], op[4])
        elif op[0] == "release":
            p.call("release", op[1])
        elif op[0] == "drain":
            p.call("drain_frozen")
        else:
            p.gather([1, 2, 3, 4])
    p.flush()


# ------------------------------------------------------------ the port's

def test_flush_uploads_only_staged_bytes_non_blocking(monkeypatch):
    """Every host-to-device move of a flush is a non_blocking copy of the
    upload staging (from pinned memory on a card): one for the keyframes of
    each shape (their int64 slots and their own (h, w) bytes, not whole
    slots), one for each ROI write batch."""
    cache = pt_roi.DeviceFrameCache(4, 64, 96, device="cpu")
    calls = []
    to = torch.Tensor.to

    def rec(self, *args, **kwargs):
        calls.append((self.numel(), kwargs.get("non_blocking")))
        return to(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "to", rec)
    assert cache.write_keyframe(1, synthetic(40, 30, 1))
    assert cache.write_keyframe(2, synthetic(96, 64, 2))
    assert cache.write_keyframe(3, synthetic(40, 30, 3))
    assert cache.write_roi(1, synthetic(8, 8, 3), 0, 0)
    assert cache.write_roi(1, synthetic(20, 20, 4), 5, 5)
    cache.run_locked(lambda c: c)
    monkeypatch.undo()
    assert sorted(calls[:2]) == sorted([(8 + 64 * 96 * 3, True),
                                        (2 * 8 + 2 * 30 * 40 * 3, True)])
    assert calls[2:] == [(8 * 8 * 3, True), (20 * 20 * 3, True)]


def test_upload_buffers_wait_for_their_event():
    """A staging buffer whose last copy has not passed its event is not
    reused: the next upload takes another buffer."""
    up = pt_roi._Uploads(torch.device("cpu"))

    class Pending:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done
    up.upload([np.ones(10, np.uint8)])
    first = up._bufs[0]
    first[1] = Pending(False)
    up.upload([np.ones(10, np.uint8)])
    assert len(up._bufs) == 2 and up._bufs[1] is not first
    first[1] = Pending(True)
    up._bufs[1][1] = Pending(False)
    dev = up.upload([np.arange(12, dtype=np.uint8).reshape(4, 3)])
    assert dev.tolist() == list(range(12)) and len(up._bufs) == 2
    assert dev.data_ptr() == first[0].data_ptr()  # the idle one, reused


def test_step_runs_outside_the_cache_lock(monkeypatch):
    """The batcher holds the cache lock for the flush and the gather, and
    runs the step after releasing it: from another thread the lock can be
    taken while the step runs, so decode workers' writes never wait for
    the step. A write queued while the step runs is served next time."""
    from zero_latency_yolo_tpu_torch.config import ServerConfig
    from zero_latency_yolo_tpu_torch.models.yolov8 import get_spec, init_params
    from zero_latency_yolo_tpu_torch.runtime.engine import (
        InferenceEngine, InferenceRequest)
    from zero_latency_yolo_tpu_torch.runtime.scheduler import ContinuousBatcher
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 64, "model_height": 64},
        "tpu": {"variant": "yolov8p", "num_classes": 4, "dtype": "float32",
                "pre_nms_topk": 64, "frame_buckets": [[64, 96]],
                "batch_buckets": [1, 2]}})
    eng = InferenceEngine(cfg, params=init_params(0, get_spec("yolov8p", 4)),
                          device="cpu")
    cache = pt_roi.DeviceFrameCache(2, 64, 96, device="cpu")
    for cid in (1, 2):
        assert cache.write_keyframe(cid, synthetic(96, 64, cid))
    batcher = ContinuousBatcher(eng, lambda r: None, max_batch=2,
                                device_cache=cache)
    seen = {}
    gather, step = eng.gather_from_cache, eng._step

    def gather_spy(*args):
        seen["gather_locked"] = cache._lock.locked()
        return gather(*args)

    def step_spy(*args):
        seen["step_locked"] = cache._lock.locked()
        took = []

        def writer():
            if cache._lock.acquire(timeout=10):
                took.append(True)
                cache._lock.release()
            took.append(cache.write_roi(1, synthetic(8, 8, 7), 0, 0))
        t = threading.Thread(target=writer)
        t.start()
        t.join(timeout=20)
        seen["writer"] = (not t.is_alive(), took)
        return step(*args)

    monkeypatch.setattr(eng, "gather_from_cache", gather_spy)
    monkeypatch.setattr(eng, "_step", step_spy)
    reqs = [InferenceRequest(client_id=c, frame_id=c, timestamp=c, width=96,
                             height=64, data=None) for c in (1, 2)]
    pending = batcher._dispatch(reqs)
    assert len(pending) == 1
    assert [r.client_id for r in eng.complete(pending[0])] == [1, 2]
    assert seen == {"gather_locked": True, "step_locked": False,
                    "writer": (True, [True, True])}
    assert len(cache._pending) == 1  # the write waits for the next flush
