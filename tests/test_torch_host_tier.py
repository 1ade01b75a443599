"""The port's host tier against the JAX package's: tracker, game adapters,
rate controller, frame decode, IoU geometry, event bus and GC tracker, on
the same seeded sequences. Track ids equal; boxes equal to f32."""

import numpy as np
import pytest

jax_rt = pytest.importorskip("zero_latency_yolo_tpu.runtime.tracker")

from zero_latency_yolo_tpu import config as jax_config  # noqa: E402
from zero_latency_yolo_tpu import protocol as jax_protocol  # noqa: E402
from zero_latency_yolo_tpu.runtime import adapters as jax_adapters  # noqa: E402
from zero_latency_yolo_tpu.runtime import frames as jax_frames  # noqa: E402
from zero_latency_yolo_tpu.runtime import ratecontrol as jax_rc  # noqa: E402
from zero_latency_yolo_tpu.utils import geometry as jax_geometry  # noqa: E402

from zero_latency_yolo_tpu_torch import config as t_config  # noqa: E402
from zero_latency_yolo_tpu_torch import protocol as t_protocol  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import adapters as t_adapters  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import frames as t_frames  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import ratecontrol as t_rc  # noqa: E402
from zero_latency_yolo_tpu_torch.runtime import tracker as t_tracker  # noqa: E402
from zero_latency_yolo_tpu_torch.utils import geometry as t_geometry  # noqa: E402


def scene(seed: int, frames: int = 60, objects: int = 6):
    """Seeded detector output over `frames` frames at 60 fps: objects moving
    at constant velocity with jittered boxes, missed detections, a class
    flip now and then, and spurious boxes. Yields (boxes (M, 4) f32
    cxcywh, classes (M,), confidences (M,) f32, now_ms)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.2, 0.8, (objects, 2))
    vel = rng.uniform(-0.006, 0.006, (objects, 2))
    size = rng.uniform(0.04, 0.15, (objects, 2))
    cls = rng.integers(0, 4, objects)
    for f in range(frames):
        pos = pos + vel
        seen = rng.random(objects) > 0.15
        boxes = np.concatenate([pos, size], 1)[seen]
        boxes = boxes + rng.normal(0, 0.003, boxes.shape)
        c = cls[seen].copy()
        flip = rng.random(len(c)) < 0.03
        c[flip] = rng.integers(0, 4, int(flip.sum()))
        n_fake = int(rng.integers(0, 2))
        boxes = np.concatenate([boxes, rng.uniform(0.05, 0.9, (n_fake, 4))])
        c = np.concatenate([c, rng.integers(0, 4, n_fake)])
        conf = rng.uniform(0.3, 1.0, len(c)).astype(np.float32)
        yield (np.clip(boxes, 0.0, 1.0).astype(np.float32), c.astype(np.int64),
               conf, 1000.0 + f * 1000.0 / 60 + rng.uniform(-2, 2))


def _same_tracked(got, want):
    assert len(got) == len(want)
    for (gb, gc, gk, gt), (wb, wc, wk, wt) in zip(got, want):
        assert (gk, gt) == (wk, wt)
        np.testing.assert_array_equal(np.float32(gb), np.float32(wb))
        assert np.float32(gc) == np.float32(wc)


@pytest.mark.parametrize("assoc", ["motion", "iou"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tracker_matches_jax(seed, assoc):
    mine = t_tracker.MultiObjectTracker(max_age_ms=500, assoc=assoc)
    ref = jax_rt.MultiObjectTracker(max_age_ms=500, assoc=assoc)
    ids = set()
    for boxes, classes, conf, now in scene(seed):
        got = mine.update(boxes, classes, conf, now_ms=now)
        want = ref.update(boxes, classes, conf, now_ms=now)
        _same_tracked(got, want)
        ids |= {t for *_, t in got}
    assert len(ids) > 3


@pytest.mark.parametrize("seed", [0, 1])
def test_single_kalman_filter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mine = t_tracker.KalmanTracker(np.array([0.1, 0.5, 0.05, 0.1]))
    ref = jax_rt.KalmanTracker(np.array([0.1, 0.5, 0.05, 0.1]))
    for i in range(1, 120):
        dt = 1 / 60 + rng.uniform(-0.002, 0.002)
        np.testing.assert_array_equal(mine.predict(dt), ref.predict(dt))
        z = np.array([0.1 + 0.2 * i / 60, 0.5, 0.05, 0.1]) + rng.normal(
            0, 0.002, 4)
        mine.update(z)
        ref.update(z)
    np.testing.assert_array_equal(mine.x, ref.x)


def _dets(pkg, boxes, classes, conf, ts):
    return [pkg.Detection(x=float(b[0]), y=float(b[1]), width=float(b[2]),
                          height=float(b[3]), confidence=float(c),
                          class_id=int(k), track_id=0, timestamp=ts)
            for b, k, c in zip(boxes, classes, conf)]


@pytest.mark.parametrize("game", ["cs16", "csgo", "other"])
@pytest.mark.parametrize("tracking", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_adapter_matches_jax(seed, tracking, game):
    """get_adapter + process_detections on the same stream, two clients;
    then best_target and predict_motion."""
    mine = t_adapters.get_adapter(game, t_config.GameConfig(
        head_size_factor=0.7), enable_tracking=tracking)
    ref = jax_adapters.get_adapter(game, jax_config.GameConfig(
        head_size_factor=0.7), enable_tracking=tracking)
    assert type(mine).__name__ == type(ref).__name__
    for a in (mine, ref):
        a.register_client(1, 800, 600, 1)
        a.register_client(2, 1920, 1080, 1)
    for f, (boxes, classes, conf, now) in enumerate(scene(seed, frames=30)):
        cid = 1 + f % 2
        got = mine.process_detections(
            cid, _dets(t_protocol, boxes, classes, conf, f), now_ms=now)
        want = ref.process_detections(
            cid, _dets(jax_protocol, boxes, classes, conf, f), now_ms=now)
        assert [vars(d) for d in got] == [vars(d) for d in want]
    for cid in (1, 2):
        g, w = mine.best_target(cid), ref.best_target(cid)
        assert (g is None) == (w is None)
        if g is not None:
            assert vars(g) == vars(w)
            assert mine.predict_motion(cid, g.track_id) == ref.predict_motion(
                cid, w.track_id)
    assert mine.status() == ref.status()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rate_controller_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(slo_ms=8.0, min_fps=15, target_fps=60)
    mine, ref = t_rc.RateController(**kw), jax_rc.RateController(**kw)
    for _ in range(300):
        p99 = None if rng.random() < 0.05 else float(rng.gamma(2.0, 4.0))
        rx = None if rng.random() < 0.05 else float(rng.uniform(0, 80))
        drop = float(rng.choice([0.0, 0.0, rng.uniform(0, 0.3)]))
        assert mine.tick(p99, rx, drop_frac=drop) == ref.tick(
            p99, rx, drop_frac=drop)
        assert mine.hint == ref.hint


def _payloads(seed):
    """Raw RGB, JPEG, ROI and broken payloads of seeded frames."""
    pytest.importorskip("cv2")
    from zero_latency_yolo_tpu_torch.runtime.simulator import synthetic_frame
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(16, 200)), int(rng.integers(16, 120))
    frame = synthetic_frame(w, h, seed=seed)
    jpeg = t_frames.encode_jpeg(frame, int(rng.integers(50, 96)))
    region = synthetic_frame(w // 2, h // 2, seed=seed + 1)
    roi = t_protocol.build_roi_header(w // 4, h // 4, w // 2, h // 2, w) + \
        t_frames.encode_jpeg(region, 90)
    broken = bytearray(jpeg)
    broken[len(broken) // 2] ^= 0xFF
    return w, h, {"raw": frame.tobytes(), "jpeg": jpeg, "roi": roi,
                  "garbage": rng.integers(0, 256, 100, np.uint8).tobytes(),
                  "truncated_jpeg": jpeg[:len(jpeg) // 3],
                  "mutated_jpeg": bytes(broken),
                  "oversized_claim": frame.tobytes()[:-3]}


@pytest.mark.parametrize("kind", ["raw", "jpeg", "roi", "garbage",
                                  "truncated_jpeg", "mutated_jpeg",
                                  "oversized_claim"])
@pytest.mark.parametrize("seed", [0, 1])
def test_frame_decode_matches_jax(seed, kind):
    w, h, payloads = _payloads(seed)
    data = payloads[kind]

    def run(mod):
        try:
            out = mod.decode_frame_payload(data, w, h)
        except mod.FrameDecodeError as e:
            return ("error", type(e).__name__)
        return (out.pixels, None if out.roi is None else vars(out.roi))
    got, want = run(t_frames), run(jax_frames)
    if isinstance(want[0], str):
        assert got == want
    else:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert t_frames.encode_jpeg(np.zeros((8, 8, 3), np.uint8)) == \
        jax_frames.encode_jpeg(np.zeros((8, 8, 3), np.uint8))


def test_jpeg_refused_without_cv2(monkeypatch):
    """Without cv2 a JPEG payload raises FrameDecodeError (the server
    counts it in bad_packets), as in the JAX package; raw frames decode."""
    monkeypatch.setattr(t_frames, "cv2", None)
    jpeg = b"\xff\xd8\xff\xe0" + bytes(200)
    with pytest.raises(t_frames.FrameDecodeError):
        t_frames.decode_frame_payload(jpeg, 16, 16)
    raw = np.arange(16 * 16 * 3, dtype=np.uint8).tobytes()
    out = t_frames.decode_frame_payload(raw, 16, 16)
    assert out.pixels.shape == (16, 16, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_matrix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (int(rng.integers(0, 20)), 4)).astype(np.float32)
    b = rng.uniform(0, 1, (int(rng.integers(0, 20)), 4)).astype(np.float32)
    np.testing.assert_array_equal(t_geometry.iou_matrix_cxcywh(a, b),
                                  jax_geometry.iou_matrix_cxcywh(a, b))


def test_event_bus_delivers_and_isolates_faults():
    from zero_latency_yolo_tpu_torch.utils.events import EventBus
    bus = EventBus()
    got = []

    def bad(event, payload):
        raise RuntimeError("handler fault")
    bus.subscribe("x", bad)
    bus.subscribe("x", lambda e, p: got.append((e, p)))
    bus.publish("x", 1)
    bus.publish("y", 2)
    assert got == [("x", 1)]
    bus.clear()
    bus.publish("x", 3)
    assert got == [("x", 1)]


def test_gc_pause_tracker_records_collections():
    import gc

    from zero_latency_yolo_tpu_torch.utils.gcstats import GcPauseTracker
    t = GcPauseTracker().install()
    try:
        gc.collect()
        st = t.status()
        assert st["collections_g2"] >= 1 and st["pause_total_ms"] >= 0.0
    finally:
        t.uninstall()
