"""Lane physics at full rate: the real ContinuousBatcher driven at an offered
load over a measured device-step ladder (a synthetic-step engine).

    python -m zero_latency_yolo_tpu_torch.lane_physics LADDER.json
        [LADDER.json ...] [--battery gate|single] [--streams 64] [--fps 60]
        [--window 1] [--duration 12] [--inflight 2]
        [--adaptive LADDER_320.json --slo 8]

No UDP and no decode: this isolates the scheduling and queueing that the
detect-latency p99 depends on (batch-window accumulation, bucket rounding,
in-flight pipelining, queueing near saturation). The device step is
replayed from a step ladder file that `step_ladder` wrote on the card
(`{"ladder": {bucket: ms}, "variant", "size", "device"}`), given on the
command line: there is no default ladder, and a ladder of another device
(the JAX package's `artifacts/*step_ladder*.json` are a TPU's) is that
device's physics, not the card's. Each row carries its ladder's `device`.
The engine never touches a device (the synthetic step sleeps).

Batch buckets above the ladder's top key are dropped (the JAX rule): the
synthetic engine would replay the top entry for a larger batch, and a
backlog batch of 64 against a ladder that stops at 16 would drain faster
than the device can.

The "gate" battery per ladder: 64 streams at windows 1 and 8 ms, 32
streams (one data row of a dp=2 mesh) and 40 and 48 streams; "single" is
one row of --streams. One JSON line per row (the JAX package's
`scripts/lane_physics.py` keys, plus `device`, `submitted`, `results` and
`unaccounted`: requests submitted less the results and the engine's drops,
0 when every request is accounted for). A row that fails is printed FAILED
and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BUCKETS = (2, 4, 8, 16, 32, 64)


def load_ladder(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc.get("ladder"), dict) or not doc["ladder"]:
        raise ValueError(f"{path}: no step ladder ({{'ladder': {{bucket: "
                         "ms}}}}: write one with step_ladder)")
    return doc


def ladder_buckets(ladder: dict, buckets=BUCKETS) -> tuple:
    """The batch buckets at or below the ladder's top key (or the top key
    alone)."""
    top = max(int(k) for k in ladder)
    return tuple(b for b in buckets if b <= top) or (top,)


def run_row(ladder, label, window_ms, rate, streams, duration,
            buckets=BUCKETS, inflight=2, adaptive=None, slo_ms=8.0,
            device=None) -> dict:
    """One measured row: the real batcher at `rate` submits/s for
    `duration` s against a synthetic engine replaying `ladder` (bucket ->
    ms); latency stats over the steady tail (the first 20% discarded).
    adaptive: a second ladder (the 320 rung): the engine then runs the
    real adaptive-resolution policy over per-size ladders (416 and 320)
    with the given SLO."""
    from .config import ServerConfig
    from .runtime.engine import InferenceRequest, create_engine
    from .runtime.scheduler import ContinuousBatcher
    from .utils.gcstats import tune_for_latency, untune
    from .utils.stats import cpu_times, steal_pct

    buckets = ladder_buckets(ladder, buckets)
    tpu = {"variant": "yolov8n", "num_classes": 4,
           "batch_buckets": list(buckets), "frame_buckets": [[64, 64]],
           "batch_window_ms": window_ms, "max_inflight": inflight,
           "synthetic_step_profile": ladder}
    if adaptive is not None:
        tpu.update({"synthetic_step_profiles": {"416": ladder,
                                                "320": adaptive},
                    "serve_sizes": [416, 320], "adaptive_slo_ms": slo_ms})
    cfg = ServerConfig.from_dict({
        "model_path": "/nonexistent.npz",
        "detection": {"model_width": 416, "model_height": 416},
        "tpu": tpu,
    })
    # The synthetic step never touches a device: the CPU is the engine's
    # device whatever card measured the ladder.
    eng = create_engine(cfg, device="cpu")
    lat = []

    def on_result(results):
        now = time.perf_counter()
        for r in results:
            lat.append((now - r.recv_t) * 1e3)

    b = ContinuousBatcher(eng, on_result, max_batch=max(buckets),
                          batch_window_ms=window_ms, max_inflight=inflight)
    b.start()
    # The real server's posture after warmup (tpu.gc_tune): a collector
    # pause stops the batcher too, and this measures scheduling.
    tune_for_latency()
    steal0 = cpu_times()
    data = np.zeros((32, 32, 3), np.uint8)
    period = 1.0 / rate
    t_end = time.perf_counter() + duration
    fid = 0
    nxt = time.perf_counter()
    try:
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            if nxt > now:
                time.sleep(nxt - now)
            fid += 1
            b.submit(InferenceRequest(client_id=fid % streams + 1,
                                      frame_id=fid, timestamp=fid, width=32,
                                      height=32, data=data))
            nxt += period
            # Cap catch-up bursts at 250 ms so the offered rate stays
            # honest on a loaded host.
            if nxt < time.perf_counter() - 0.25:
                nxt = time.perf_counter()
        # Drain: every submitted request ends as a result or a drop.
        deadline = time.perf_counter() + 5.0
        while ((b.queue_depth() or b._inflight)
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        time.sleep(0.05)
    finally:
        b.stop()
        untune()
    dropped = eng.frames_dropped.value
    row = dict(ladder=label, device=device, window_ms=window_ms,
               offered_fps=rate, streams=streams, submitted=fid,
               results=len(lat), unaccounted=fid - len(lat) - dropped)
    a = np.asarray(lat[len(lat) // 5:])
    if a.size == 0:
        # A row that served nothing says so (a bad ladder, a dead batcher).
        row.update(served_fps=0.0, detect_avg_ms=None, detect_p50_ms=None,
                   detect_p99_ms=None, dropped=dropped,
                   error="no results served",
                   cpu_steal_pct=steal_pct(steal0, cpu_times()))
        return row
    row.update(served_fps=round(len(lat) / duration, 1),
               detect_avg_ms=round(float(a.mean()), 2),
               detect_p50_ms=round(float(np.percentile(a, 50)), 2),
               detect_p99_ms=round(float(np.percentile(a, 99)), 2),
               dropped=dropped,
               # Host CPU steal over the row (a shared host inflates the
               # tail).
               cpu_steal_pct=steal_pct(steal0, cpu_times()))
    if adaptive is not None:
        row.update(serve_size=eng._serve_size,
                   downshifts=eng.size_downshifts,
                   upshifts=eng.size_upshifts, slo_ms=slo_ms)
    return row


def main(argv=None) -> int:
    from .utils.bench_util import Sweep
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("ladders", nargs="+",
                    help="step ladder JSON files written by step_ladder")
    ap.add_argument("--battery", default="gate", choices=["gate", "single"])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--fps", type=float, default=60.0, help="per stream")
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--inflight", type=int, default=2)
    ap.add_argument("--adaptive", default=None, metavar="LADDER_320.json",
                    help="a second ladder (the 320 rung): run the real "
                         "adaptive-resolution policy over per-size ladders")
    ap.add_argument("--slo", type=float, default=8.0,
                    help="the adaptive policy's SLO, ms (with --adaptive)")
    args = ap.parse_args(argv)

    adaptive = load_ladder(args.adaptive)["ladder"] if args.adaptive else None
    sweep = Sweep()
    for path in args.ladders:
        doc = sweep.row(path, lambda p=path: load_ladder(p))
        if doc is None:
            continue
        label = doc.get("variant", path)
        if adaptive is not None:
            label += "+adaptive320"
        if args.battery == "single":
            rows = [(args.window, args.streams * args.fps, args.streams)]
        else:
            rows = [(1.0, 64 * args.fps, 64), (8.0, 64 * args.fps, 64),
                    (1.0, 32 * args.fps, 32), (1.0, 40 * args.fps, 40),
                    (1.0, 48 * args.fps, 48)]
        for window, rate, streams in rows:
            row = sweep.row(
                f"{label} {streams}x{rate / streams:g} window {window}",
                lambda w=window, r=rate, s=streams: run_row(
                    doc["ladder"], label, w, r, s, args.duration,
                    inflight=args.inflight, adaptive=adaptive,
                    slo_ms=args.slo, device=doc.get("device")))
            if row is not None:
                print(json.dumps(row), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
