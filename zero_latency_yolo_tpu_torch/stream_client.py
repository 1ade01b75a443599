"""Live ZLTY streaming client of the PyTorch port: stream a video file or an
image directory to a running detection server as the reference's capture
client does (keyframe cadence + diff-detected ROI updates, `StreamDriver`)
and collect the detection results.

    python -m zero_latency_yolo_tpu_torch.stream_client \
        --server 10.0.0.5:7788 clip.mp4 --fps 30 [--loop] [--print-dets] \
        [--duration 60] [--device cpu]

The port's copy of the JAX package's `scripts/stream_client.py`, with the
same arguments, output lines and exit codes, over the port's
`runtime/media.py` and `runtime/simulator.py`. It honors server stream
control end to end: REQUEST_KEYFRAME re-anchors, CONFIG_UPDATE rate hints
throttle the send pacing (AIMD rate control), COMMAND(DISCONNECT)
re-handshakes (fleet drain/roll).

`--device` (default `cuda`) is the rule every tool of the port keeps: it
exits with an error when torch sees no CUDA device, unless given `--device
cpu`. The client itself computes nothing on a device (the server does).

Prints one JSON stats line at exit: frames pushed/skipped, keyframes, ROI
updates, results, e2e latency p50/p99, server commands seen.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .runtime.media import iter_frames
from .runtime.simulator import SimClient, StreamDriver
from .utils.device import require_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="stream media to a detection server over ZLTY/UDP")
    ap.add_argument("inputs", nargs="+",
                    help="video files / image directories / image files")
    ap.add_argument("--server", default="127.0.0.1:7788", metavar="HOST:PORT")
    ap.add_argument("--fps", type=float, default=30.0,
                    help="capture pacing (server rate hints can lower it)")
    ap.add_argument("--loop", action="store_true",
                    help="restart the source when it ends")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="stop after this many seconds (0 = source length)")
    ap.add_argument("--resize", default="",
                    help="WxH: resize frames (a session needs ONE geometry; "
                         "default = first frame's)")
    ap.add_argument("--quality", type=int, default=75, help="JPEG quality")
    ap.add_argument("--keyframe-interval", type=int, default=30)
    ap.add_argument("--print-dets", action="store_true",
                    help="print one JSON line per DETECTION_RESULT")
    ap.add_argument("--game-id", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the port's device rule (default cuda; cpu runs "
                         "without a CUDA device)")
    args = ap.parse_args(argv)
    if args.fps <= 0:
        raise SystemExit("--fps must be > 0")
    host, _, port = args.server.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--server {args.server!r} is not HOST:PORT")
    resize = None
    if args.resize:
        try:
            w, h = (int(v) for v in args.resize.lower().split("x"))
            resize = (w, h)
        except ValueError:
            raise SystemExit(f"--resize {args.resize!r} is not WxH")
    require_device(args.device, "stream_client")

    def frames():
        while True:
            n = 0
            for _src, rgb in iter_frames(args.inputs, resize=resize):
                n += 1
                yield rgb
            if not n:
                raise SystemExit("no decodable frames in inputs")
            if not args.loop:
                return

    src = frames()
    try:
        first = next(src)
    except ValueError as e:
        raise SystemExit(str(e))
    fh, fw = first.shape[:2]
    client = SimClient((host, int(port)), screen_width=fw, screen_height=fh,
                       game_id=args.game_id)
    # Long-running peer: bound the latency-sample window (percentiles cover
    # the most recent ~100k results); the results list itself is drained in
    # the loop below so hours of streaming stay at constant memory.
    client.max_latency_samples = 100_000
    info = client.connect()
    client.start_receiver()
    print(f"# connected to {args.server} (server id {info.info.server_id}, "
          f"max {info.info.max_clients} clients, max_fps "
          f"{info.info.max_fps}); streaming {fw}x{fh} at <= {args.fps:g} fps",
          file=sys.stderr)
    driver = StreamDriver(client, quality=args.quality,
                          keyframe_interval=args.keyframe_interval)
    pushed = 0
    t0 = time.perf_counter()
    t_end = t0 + args.duration if args.duration > 0 else float("inf")
    nxt = t0
    rc = 0
    try:
        frame = first
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if nxt > now:
                time.sleep(min(nxt - now, 0.25))
                continue
            if frame.shape[:2] != (fh, fw):
                raise SystemExit(
                    f"frame geometry changed {fw}x{fh} -> "
                    f"{frame.shape[1]}x{frame.shape[0]}; use --resize")
            if driver.push(frame) is not None:
                pushed += 1
            # AIMD rate hints (CONFIG_UPDATE): cap pacing at the server's
            # current target — the cooperative-client contract.
            hint = client.server_settings.get("target_fps")
            rate = min(args.fps, float(hint)) if hint else args.fps
            nxt += 1.0 / max(rate, 0.1)
            if nxt < time.perf_counter() - 0.5:
                nxt = time.perf_counter()  # don't burst after a stall
            # Drain results every tick (bounded memory over --loop runs);
            # results_total keeps the lifetime count for the exit stats.
            new = client.drain_results()
            if args.print_dets:
                for r in new:
                    print(json.dumps({
                        "frame_id": r.frame_id,
                        "detections": [{
                            "class": d.class_id, "track": d.track_id,
                            "confidence": round(d.confidence, 4),
                            "cx": round(d.x, 6), "cy": round(d.y, 6),
                            "w": round(d.width, 6), "h": round(d.height, 6),
                        } for d in r.detections]}), flush=True)
            try:
                frame = next(src)
            except StopIteration:
                break
            except ValueError as e:  # unopenable directly-named source
                raise SystemExit(str(e))
    except KeyboardInterrupt:
        rc = 130
    finally:
        elapsed = time.perf_counter() - t0
        time.sleep(0.2)  # let trailing results land
        with client._lock:
            lat = np.asarray(client.result_latencies_ms, np.float64)
            n_results = client.results_total
        have_lat = lat.size > 0
        stats = {
            "elapsed_s": round(elapsed, 2),
            "frames_pushed": pushed,
            "frames_skipped": driver.skipped,
            "keyframes": driver.keyframes_sent,
            "roi_updates": driver.roi_sent,
            "results": n_results,
            # null, not 0.0, when nothing came back: a dead server must not
            # read as perfect latency.
            "e2e_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if have_lat else None,
            "e2e_p99_ms": round(float(np.percentile(lat, 99)), 2)
            if have_lat else None,
            "keyframe_requests_seen": client.keyframe_requests_seen,
            "config_updates_seen": client.config_updates_seen,
            "rehandshakes": driver.rehandshakes,
            "served_fps": round(n_results / elapsed, 1)
            if elapsed > 0 else 0.0,
        }
        client.stop()
        print(json.dumps(stats), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
