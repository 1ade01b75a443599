"""The wire-to-wire serving ceiling of one host: the offered load stepped
up until the wire path saturates.

    python -m zero_latency_yolo_tpu_torch.wire_ceiling --ladder LADDER.json
        [--start 8] [--step 8] [--max-streams 64] [--fps 60]
        [--duration 15] [--fleet N] [--slo-ms 8] [--device cuda]

Each rung is one run of the port's `loadtest` (`python -m
zero_latency_yolo_tpu_torch.loadtest --device DEVICE`: real SimClient
streams of 320x240 JPEG ROI updates in its own process, the native
transport, the decode workers, the batcher) whose server replays the
step ladder a `step_ladder` run wrote (`--ladder`, the synthetic step:
the device's time without the device; no default, a ladder is the
physics of the device that measured it). Per rung: the server's detect
p99 (datagram arrival to result sent), its host overhead p99, served and
offered frames/s, the frames sent, served and counted as dropped (the
engine's, and the server socket's own overflow count or, where the host
has none, the machine's `Udp: RcvbufErrors`), and whether the client
harness saturated first (offered below 95% of nominal: past that the
rung measures the harness). The sweep stops after the first saturated
rung.

The knee (`knee`) is the JAX rule: the most streams of a rung before the
first client-saturated one whose detect p99 is under the SLO and that
served at least 98% of what it offered. `--fleet N` runs the same rungs
against an N-shard SO_REUSEPORT fleet (`serve_fleet`, its shards on
`--device`); its server-side rows cover shard 0 only.

One JSON line, the JAX package's `scripts/wire_ceiling.py` keys (`ladder`
the file's path) plus `device` (the ladder's device, whose step is
replayed) and the rows' accounting. A rung that fails is kept as
{streams, error}, printed FAILED, and the tool exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def knee(rows: list, slo_ms: float) -> int:
    """The most streams of a rung before the first client-saturated rung
    (and of no errored rung) that held detect p99 under `slo_ms` and
    served at least 98% of its offered frames; 0 when none did."""
    clean = []
    for r in rows:
        if r.get("client_saturated"):
            break
        if "error" not in r:
            clean.append(r)
    under = [r for r in clean
             if (r.get("detect_p99_ms") or 1e9) < slo_ms
             and (r.get("served_fps") or 0) >= 0.98 * (r.get("offered_fps")
                                                       or 1e9)]
    return max((r["streams"] for r in under), default=0)


def _free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rung(streams: int, fps: float, duration: float, ladder: dict,
             device: str, external: str = "", web_port: int = 0) -> dict:
    port = int(external.rsplit(":", 1)[1]) if external else _free_port()
    web = web_port or _free_port(socket.SOCK_STREAM)
    cmd = [sys.executable, "-m", "zero_latency_yolo_tpu_torch.loadtest",
           "--streams", str(streams), "--fps", str(fps),
           "--duration", str(duration), "--device", device,
           "--max-inflight", "2", "--window-ms", "1.0",
           "--width", "320", "--height", "240",
           "--bucket-h", "240", "--bucket-w", "320",
           "--port", str(port), "--web-port", str(web),
           "--synthetic-profile", json.dumps(ladder)]
    if external:
        # Against a fleet, /statusz is one shard's: the server-side fields
        # are that shard's, the client-side ones cover every stream.
        cmd += ["--external", external]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=1200, cwd=REPO)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        rep = json.loads(line)
    except ValueError:
        raise RuntimeError(
            f"loadtest {streams}x{fps} (rc {proc.returncode}) emitted no "
            f"report; stderr tail: {proc.stderr.strip().splitlines()[-3:]}")
    nominal = streams * fps
    wall = rep.get("duration_s") or duration
    sock = rep.get("server_socket") or {}
    out = {
        "streams": streams,
        "offered_fps": rep.get("offered_fps"),
        "served_fps": rep.get("served_fps"),
        "detect_p99_ms": rep.get("server_detect_p99_ms"),
        "detect_avg_ms": rep.get("server_detect_avg_ms"),
        "host_overhead_p99_ms": rep.get("host_overhead_p99_ms"),
        "frames_dropped": rep.get("frames_dropped"),
        # Client-side truth across every stream (the axis of the single
        # server against the fleet).
        "client_e2e_p99_ms": rep.get("client_e2e_p99_ms"),
        "client_served_fps": round((rep.get("client_samples") or 0) / wall,
                                   1),
        "frames_sent": rep.get("frames_sent"),
        "results_received": rep.get("results_received"),
        # The server socket's counted drops: its own count, or the
        # kernel's, or the machine's (the largest that the host gives).
        "socket_drops": max([v for v in sock.values()
                             if isinstance(v, int)] or [0]),
        "server_socket": sock,
    }
    # Frames neither served nor counted as dropped; against a fleet the
    # server-side counts are one shard's, so there is no such sum.
    out["short"] = None if external else (
        out["frames_sent"] - out["results_received"] - out["frames_dropped"])
    if external:
        out["server_rows_scope"] = "one shard"
    if (rep.get("offered_fps") or 0.0) < 0.95 * nominal:
        out["client_saturated"] = True
    return out


def _fleet_config(path: str, port: int, web_port: int, max_streams: int,
                  fps: float, ladder: dict) -> None:
    with open(path, "w") as f:
        json.dump({
            "model_path": os.path.join(os.path.dirname(path),
                                       "no-model-synthetic.npz"),
            "port": port, "web_port": web_port,
            "max_clients": max_streams, "target_fps": fps,
            "max_queue_size": 8, "worker_threads": 1,
            "network": {"timeout_ms": 600000, "use_native_transport": True,
                        "reuse_port": True},
            "detection": {"model_width": 416, "model_height": 416},
            "tpu": {"variant": "yolov8n", "num_classes": 4,
                    "batch_buckets": [max(1, max_streams // 2), max_streams],
                    "frame_buckets": [[240, 320]], "batch_window_ms": 1.0,
                    "synthetic_step_profile": ladder},
        }, f)


def _print_rung(arm: str, row: dict, fps: float) -> None:
    print(f"# {arm} {row['streams']}x{fps:.0f}: p99 {row['detect_p99_ms']} "
          f"ms, served {row['served_fps']}/{row['offered_fps']} fps, sent "
          f"{row['frames_sent']} = results {row['results_received']} + "
          f"dropped {row['frames_dropped']} + short {row['short']} (socket "
          f"drops {row['socket_drops']})"
          f"{' CLIENT-SATURATED' if row.get('client_saturated') else ''}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from .utils.bench_util import Sweep
    from .utils.device import require_device
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--ladder", required=True,
                    help="a step ladder JSON file written by step_ladder")
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--start", type=int, default=8)
    ap.add_argument("--step", type=int, default=8)
    ap.add_argument("--max-streams", type=int, default=64)
    ap.add_argument("--fleet", type=int, default=0,
                    help="also run the rungs against an N-shard "
                         "SO_REUSEPORT fleet (same offered loads)")
    ap.add_argument("--slo-ms", type=float, default=8.0)
    ap.add_argument("--device", default="cuda",
                    help="the servers' torch device (the synthetic step "
                         "touches none)")
    args = ap.parse_args(argv)
    require_device(args.device, "wire_ceiling")
    with open(args.ladder) as f:
        doc = json.load(f)
    ladder = dict(doc["ladder"])
    sweep = Sweep()
    rows = []
    streams = args.start
    while streams <= args.max_streams:
        row = sweep.row(f"single {streams}x{args.fps:.0f}", lambda s=streams:
                        run_rung(s, args.fps, args.duration, ladder,
                                 args.device))
        if row is None:
            rows.append({"streams": streams,
                         "error": sweep.failed[f"single {streams}x"
                                               f"{args.fps:.0f}"]})
            streams += args.step
            continue
        rows.append(row)
        _print_rung("single", row, args.fps)
        if row.get("client_saturated"):
            break  # past here the harness, not the server, is measured
        streams += args.step

    fleet_rows = []
    if args.fleet > 1:
        tmp = tempfile.mkdtemp(prefix="zlt-wire-fleet-")
        cfg_path = os.path.join(tmp, "server.json")
        port = _free_port()
        web = _free_port(socket.SOCK_STREAM)
        max_streams = rows[-1]["streams"] if rows else args.max_streams
        _fleet_config(cfg_path, port, web, max_streams, args.fps, ladder)
        mgr = subprocess.Popen(
            [sys.executable, "-m", "zero_latency_yolo_tpu_torch.serve_fleet",
             "--config", cfg_path, "--shards", str(args.fleet),
             "--device", args.device, "--status-interval", "0"],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            for row in rows:
                if row.get("client_saturated") or "error" in row:
                    break
                label = f"fleet{args.fleet} {row['streams']}x{args.fps:.0f}"
                fr = sweep.row(label, lambda s=row["streams"]: run_rung(
                    s, args.fps, args.duration, ladder, args.device,
                    external=f"127.0.0.1:{port}", web_port=web))
                if fr is None:
                    fleet_rows.append({"streams": row["streams"],
                                       "error": sweep.failed[label]})
                    continue
                fleet_rows.append(fr)
                _print_rung(f"fleet{args.fleet}", fr, args.fps)
                if fr.get("client_saturated"):
                    break
        finally:
            mgr.terminate()
            try:
                mgr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                mgr.kill()
                mgr.wait(timeout=10)

    print(json.dumps({
        "method": "real UDP SimClient streams + native transport + decode "
                  "workers + batcher over a step ladder of the device "
                  "(synthetic step); the clients in one process beside the "
                  "server's",
        "ladder": args.ladder,
        "device": doc.get("device"),
        "fps_per_stream": args.fps,
        "rows": rows,
        "fleet_rows": fleet_rows or None,
        "knee_streams_under_slo": knee(rows, args.slo_ms),
        "slo_ms": args.slo_ms,
    }), flush=True)
    return sweep.exit_code()


if __name__ == "__main__":
    sys.exit(main())
