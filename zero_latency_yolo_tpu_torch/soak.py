"""Fault-injected soak of the PyTorch port against a RUNNING server: N
client streams with loss/dup/corrupt churn for T seconds, then a JSON
verdict.

    python -m zero_latency_yolo_tpu_torch.soak --host 127.0.0.1 --port 7788 \
        --web-port 3000 --streams 16 --duration 300 --fps 20 [--device cpu]

Against a reuse_port fleet (`serve_fleet.py`), pass every shard's web port
and the verdict aggregates: `--web-port 3000,3001`.

The port's copy of the JAX package's `scripts/soak.py`, with the same
arguments, verdict line and exit code (0 when clean), over the port's
`runtime/simulator.py`. It exercises the full wire surface the way a flaky
WAN would: keyframes + ROI deltas under 5% loss/dup/corrupt, periodic client
churn (disconnect + reconnect), heartbeats. The verdict pulls /statusz to
assert the server came out clean: sessions freed, cache slots reclaimed, bad
packets counted not crashed, frames served. Every /statusz field it reads
has the same name in the port's server as in the JAX server.

`--device` (default `cuda`) is the rule every tool of the port keeps: it
exits with an error when torch sees no CUDA device, unless given `--device
cpu`. The soak itself computes nothing on a device (the server does).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
import urllib.request

from .runtime.simulator import FaultInjector, SimClient, synthetic_frame
from .utils.device import require_device


def _statusz(urls) -> dict:
    """Aggregate /statusz across one or more endpoints (a reuse_port fleet:
    every shard carries a disjoint slice of the clients, so the soak verdict
    sums counters over all of them)."""
    agg = {"clients": 0, "results_sent": 0,
           "transport": {"bad_packets": 0},
           "frame_cache": {"slots_used": 0},
           "device_stall_s": 0.0}
    for url in urls:
        with urllib.request.urlopen(url, timeout=10) as r:
            st = json.loads(r.read())
        agg["clients"] += int(st.get("clients", 0))
        agg["results_sent"] += int(st.get("results_sent", 0))
        agg["transport"]["bad_packets"] += int(
            (st.get("transport") or {}).get("bad_packets", 0))
        fc = st.get("frame_cache") or {}
        agg["frame_cache"]["slots_used"] += int(fc.get("slots_used", 0) or 0)
        agg["device_stall_s"] = max(agg["device_stall_s"],
                                    float(st.get("device_stall_s", 0) or 0))
    return agg


def stream_worker(idx, args, stop_t, stats, lock):
    rng = random.Random(1000 + idx)
    cycle = 0
    while time.monotonic() < stop_t:
        cycle += 1
        faults = FaultInjector(drop=args.fault, duplicate=args.fault,
                               corrupt=args.fault,
                               rng=random.Random(idx * 7919 + cycle))
        c = SimClient((args.host, args.port), screen_width=args.width,
                      screen_height=args.height, faults=faults)
        try:
            c.connect()
        except Exception:  # noqa: BLE001 — handshake lost to faults
            with lock:
                stats["handshake_misses"] += 1
            time.sleep(0.5)
            continue
        c.start_receiver()
        c.start_heartbeat()
        try:
            c.send_jpeg_keyframe(synthetic_frame(args.width, args.height,
                                                 seed=cycle))
            period = 1.0 / args.fps
            # Stream ROIs for a churn window, then disconnect and reconnect.
            churn_at = time.monotonic() + rng.uniform(10, 30)
            while time.monotonic() < min(stop_t, churn_at):
                c.send_roi_update(
                    synthetic_frame(32, 32, seed=rng.randrange(99)),
                    rng.randrange(max(args.width - 40, 1)),
                    rng.randrange(max(args.height - 40, 1)))
                with lock:
                    stats["frames_sent"] += 1
                time.sleep(period)
            with lock:
                stats["results"] += len(c.wait_results(1, timeout=2))
        except Exception as e:  # noqa: BLE001
            with lock:
                stats["client_errors"].append(f"#{idx}c{cycle}: {e!r}")
            return
        finally:
            try:
                c.stop()
            except Exception:  # noqa: BLE001
                pass
        with lock:
            stats["cycles"] += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7788)
    ap.add_argument("--web-port", default="3000",
                    help="statusz port, or comma-separated list for a "
                         "reuse_port fleet (counters aggregate over shards)")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--fault", type=float, default=0.05,
                    help="per-packet drop/dup/corrupt probability")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda",
                    help="the port's device rule (default cuda; cpu runs "
                         "without a CUDA device)")
    args = ap.parse_args(argv)
    require_device(args.device, "soak")

    statusz = [f"http://{args.host}:{int(p)}/statusz"
               for p in str(args.web_port).split(",") if p.strip()]
    before = _statusz(statusz)
    stats = {"frames_sent": 0, "results": 0, "cycles": 0,
             "handshake_misses": 0, "client_errors": []}
    lock = threading.Lock()
    stop_t = time.monotonic() + args.duration
    threads = [threading.Thread(target=stream_worker,
                                args=(i, args, stop_t, stats, lock),
                                daemon=True) for i in range(args.streams)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=args.duration + 60)
    # Settle before the verdict: a final DISCONNECT can be eaten by the
    # fault injector, in which case the session lives until the server's
    # liveness eviction (network.timeout_ms, default 5 s) — poll past it
    # instead of reading a racy snapshot.
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        after = _statusz(statusz)
        fc0 = after.get("frame_cache") or {}
        if (after["clients"] <= before["clients"]
                and fc0.get("slots_used", 0) == 0):
            break
        time.sleep(1.0)
    after = _statusz(statusz)

    fc = after.get("frame_cache") or {}
    verdict = {
        "duration_s": round(time.monotonic() - t0, 1),
        "streams": args.streams,
        "fault_rate": args.fault,
        "cycles_completed": stats["cycles"],
        "frames_sent": stats["frames_sent"],
        "keyframe_results_seen": stats["results"],
        "handshake_misses": stats["handshake_misses"],
        "client_errors": stats["client_errors"][:5],
        "server": {
            "results_sent_delta": (after["results_sent"]
                                   - before["results_sent"]),
            "bad_packets_delta": (after["transport"]["bad_packets"]
                                  - before["transport"]["bad_packets"]),
            "clients_left": after["clients"],
            "slots_used_left": fc.get("slots_used"),
            "device_stall_s": after.get("device_stall_s"),
        },
        "clean": (not stats["client_errors"]
                  and after["clients"] <= before["clients"]
                  and (fc.get("slots_used") in (None, 0))
                  # A fully-stalled server also drains clean; the soak
                  # must additionally prove frames were actually SERVED.
                  and after["results_sent"] - before["results_sent"] > 0),
    }
    print(json.dumps(verdict))
    return 0 if verdict["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
