"""The knee sweep: a configuration's traffic at stepped stream counts.

    python3 portbench/knee.py --config yolov8s-640 --traffic s640-knee80 \\
        --streams 12,16,20,24 --seconds 6 --seed 7

One process builds the engine once and, for each rung, a frame cache with
one slot a stream and a batcher, then runs the traffic mix with its
`streams` set to the rung: the same generator, ramp and window as a cell's
run. Each rung prints one JSON line: streams, frames offered and served in
the window, the served share, the detect latency's p50 and p99 over served
frames and over every offered frame (a superseded one at its stream's next
answer), results a second and the accounting. The knee is the
highest stream count whose served share is at least 99%; tail cells offer
floor(0.8 x knee) streams, of the lowest knee that repeated sweeps find.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import serving  # noqa: E402
from portbench.run import ROOT, load_json  # noqa: E402
from portbench.traffic import Traffic, load as load_mix  # noqa: E402


def sweep(config: str, traffic: str, streams, seconds: float, seed: int,
          device: str = "cuda"):
    cfg = load_json(ROOT / "configs" / f"{config}.json")
    mix = load_mix(traffic, ROOT)
    core = serving.Core(cfg, ROOT, max(streams), device)
    rows = []
    for n in streams:
        rung = dict(mix, streams=n)
        rec = serving.Recorder()
        cache, batcher = core.open(n, rec)
        gen, w0, w1 = serving.drive(Traffic(rung, seed), cache, batcher, rec,
                                    float(rung["ramp_s"]), seconds)
        kinds = serving.account(gen, batcher, rec, w0, w1)
        win = serving.Window(None, core, rec, gen, kinds, w0, w1, None)
        lat = win.latency_ms
        offered = sum(len(v) for v in kinds.values())
        row = {"streams": n, "offered": offered, "served": len(win.served),
               "served_share": len(win.served) / max(offered, 1),
               "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
               "p99_ms": float(np.percentile(lat, 99)) if len(lat) else None,
               "answer_p99_ms": float(np.percentile(np.where(
                   np.isfinite(win.answer_ms), win.answer_ms, 1e15), 99))
               if len(win.answer_ms) else None,
               "results_per_s": win.results_in_window / win.seconds,
               "accounting": {k: len(v) for k, v in kinds.items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--streams", required=True,
                    help="comma-separated stream counts")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 2
    rows = sweep(args.config, args.traffic,
                 [int(s) for s in args.streams.split(",")], args.seconds,
                 args.seed)
    ok = [r["streams"] for r in rows if r["served_share"] >= 0.99]
    print(json.dumps({"config": args.config, "knee": max(ok) if ok else None,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
