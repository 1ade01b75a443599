"""The readings that a configuration's limits are set from.

    python3 portbench/readings.py --workload s640-knee80 --seconds 4 \\
        --seeds 12 --control-seeds 3 --base-seed 5000 \\
        [--faults half_results_empty,nms_skipped --fault-seeds 3]

In one process: the program on `--seeds` seeds, then each fault of
`faults.py` named in `--faults` planted in the program on `--fault-seeds`
more, then the control on `--control-seeds` more, each a run of the cell at
its own size and load with a short window (the engine built once a side).
The control is the program with its own lower-precision path switched on:
the int8 backbone (`tpu.quantize_int8`) in place of the configuration's
bf16. Prints one JSON line a run and, last, the largest reading of the
program and the smallest of the control and of each fault for each
number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from portbench import compare, serving  # noqa: E402
from portbench.faults import FAULTS, Patch  # noqa: E402
from portbench.run import ROOT, find_cell, load_json, run_cell  # noqa: E402
from portbench.traffic import load as load_mix  # noqa: E402


def read(workload: str, seconds: float, seeds, control_seeds,
         device: str = "cuda", faults=(), fault_seeds=()):
    bench = load_json(REPO / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    cfg = load_json(ROOT / "configs" / f"{cell['config']}.json")
    streams = int(load_mix(cell["traffic"], ROOT)["streams"])
    rows = []
    runs = {None: [(None, s) for s in seeds]
            + [(f, s) for f in faults for s in fault_seeds],
            "int8": [(None, s) for s in control_seeds]}
    for variant, todo in runs.items():
        if not todo:
            continue
        core = serving.Core(cfg, ROOT, streams, device, variant)
        for fault, seed in todo:
            patch = Patch()
            plant = (None if fault is None else
                     lambda e, c, b, f=FAULTS[fault]: f(e, c, b, patch))
            out = run_cell(bench, cell, seed, seconds, False, device=device,
                           control=variant, core=core, plant=plant)
            patch.undo()
            res = out["result"]
            name = variant or ("program" if fault is None
                               else "fault:" + fault)
            row = {"variant": name, "seed": seed,
                   "correct": res["correct"], "attempted": res["attempted"],
                   "failed": res["failed"],
                   "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                   "numbers": out["numbers"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
        core.close()
    summary = {}
    for k in compare.NUMBERS:
        prog = [r["numbers"][k] for r in rows if r["variant"] == "program"]
        summary[k] = {"program_max": max(prog) if prog else None}
        for v in sorted({r["variant"] for r in rows} - {"program"}):
            got = [r["numbers"][k] for r in rows if r["variant"] == v]
            summary[k][("control" if v == "int8" else v) + "_min"] = min(got)
    print(json.dumps({"workload": workload, "readings": summary}))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=5000)
    ap.add_argument("--faults", default="",
                    help="comma-separated names from faults.py")
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    b = args.base_seed
    faults = [f for f in args.faults.split(",") if f]
    read(args.workload, args.seconds, range(b, b + args.seeds),
         range(b + 1000, b + 1000 + args.control_seeds), faults=faults,
         fault_seeds=range(b + 2000, b + 2000 + args.fault_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
