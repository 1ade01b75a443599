"""One run of one benchmark cell of the PyTorch / CUDA port's serving core.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
    python -m portbench.run ...            (the same)

Everything a cell is comes from files found by name: the cell in
`BENCHMARK.json` names its configuration (`portbench/configs/<name>.json`)
and its traffic (`portbench/workloads/<name>.json`); each metric is read by
`portbench/metrics/<metric name>.py` (`read(window)` returns a number, or
None where it finds nothing to read); kernel families are
`portbench/kernels/*.json`. A new cell, mix, metric or kernel family is a
new file, and no existing file changes.

The run builds the serving core, warms the cell's shapes, runs the
cell's open-loop traffic for a ramp and then the measured window, waits
for every frame due in the window to answer (at most a minute past the
close), reads the device's memory peak, frees the program and compares a
sample of the served frames, drawn from the seed, with the plain reference
(`portbench/reference/`). Earlier lines of standard output account for
every frame offered in the window; `failed` counts those that
`serving.failed` names (a frame superseded by a newer frame of its stream
is answered by that frame, and is not failed). The compared numbers and
their limits are the last lines of standard error and the last key of the
result, which is the last line of standard output. With `--trace 1` the
metrics are the cell's per-layer metrics, read from a traced window at the
end of the measured one; with `--trace 0` its end-to-end metrics.

A run needs as many CUDA devices as the cell asks for; without them it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, flops, serving, tracing  # noqa: E402
from portbench.reference.detect import Detector, rebuild  # noqa: E402
from portbench.traffic import Traffic, load as load_mix  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zero_latency_yolo_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics, or its per-layer ones."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metric(name: str, window) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(window)
    return None if value is None else float(value)


def power_label() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def pick_sample(seed: int, served: List, interval: int, n: int) -> List:
    """n served frames drawn from the seed, with the frames that carry the
    longest history of region writes (the last of a keyframe group)."""
    rng = np.random.default_rng([seed, 1])
    longest = [k for k in served if k[1] % interval == interval - 1]
    first = [longest[i] for i in rng.permutation(len(longest))[:8]]
    chosen = set(first)
    rest = [k for k in served if k not in chosen]
    take = rng.choice(len(rest), min(n - len(first), len(rest)),
                      replace=False) if rest else []
    return first + [rest[i] for i in sorted(take)]


def percentile(values, q: float) -> float:
    return float(np.percentile(values, q)) if len(values) else float("nan")


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: Optional[str] = None,
             plant: Optional[Callable] = None,
             t_start: float = T_START, cfg: Optional[Dict] = None,
             mix: Optional[Dict] = None,
             core: Optional[serving.Core] = None) -> Dict:
    """One run: returns the result line's object and the earlier lines.
    `device`, `plant` (called with the engine, cache and batcher before
    the traffic starts), `cfg` and `mix` are for the tests, which run the
    harness on the CPU at a small size with faults planted; `core`, an
    engine kept across runs, for `readings.py`, which reads many seeds in
    one process (the program is then not freed before the reference)."""
    cfg = cfg or load_json(ROOT / "configs" / f"{cell['config']}.json")
    mix = mix or load_mix(cell["traffic"], ROOT)
    traffic = Traffic(mix, seed)
    streams = int(mix["streams"])
    keep = core is not None
    core = core or serving.Core(cfg, ROOT, streams, device, control)
    rec = serving.Recorder()
    cache, batcher = core.open(streams, rec)
    engine = core.engine
    if plant is not None:
        plant(engine, cache, batcher)
    cuda = device.startswith("cuda")
    prof = None
    if trace and cuda:
        tracing.Profiler.warm()
        prof = tracing.Profiler(batcher.device_gate, engine.device)
    gen, w0, w1 = serving.drive(traffic, cache, batcher, rec,
                                float(mix["ramp_s"]), seconds, prof)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    kinds = serving.account(gen, batcher, rec, w0, w1)
    trace_sum = None
    if prof is not None:
        trace_sum = tracing.reduce(
            prof.events(), prof.t_mark, prof.t_stop, tracing.families(ROOT),
            rec.spans, tracing.launched_between(prof.counts0, prof.counts1))
        if trace_sum["missing"]:
            raise RuntimeError(
                "the trace missed kernels the window launched (family: "
                f"traced, launched): {trace_sum['missing']}")
    window = serving.Window(traffic, core, rec, gen, kinds, w0, w1,
                            trace_sum, prof.t_stop if prof else None)
    window.setup_s = w0 - t_start
    if prof is not None:
        window.trace_t0, window.trace_t1 = prof.t_mark, prof.t_stop
    window.device_name = kind = (torch.cuda.get_device_name(0) if cuda
                                 else device)
    window.peak = flops.peaks(kind, ROOT)
    lines = report_lines(window, engine, cache)
    if prof is not None:
        lines.append(f"portbench: profiler start {prof.start_s:.4f} s, stop "
                     f"{prof.stop_s:.4f} s; spans and steps read up to the "
                     "stop")
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        v = read_metric(m["name"], window)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    served = kinds["served"]
    attempted = sum(len(v) for v in kinds.values())
    n_failed = len(serving.failed(kinds))
    share = (attempted - len(served)) / max(attempted, 1)
    if share > float(mix["max_failed_share"]):
        lines.append(f"portbench: WARNING {100 * share:.2f}% of the frames "
                     "offered got no result of their own, over the mix's "
                     f"{100 * float(mix['max_failed_share']):.2f}%: on this "
                     "host the cell's load is not below its knee")

    sample = pick_sample(seed, served, traffic.interval, int(mix["sample"]))
    got = [compare.rows_of(rec.results[k][1]) for k in sample]
    held = [rec.served_as.get(key) for key in sample]
    held = [k if h is None else h for (_, k), h in zip(sample, held)]
    histories = [traffic.history(c - 1, h) for (c, _), h in zip(sample, held)]
    newer = sum(1 for key in served if (rec.served_as.get(key) or key[1])
                > key[1])
    older = sum(1 for key in served if (rec.served_as.get(key) or key[1])
                < key[1])
    lines.append(f"portbench: served frames whose step gathered a newer "
                 f"frame of the client {newer}, an older one {older}, of "
                 f"{len(served)}")
    del engine, cache, batcher, gen, rec, window
    if not keep:
        core.close()
    t_ref = time.perf_counter()
    det = Detector(cfg, str(REPO / cfg["weights"]), device)
    conf = float(cfg["server"]["confidence_threshold"])
    ref = det.detect([rebuild(kf, regions) for kf, regions in histories],
                     floor=conf - compare.CAND_MARGIN)
    h, w = mix["frame"]
    ok, checks, numbers, counts = compare.judge(
        got, ref, conf, int(cfg["server"]["tpu"]["pre_nms_topk"]), w, h,
        cfg["limits"])
    lines.append(f"portbench: compared {counts['frames']} served frames, "
                 f"{counts['detections']} detections against the "
                 f"reference's {counts['reference_detections']} "
                 f"({time.perf_counter() - t_ref:.2f} s); every number "
                 + json.dumps(numbers))
    dev = {"platform": "gpu" if cuda else device,
           "kind": kind,
           "count": 1, "memory_peak_bytes": peak,
           "power_limit": power_label() if cuda else "none"}
    result = {"correct": bool(ok), "attempted": attempted,
              "failed": n_failed, "metrics": metrics,
              "device": dev}
    if trace_sum is not None:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["window_s"]
        result["breakdown"] = {"device_ops": trace_sum["device_ops"],
                               "idle_gaps": trace_sum["idle_gaps"]}
    result["checks"] = checks
    return {"result": result, "lines": lines, "numbers": numbers}


def report_lines(win, engine, cache) -> List[str]:
    k = win.kinds
    parts = " ".join(f"{name}={len(v)}" for name, v in k.items())
    lat = win.latency_ms
    ans = win.answer_ms
    late = np.array([(l) * 1e3 for d, l in win.gen.late
                     if win.w0 <= d < win.w1])
    lines = [
        f"portbench: accounting attempted={sum(len(v) for v in k.values())}"
        f" {parts}; failed={len(serving.failed(k))}",
        f"portbench: detect latency ms p50={percentile(lat, 50):.4f} "
        f"p99={percentile(lat, 99):.4f} max={np.max(lat) if len(lat) else 0:.4f}"
        f" over {len(lat)} served frames; results in the window "
        f"{win.results_in_window} in {win.seconds:.3f} s",
        f"portbench: answer latency ms (superseded frames at their stream's "
        f"next answer) p50={percentile(ans, 50):.4f} p99="
        f"{percentile(np.where(np.isfinite(ans), ans, 1e15), 99):.4f} over "
        f"{len(ans)} offered frames, {int(np.sum(~np.isfinite(ans)))} never "
        "answered",
        f"portbench: generator late ms p50={percentile(late, 50):.4f} "
        f"p99={percentile(late, 99):.4f} max={np.max(late) if len(late) else 0:.4f}",
        f"portbench: steps {len(win.steps)}, rows launched "
        f"{sum(s[2] for s in win.steps)}, frames {sum(s[3] for s in win.steps)}"
        f"; buckets {sorted({s[2] for s in win.steps})}",
        f"portbench: program counters frames_dropped="
        f"{engine.frames_dropped.value} errors={engine.error_count.value} "
        f"cache writes_shed={cache.writes_shed} flushes={cache.flushes} "
        f"writes_flushed={cache.writes_flushed}",
        f"portbench: setup_s={win.setup_s:.4f}",
    ]
    if win.trace is not None:
        t = win.trace
        lines.append(f"portbench: trace busy_s={t['busy_s']:.6f} "
                     f"window_s={t['window_s']:.6f} categories="
                     + json.dumps({c: round(s, 6) for c, s in
                                   sorted(t['categories'].items())}))
        lines.append("portbench: trace kernels by family "
                     + json.dumps(t["family_counts"]) + " launched "
                     + json.dumps(t["launched"]))
        if t["unmapped"]:
            lines.append("portbench: kernels no family maps (counted as "
                         "other): " + json.dumps(t["unmapped"]))
    return lines


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(REPO / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the run may not hold: {bad}",
              file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line)
    checks = out["result"]["checks"]
    for name, c in checks.items():
        print(f"portbench: check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
