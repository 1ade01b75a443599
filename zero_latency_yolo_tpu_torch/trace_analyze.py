"""Profiler trace of the serving step, rolled up by kernel and by category.

    python -m zero_latency_yolo_tpu_torch.trace_analyze [--batch 64]
        [--size 416] [--steps 20] [--stem conv] [--dot1x1] [--device cuda]
    python -m zero_latency_yolo_tpu_torch.trace_analyze --analyze-only DIR \\
        --steps N

Traces N cached serving steps (letterbox -> model -> NMS -> packed output,
`InferenceEngine.get_step_cached` over 600x800 frames in a 608x800 bucket,
bf16, the port's seeded `init_params`) with `utils/profiling.trace`, then
sums the Chrome trace's device events (kernels, copies, memsets) by name
and by category:

  port:<kernel>   the port's own kernels, by symbol (`ops/launches.py`
                  KERNEL_SYMBOLS)
  conv            cuDNN / implicit-GEMM convolutions
  gemm            GEMMs (the letterbox's `bmm`s)
  elementwise     elementwise kernels
  copy/layout     memcpy, memset, copies, cat, index, gather
  reduction       reduce kernels
  other           the rest (pooling, sorts, ...)

It prints ms a step, each category's share, the top 18 kernels and the
device's idle share of the window (first event's start to last event's
end), then one JSON line of the same numbers. `--analyze-only DIR` reads
the trace.json of DIR (or DIR itself, a file): one this tool wrote, or one
`/profilez` (`utils/profiling.capture`) wrote. A trace with no device
events (a run on the CPU) is rolled up over its host lane instead: the
outermost CPU operators of each thread, with `"lane": "host"` in the JSON,
a host time, not a device's.

The port's copy of the JAX package's `scripts/trace_analyze.py`, with
`--device` (default cuda) in place of the JAX platform and the trace
directory under `logs/` (git-ignored) by default.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, List, Tuple

import numpy as np

from .ops.launches import kernel_of
from .utils.device import require_device
from .utils.profiling import kernel_rows

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CATEGORIES = ("conv", "gemm", "elementwise", "copy/layout", "reduction",
              "other")
TOP = 18


def categorize(name: str) -> str:
    """The category of a device event by its name (order matters: a copy
    kernel is an elementwise kernel by its template, a copy by its work)."""
    port = kernel_of(name)
    if port is not None:
        return f"port:{port}"
    low = name.lower()
    if low.startswith(("memcpy", "memset")) or any(k in low for k in (
            "copy", "catarray", "cat_", "index", "gather", "scatter",
            "transpose", "nchwtonhwc", "nhwctonchw", "permute")):
        return "copy/layout"
    if any(k in low for k in ("fprop", "implicit_gemm", "convolve", "conv2d",
                              "cudnn", "winograd", "dgrad", "wgrad")):
        return "conv"
    if "gemm" in low or "cublas" in low or "cutlass" in low:
        return "gemm"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def read_trace(path: str) -> List[dict]:
    """The events of a Chrome trace: `path` a trace.json, or a directory
    holding one (searched recursively; the newest if several)."""
    if os.path.isdir(path):
        found = [os.path.join(root, n) for root, _d, names in os.walk(path)
                 for n in names if n == "trace.json"]
        if not found:
            raise FileNotFoundError(f"no trace.json under {path}")
        path = max(found, key=os.path.getmtime)
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _outermost(events: List[dict]) -> List[dict]:
    """Of nested complete events, those no other event of the same thread
    contains."""
    out = []
    by_tid: Dict[object, List[dict]] = {}
    for e in events:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_tid.values():
        end = -np.inf
        for e in sorted(evs, key=lambda e: (float(e["ts"]),
                                            -float(e.get("dur", 0.0)))):
            if float(e["ts"]) >= end:
                out.append(e)
                end = float(e["ts"]) + float(e.get("dur", 0.0))
    return out


def lane_events(events: List[dict]) -> Tuple[str, List[dict]]:
    """("device", its kernels, copies and memsets), or, for a trace without
    any, ("host", the outermost CPU operators)."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if dev:
        return "device", dev
    return "host", _outermost([e for e in events if e.get("ph") == "X"
                               and e.get("cat") == "cpu_op"])


def busy_us(events: List[dict]) -> Tuple[float, float]:
    """(busy, window) in microseconds: the union of the events' intervals,
    and the span from the first start to the last end."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events)
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def rollup(events: List[dict], steps: int) -> dict:
    """The numbers the tool prints, per step: total ms, ms and share by
    category, each port kernel's ms and launches (and its launches over
    all steps, `launches_total`, where a stray launch shows), the top
    kernels, and the lane's idle share of the window."""
    lane, evs = lane_events(events)
    names = [e.get("name", "") for e in evs]
    rows = kernel_rows(((name, float(e.get("dur", 0.0)), 1)
                        for name, e in zip(names, evs)), steps)
    total = sum(ms for ms, _, _ in rows)
    cats: Dict[str, float] = {}
    port: Dict[str, Dict[str, float]] = {}
    for ms, n, name in rows:
        cat = categorize(name) if lane == "device" else "host"
        cats[cat] = cats.get(cat, 0.0) + ms
        if cat.startswith("port:"):
            k = port.setdefault(cat[5:], {"ms": 0.0, "launches": 0,
                                          "launches_total": 0})
            k["ms"] += ms
            k["launches"] += n
            k["launches_total"] += names.count(name)
    busy, window = busy_us(evs)
    return {
        "lane": lane, "steps": steps, "events": len(evs),
        "ms_per_step": total,
        "categories": {c: {"ms": ms, "share": ms / total if total else 0.0}
                       for c, ms in sorted(cats.items(),
                                           key=lambda kv: -kv[1])},
        "port_kernels": port,
        "top": [[ms, n, name] for ms, n, name in rows[:TOP]],
        "busy_ms": busy / 1e3, "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else None,
    }


def print_rollup(r: dict) -> None:
    unit = "device" if r["lane"] == "device" else "host (no device events)"
    print(f"\nlane: {unit}, {r['events']} events")
    print(f"total {r['lane']} time: {r['ms_per_step'] * r['steps']:.3f} ms "
          f"over {r['steps']} steps => {r['ms_per_step']:.4f} ms/step")
    print("\nper category (ms/step):")
    for cat, v in r["categories"].items():
        print(f"  {cat:24s} {v['ms']:9.4f}  ({100 * v['share']:4.1f}%)")
    print(f"\ntop {TOP} ops (ms/step, launches/step):")
    for ms, n, name in r["top"]:
        print(f"  {ms:9.4f} {n:5d}  {name[:100]}")
    if r["idle_share"] is not None:
        print(f"\nidle share of the window: {r['idle_share']:.4f} "
              f"(busy {r['busy_ms']:.3f} of {r['window_ms']:.3f} ms)")


def run_trace(args, trace_dir: str) -> str:
    """Trace args.steps cached steps into trace_dir; returns the device's
    label."""
    import torch

    from .runtime.engine import InferenceEngine
    from .utils.bench_util import (cached_step_runner, device_label,
                                   seeded_params, serving_config)
    from .utils.profiling import trace

    bh, bw, h, w = args.bucket_h, args.bucket_w, args.height, args.width
    cfg = serving_config(args.variant, args.size, [args.batch], (bh, bw),
                         dtype=args.dtype, stem=args.stem,
                         dot1x1=args.dot1x1)
    engine = InferenceEngine(cfg, params=seeded_params(args.variant),
                             device=args.device)
    frames = np.random.default_rng(0).integers(
        0, 256, (args.batch, bh, bw, 3), dtype=np.uint8)
    run_once = cached_step_runner(engine, args.batch, (bh, bw), h, w, frames)
    run_once().cpu()  # build and warm
    out = None
    with trace(trace_dir):
        for _ in range(args.steps):
            out = run_once()
        out.cpu()
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
    return device_label(engine.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--variant", default="yolov8n")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--stem", default="conv")
    ap.add_argument("--dot1x1", action="store_true")
    ap.add_argument("--bucket-h", type=int, default=608)
    ap.add_argument("--bucket-w", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--trace-dir", default=os.path.join("logs",
                                                         "trace_analyze"))
    ap.add_argument("--analyze-only", default="", metavar="DIR",
                    help="roll up the trace.json in DIR (or the file DIR) "
                         "without tracing")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    label = None
    path = args.analyze_only
    if not path:
        require_device(args.device, "trace_analyze")
        shutil.rmtree(args.trace_dir, ignore_errors=True)
        label = run_trace(args, args.trace_dir)
        path = args.trace_dir
    r = rollup(read_trace(path), args.steps)
    if not r["events"]:
        print(f"trace_analyze: no events in the trace at {path}",
              file=sys.stderr)
        return 1
    print_rollup(r)
    r.update(trace=path, device=label)
    if label is not None:
        r.update(batch=args.batch, size=args.size, variant=args.variant,
                 dtype=args.dtype)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
