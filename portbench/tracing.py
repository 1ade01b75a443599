"""The traced window and its reduction to device time, categories and gaps.

The profiler (torch.profiler, the card's kernels, copies and memsets)
starts `ARM_S` before the window it traces, so that it records by the
time the window opens; the window opens and closes under the batcher's
`device_gate`, so only between the batcher's engine calls, and each time
after a device synchronise: it holds every kernel of the steps dispatched
inside it and nothing of the steps before. A marker kernel of its own
name (`spin_kernel`) launched as the window opens ties the trace's clock
to the host's, so each idle gap on the device can be set against what the
batcher thread was doing then; the reduction drops every event before
it.

Kernel names map to categories through one JSON file per kernel family
under `kernels/` ({"order", "category", "symbols"[, "launch_counter"]}):
the lowest "order" whose symbols one is a substring of the lower-cased
name wins. A name no family maps counts as "other" and is listed. A
family with a "launch_counter" names the program's launch count of that
kernel (`ops/launches.py`); a trace that holds fewer of the family's
kernels than the window launched has missed some, and the run fails.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from zero_latency_yolo_tpu_torch.ops.launches import launch_counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
# The profiler runs this long before the window opens: started right at
# the window, one traced run in six missed three steps' kernels.
ARM_S = 0.5
# Held, with the gate, before the profiler's stop: a trace cut right at a
# step's last kernel dropped that step.
SETTLE_S = 0.25
# The marker's kernel (`torch.cuda._sleep`); nothing else launches it.
MARKER = "spin_kernel"


def families(root: Path) -> List[Dict]:
    out = []
    for p in sorted((root / "kernels").glob("*.json")):
        with open(p) as f:
            fam = json.load(f)
        fam["name"] = p.stem
        fam["symbols"] = [s.lower() for s in fam["symbols"]]
        out.append(fam)
    return sorted(out, key=lambda f: (f["order"], f["name"]))


def family_of(name: str, fams: List[Dict]) -> Optional[Dict]:
    low = name.lower()
    for fam in fams:
        if any(s in low for s in fam["symbols"]):
            return fam
    return None


class Profiler:
    """One traced window over the running batcher."""

    def __init__(self, gate, device) -> None:
        self.gate = gate
        self.device = device
        self.arm_s = ARM_S

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    @classmethod
    def warm(cls) -> None:
        """Load the profiler's device tracing once, in set-up."""
        prof = cls._profile()
        prof.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()

    def start(self) -> None:
        """Start the profiler, wait `ARM_S` (the batcher runs on), then
        open the window: the marker and the launch counts."""
        t = time.perf_counter()
        with self.gate:
            self.prof = self._profile()
            self.prof.start()
        self.start_s = time.perf_counter() - t
        time.sleep(self.arm_s)
        with self.gate:
            torch.cuda.synchronize(self.device)
            self.t_mark = time.perf_counter()
            with torch.cuda.device(self.device):
                torch.cuda._sleep(1000)
            self.counts0 = launch_counts()

    def stop(self) -> None:
        with self.gate:
            torch.cuda.synchronize(self.device)
            self.t_stop = time.perf_counter()
            self.counts1 = launch_counts()
            time.sleep(SETTLE_S)
            self.prof.stop()
        self.stop_s = time.perf_counter() - self.t_stop

    def events(self) -> List[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _host_activity(t: float, spans: Dict[str, List[Tuple[float, float]]]
                   ) -> str:
    for name in ("gather", "cache_lock", "launch", "complete"):
        seq = spans[name]
        i = bisect.bisect_right(seq, (t, float("inf"))) - 1
        if i >= 0 and seq[i][0] <= t <= seq[i][1]:
            return f"batcher in {name}"
    return "batcher outside the engine and cache calls"


def reduce(events: List[dict], t_mark: float, t_stop: float,
           fams: List[Dict], host_spans: Dict[str, List[Tuple[float, float]]],
           launched: Dict[str, int]) -> Dict:
    """The trace's device events between the marker and the stop, as busy
    and window seconds, seconds by category and by kernel name, the idle
    gaps by what the batcher thread was doing, and the check that no
    kernel went missing."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    marks = [i for i, e in enumerate(dev) if MARKER in e.get("name", "")]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels, "
                           "not one")
    base = float(dev[marks[0]]["ts"])
    # What ran after the marker: the window's steps (the profiler ran
    # before it too, and the marker itself is no step's).
    dev = dev[marks[0] + 1:]
    window_us = (t_stop - t_mark) * 1e6
    spans = [(float(e["ts"]) - base,
              float(e["ts"]) - base + float(e.get("dur", 0.0)))
             for e in dev]
    merged = _merge([(max(s, 0.0), min(e, window_us)) for s, e in spans
                     if s < window_us])
    busy_us = sum(e - s for s, e in merged)
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    unmapped: Dict[str, int] = {}
    for e in dev:
        name = e.get("name", "")
        dur = float(e.get("dur", 0.0)) * 1e-6
        fam = family_of(name, fams)
        cat = fam["category"] if fam else "other"
        if fam is None:
            unmapped[name[:120]] = unmapped.get(name[:120], 0) + 1
        else:
            counts[fam["name"]] = counts.get(fam["name"], 0) + 1
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + dur
    missing = {}
    for fam in fams:
        ctr = fam.get("launch_counter")
        if ctr and counts.get(fam["name"], 0) < launched.get(ctr, 0):
            missing[fam["name"]] = (counts.get(fam["name"], 0),
                                    launched.get(ctr, 0))
    ordered = {k: sorted(v) for k, v in host_spans.items()}
    gaps: Dict[str, float] = {}
    edges = [(0.0, 0.0)] + merged + [(window_us, window_us)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            what = _host_activity(t_mark + (a + b) / 2e6, ordered)
            gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "categories": by_cat,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "family_counts": counts,
        "launched": launched,
        "missing": missing,
        "unmapped": unmapped,
    }


def launched_between(c0: Dict[str, int], c1: Dict[str, int]) -> Dict[str, int]:
    return {k: c1[k] - c0.get(k, 0) for k in c1}
