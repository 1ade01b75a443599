"""CPython GC pause tracking + latency-oriented tuning.

Why this exists: the wire-to-wire detect p99 is the product's headline
number (BASELINE p99 < 8 ms), and on a CPython host every cyclic-GC
collection is a stop-the-world pause for ALL threads — the event loop,
the batcher, and the native drain thread included. A gen-2 collection
walks every tracked container in the process (a PyTorch+server process holds
hundreds of thousands), which shows up as multi-millisecond host-overhead
spikes exactly at the tail the SLO gates on. The reference never had this
problem class (C++), so this is rebuild-specific engineering, measured in
docs/BENCH_NOTES.md (host-tail section).

Two pieces:

- `GcPauseTracker` — gc.callbacks-based pause observer: per-generation
  collection counts and a rolling pause histogram, surfaced in /statusz
  (`host.gc`). Always on; the callback costs two perf_counter reads per
  collection.
- `tune_for_latency()` — the measured serving posture: one full collect,
  `gc.freeze()` (move every long-lived startup object — modules, jitted
  executables, config, caches — out of the young generations so cyclic GC
  stops re-scanning them), and wider gen-0/1 thresholds so young
  collections run less often on the hot path. Applied AFTER warmup (the
  server's jit programs and pools are then all frozen tenure), controlled
  by `tpu.gc_tune`.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Dict, Optional

from .stats import RollingStats

# Measured default (docs/BENCH_NOTES.md): gen0 ~36x the CPython default —
# young collections at serving allocation rates were the pause *count*
# driver; gen1/gen2 ratios keep full collections rare but not disabled
# (unbounded cycle growth is worse than a bounded pause).
LATENCY_THRESHOLDS = (25_000, 50, 50)


class GcPauseTracker:
    """Observe every cyclic-GC collection in the process via gc.callbacks."""

    def __init__(self, window: int = 512) -> None:
        self.pauses = RollingStats(window=window)
        self.collections = [0, 0, 0]
        self.collected = 0
        self.uncollectable = 0
        self.total_pause_ms = 0.0
        self.max_pause_ms = 0.0
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._installed = False

    # gc callbacks run in whichever thread triggered the collection, with
    # the GIL held; collections never nest, so one _t0 slot is enough.
    def _cb(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        t0, self._t0 = self._t0, None
        if t0 is None:
            return
        pause_ms = (time.perf_counter() - t0) * 1e3
        gen = int(info.get("generation", 0))
        with self._lock:
            self.collections[min(gen, 2)] += 1
            self.collected += int(info.get("collected", 0))
            self.uncollectable += int(info.get("uncollectable", 0))
            self.total_pause_ms += pause_ms
            if pause_ms > self.max_pause_ms:
                self.max_pause_ms = pause_ms
        self.pauses.record(pause_ms)

    def install(self) -> "GcPauseTracker":
        if not self._installed:
            gc.callbacks.append(self._cb)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._installed = False

    def status(self) -> Dict[str, object]:
        snap = self.pauses.snapshot()
        with self._lock:
            return {
                "collections_g0": self.collections[0],
                "collections_g1": self.collections[1],
                "collections_g2": self.collections[2],
                "collected": self.collected,
                "uncollectable": self.uncollectable,
                "pause_total_ms": round(self.total_pause_ms, 3),
                "pause_max_ms": round(self.max_pause_ms, 3),
                "pause_p99_ms": round(snap["p99_ms"], 3),
                "pause_avg_ms": round(snap["avg_ms"], 4),
                "frozen": gc.get_freeze_count(),
                "thresholds": list(gc.get_threshold()),
            }


def tune_for_latency(thresholds=LATENCY_THRESHOLDS) -> Dict[str, object]:
    """Apply the serving GC posture; call AFTER warmup so everything alive
    now (modules, compiled programs, pools, config) is tenure worth
    freezing. Returns what was done (logged by the caller)."""
    collected = gc.collect()
    gc.freeze()
    gc.set_threshold(*thresholds)
    return {"collected": collected, "frozen": gc.get_freeze_count(),
            "thresholds": list(thresholds)}


def untune() -> None:
    """Restore interpreter defaults (tests)."""
    gc.unfreeze()
    gc.set_threshold(700, 10, 10)
    sys.setswitchinterval(0.005)
    gc.enable()
