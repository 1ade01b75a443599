"""Latency / throughput counters and host CPU accounting (a copy of the JAX
package's `utils/stats.py`: `RollingStats` and `Counter`, which the engine
uses, and `cpu_times`, `steal_pct` and `Stopwatch`, which `loadtest.py`
uses)."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class RollingStats:
    """Fixed-window latency stats (default 1000 samples) with avg/p50/p99."""

    def __init__(self, window: int = 1000) -> None:
        self._samples: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0

    def record(self, value_ms: float) -> None:
        with self._lock:
            self._samples.append(value_ms)
            self._count += 1

    def snapshot(self) -> Dict[str, float]:
        # Copy under the lock, sort OUTSIDE it: record() runs on the
        # dispatch lane, and sorting 1000 samples inside the shared mutex
        # on every /statusz poll added jitter to the latency being measured.
        with self._lock:
            vals = list(self._samples)
            n = self._count
        vals.sort()
        if not vals:
            return {"count": 0, "avg_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        def pct(p: float) -> float:
            return vals[min(len(vals) - 1, int(p * len(vals)))]
        return {
            "count": n,
            "avg_ms": sum(vals) / len(vals),
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "max_ms": vals[-1],
        }


class Counter:
    """Monotonic counter with a windowed rate.

    Events accumulate into 100 ms time bins (one deque entry per bin, not
    per event): a per-event deque capped the reported rate at maxlen events
    per window — at 10k+ pps the transport counters would have read a flat
    ~4k/s ceiling exactly under headline load."""

    _BIN_S = 0.1

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()
        self._bins: deque = deque(maxlen=600)  # (bin_index, count), ~60 s

    def inc(self, n: int = 1) -> None:
        b = int(time.monotonic() / self._BIN_S)
        with self._lock:
            self._value += n
            if self._bins and self._bins[-1][0] == b:
                self._bins[-1][1] += n
            else:
                self._bins.append([b, n])

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def rate(self, window_s: float = 1.0) -> float:
        # The bin deque holds ~60 s of history (600 x 0.1 s): clamp the
        # window to what the bins can actually cover, or a larger ask
        # silently undercounts (bins gone, span still derived from the
        # full window).
        window_s = min(window_s, self._bins.maxlen * self._BIN_S)
        now = time.monotonic()
        cutoff = int((now - window_s) / self._BIN_S)
        # Divide by the span the included bins actually cover (the window
        # minus the excluded partial bin), not the nominal window — dividing
        # by window_s undercounted by up to one bin width.
        span = max(now - (cutoff + 1) * self._BIN_S, self._BIN_S)
        with self._lock:
            return sum(n for b, n in self._bins if b > cutoff) / span


def cpu_times() -> Optional[list]:
    """First /proc/stat cpu line as ints (user..guest_nice); None off-Linux.
    A pair of snapshots feeds steal_pct: hypervisor CPU steal inflates
    latency tails on shared VMs, and a measurement row without the steal
    number looks like a regression."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return [int(v) for v in parts[1:]] if parts[:1] == ["cpu"] else None
    except (OSError, ValueError):
        return None


def steal_pct(before: Optional[list], after: Optional[list]) -> Optional[float]:
    """Steal share (%) of total CPU time between two cpu_times snapshots."""
    if not before or not after or len(before) < 8 or len(after) < 8:
        return None
    total = sum(after) - sum(before)
    steal = after[7] - before[7]
    return round(100.0 * steal / total, 1) if total > 0 else None


class Stopwatch:
    """Context-manager timer recording into a RollingStats (milliseconds)."""

    def __init__(self, stats: Optional[RollingStats] = None) -> None:
        self.stats = stats
        self.elapsed_ms = 0.0

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        if self.stats is not None:
            self.stats.record(self.elapsed_ms)
