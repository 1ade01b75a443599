"""The program's own spans, for the metrics that read them.

The serving core records its steps' spans itself while a profiler runs
(`zero_latency_yolo_tpu_torch/utils/profiling.py`, `SPANS`: each batcher
step's root `batcher.step` and its children, each request's wait, each
step's `device.step` interval, and the batcher thread's CPU clock sampled
at its roots, all on `time.perf_counter`, the clock of the trace marker).
A traced run's metrics read the steps whose root began between the marker
(`win.trace_t0`) and the profiler's stop (`win.trace_t1`). `steps(win)` is
None in an untraced run, and where the program has no such recorder, so
those metrics are left out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Steps rooted this long before the marker are read too: a device interval
# of one of them may run into the window.
LEAD_S = 1.0


class Steps:
    """The recorded steps whose root began in [t0, t1), and their spans."""

    def __init__(self, snap, names, t0: float, t1: float) -> None:
        self.snap, self.t0, self.t1 = snap, t0, t1
        self._id = {n: i for i, n in enumerate(names)}
        root = ((snap["name"] == self._id["batcher.step"])
                & (snap["t0"] >= t0) & (snap["t0"] < t1))
        self.ids = np.unique(snap["step"][root])
        self._in = np.isin(snap["step"], self.ids)

    def __len__(self) -> int:
        return len(self.ids)

    def mask(self, name: str) -> np.ndarray:
        return self._in & (self.snap["name"] == self._id[name])

    def seconds(self, name: str) -> np.ndarray:
        m = self.mask(name)
        return self.snap["t1"][m] - self.snap["t0"][m]

    def per_step_ms(self, name: str) -> np.ndarray:
        """Milliseconds of `name` a step, summed, 0 where a step has none."""
        m = self.mask(name)
        out = np.zeros(len(self.ids))
        np.add.at(out, np.searchsorted(self.ids, self.snap["step"][m]),
                  (self.snap["t1"][m] - self.snap["t0"][m]) * 1e3)
        return out

    def waits(self):
        """(client, frame, wait seconds) of the requests of these steps."""
        s = self.snap
        m = np.isin(s["wait_step"], self.ids)
        return s["wait_client"][m], s["wait_frame"][m], s["wait_s"][m]

    def device_intervals(self) -> np.ndarray:
        """Every recorded `device.step` interval, (n, 2), by start."""
        s = self.snap
        m = s["name"] == self._id["device.step"]
        iv = np.stack([s["t0"][m], s["t1"][m]], axis=1)
        return iv[np.argsort(iv[:, 0])]


def _recorder(win):
    """The program's recorder and its span names, and the traced window;
    None untraced or where the program has no recorder."""
    t0 = getattr(win, "trace_t0", None)
    t1 = getattr(win, "trace_t1", None)
    if t0 is None or t1 is None:
        return None
    try:
        from zero_latency_yolo_tpu_torch.utils import profiling
        return profiling.SPANS, profiling.SPAN_NAMES, t0, t1
    except (ImportError, AttributeError):
        return None


def steps(win) -> Optional[Steps]:
    got = _recorder(win)
    if got is None:
        return None
    rec, names, t0, t1 = got
    st = Steps(rec.snapshot(t0 - LEAD_S), names, t0, t1)
    return st if len(st) else None


def offcpu_share(win) -> Optional[float]:
    """100 x (1 - CPU time / wall time) of the thread that rooted the
    traced steps, between its first and last CPU-clock samples in the
    window; None with fewer than two."""
    got = _recorder(win)
    if got is None or not hasattr(got[0], "cpu_samples"):
        return None
    rec, _, t0, t1 = got
    s = rec.cpu_samples()
    m = (s["t"] >= t0) & (s["t"] < t1)
    if not m.any():
        return None
    threads, counts = np.unique(s["thread"][m], return_counts=True)
    m &= s["thread"] == threads[np.argmax(counts)]
    t, cpu = s["t"][m], s["cpu_ns"][m]
    if len(t) < 2 or t[-1] <= t[0]:
        return None
    return 100.0 * (1.0 - (cpu[-1] - cpu[0]) * 1e-9 / (t[-1] - t[0]))


def median_per_step_ms(win, name: str) -> Optional[float]:
    st = steps(win)
    return None if st is None else float(np.median(st.per_step_ms(name)))
