"""utils/profiling.py of the port on the CPU: the torch.profiler capture
behind /profilez (bounded, single-flight, gated, with the span recorder's
spans.json), the trace context and the named ranges."""

import json
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from zero_latency_yolo_tpu_torch.utils import profiling  # noqa: E402


class CountingLock:
    """A lock that counts how often it was taken."""

    def __init__(self):
        self.lock = threading.RLock()
        self.taken = 0

    def __enter__(self):
        self.lock.acquire()
        self.taken += 1
        return self

    def __exit__(self, *exc):
        self.lock.release()


def test_capture_records_another_threads_operators(tmp_path):
    """A capture while another thread runs operators: ok, a Chrome trace
    holding that thread's operators and named ranges; the gate was taken
    once to start and once to stop; the status names the last capture."""
    stop = threading.Event()
    gate = CountingLock()

    def work():
        x = torch.ones(64, 64)
        while not stop.is_set():
            with gate, profiling.annotate("zlt-test-range"):
                torch.mm(x, x)
            time.sleep(0.001)
    worker = threading.Thread(target=work)
    worker.start()
    try:
        out = profiling.capture(0.3, str(tmp_path), gate=gate)
    finally:
        stop.set()
        worker.join()
    assert out["ok"] and out["seconds"] == 0.3
    assert Path(out["dir"]).parent == tmp_path
    assert [f["name"] for f in out["files"]] == ["spans.json", "trace.json"]
    events = json.loads((Path(out["dir"]) / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names and "zlt-test-range" in names
    st = profiling.capture_status()
    assert st == {"capturing": False, "last": out}
    assert set(out["cost_ms"]) == {"start", "stop", "export"}
    assert all(v >= 0 for v in out["cost_ms"].values())


def test_capture_is_bounded_and_single_flight(tmp_path):
    for bad in (0.01, 31.0, float("nan")):
        assert "must be in" in profiling.capture(bad, str(tmp_path))["error"]
    results = {}
    t = threading.Thread(target=lambda: results.update(
        profiling.capture(0.5, str(tmp_path))))
    t.start()
    deadline = time.monotonic() + 10
    while not profiling.capture_status()["capturing"]:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    busy = profiling.capture(0.1, str(tmp_path))
    t.join()
    assert "in flight" in busy["error"]
    assert results["ok"]
    assert not profiling.capture_status()["capturing"]


def test_capture_holds_the_gate_only_to_start_and_stop(tmp_path):
    """While the window runs the gate is free: a thread can take it."""
    gate = CountingLock()
    took = []

    def probe():
        time.sleep(0.1)
        with gate:
            took.append(time.monotonic())
    t = threading.Thread(target=probe)
    t.start()
    t0 = time.monotonic()
    out = profiling.capture(0.4, str(tmp_path), gate=gate)
    t.join()
    assert out["ok"] and gate.taken == 3
    assert took and took[0] - t0 < 0.35  # inside the window


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate("zlt-phase"):
            torch.ones(8).sum()
    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "zlt-phase" for e in events)
