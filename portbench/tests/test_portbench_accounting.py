"""Which offered frames a run counts as failed, and which traced events
its trace reduction reads."""

from pathlib import Path

import pytest

from portbench import serving, tracing


def kinds(**given):
    out = {k: [] for k in ("served", "superseded", "cache_shed",
                           "cache_refused", "engine_dropped", "unanswered")}
    out.update(given)
    return out


@pytest.mark.parametrize("given, expected", [
    # Superseded, then answered by a newer frame of the stream.
    (kinds(served=[(1, 3)], superseded=[(1, 1), (1, 2)]), []),
    # Superseded, and no newer frame of that stream was served.
    (kinds(served=[(1, 1), (2, 5)], superseded=[(1, 2), (2, 4)]), [(1, 2)]),
    # Every outcome but served and answered-superseded fails.
    (kinds(served=[(1, 9)], cache_shed=[(1, 2)], cache_refused=[(1, 3)],
           engine_dropped=[(1, 4)], unanswered=[(1, 5)]),
     [(1, 2), (1, 3), (1, 4), (1, 5)]),
])
def test_failed_frames(given, expected):
    assert sorted(serving.failed(given)) == expected


def test_trace_reduction_starts_at_the_marker():
    """Events before the marker (the profiler runs before the window)
    are left out; the window's kernels are counted from it on."""
    fams = tracing.families(Path(tracing.__file__).resolve().parent)

    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur}
    events = [kernel("nms_keep_kernel", 100.0, 50.0),
              kernel("void at::cuda::spin_kernel(long)", 1000.0, 1.0),
              kernel("nms_keep_kernel", 1100.0, 100.0),
              kernel("nms_keep_kernel", 1300.0, 100.0)]
    spans = {k: [] for k in ("gather", "cache_lock", "launch", "complete")}
    out = tracing.reduce(events, 10.0, 10.001, fams, spans,
                         {"nms_keep": 2})
    assert out["family_counts"] == {"nms": 2}
    assert out["missing"] == {}
    assert abs(out["busy_s"] - 200e-6) < 1e-9
    with pytest.raises(RuntimeError, match="marker"):
        tracing.reduce(events[2:], 10.0, 10.001, fams, spans, {})
