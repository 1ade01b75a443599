"""p50 ms a traced step spent flushing the frame cache's queued writes
under its lock (the program's `cache.flush` span, 0 in a step with none
queued; `portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "cache.flush")
