"""p50 ms a traced step waited to acquire the frame cache's lock (the
program's `cache.lock_wait` span; `portbench/spans.py`): contention with
the writers."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "cache.lock_wait")
