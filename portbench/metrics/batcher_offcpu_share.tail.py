"""Share of the traced window in which the batcher thread ran no CPU time
of its own, in %: waiting for the GIL, blocked in a call, or idle between
steps. From the thread's CPU clock, which the program samples at a step's
root at most every 0.25 s (`portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.offcpu_share(win)
