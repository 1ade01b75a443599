"""p50 host ms of the program's `step.preprocess` span a traced step: the
letterbox of the cache's bucket (`resize`), inside the step's launch
(`portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "step.preprocess")
