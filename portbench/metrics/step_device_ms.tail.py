"""p50 ms of the traced steps' device intervals (`device.step`: from a
timing event recorded as the step began to its completion event, set on
the host clock; `portbench/spans.py`)."""

import numpy as np

from portbench import spans


def read(win):
    st = spans.steps(win)
    if st is None:
        return None
    v = st.seconds("device.step")
    return float(np.median(v)) * 1e3 if len(v) else None
