"""p50 ms over the served frames of the traced steps from the request's
`enqueue_t` (its due time) to its step's root span, as the program
records it (`portbench/spans.py`)."""

import numpy as np

from portbench import spans


def read(win):
    st = spans.steps(win)
    if st is None:
        return None
    served = set(win.served)
    clients, frames, waits = st.waits()
    v = [w for c, f, w in zip(clients.tolist(), frames.tolist(),
                              waits.tolist()) if (c, f) in served]
    return float(np.median(v)) * 1e3 if v else None
