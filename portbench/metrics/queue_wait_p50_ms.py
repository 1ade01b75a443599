"""p50 ms from a served frame's due time to the start of its step's
dispatch (the cache lock's acquisition)."""

import numpy as np


def read(win):
    v = win.queue_wait_ms
    return float(np.median(v)) if len(v) else None
