"""p50 host ms of `InferenceEngine.dispatch_gathered` a step."""

import numpy as np


def read(win):
    v = win.spans_ms("launch")
    return float(np.median(v)) if len(v) else None
