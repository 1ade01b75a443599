"""p50 ms a step held the frame cache's lock: the span of
`DeviceFrameCache.dispatch_with` (flush of queued writes, then gather)."""

import numpy as np


def read(win):
    v = win.spans_ms("cache_lock")
    return float(np.median(v)) if len(v) else None
