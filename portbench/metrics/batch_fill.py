"""Frames dispatched over the bucket rows launched, in %."""

def read(win):
    rows = sum(s[2] for s in win.steps)
    if not rows:
        return None
    return 100.0 * sum(s[3] for s in win.steps) / rows
