"""Share of the traced window in which no kernel, copy or memset ran on
the card, in %."""

def read(win):
    tr = win.trace
    if tr is None or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
