"""The convs' roofline bound over the traced steps (every conv at each
step's bucket batch) over the traced device time of conv kernels, in %."""

from portbench import flops


def read(win):
    tr = win.trace
    if tr is None or not win.peak or not tr["categories"].get("conv"):
        return None
    steps = [s for s in win.rec.steps
             if win.trace_t0 <= s[0] <= win.trace_t1]
    if not steps:
        return None
    bound = sum(flops.conv_bound_s(win.cfg["model"], s[2], win.peak)
                for s in steps)
    return 100.0 * bound / tr["categories"]["conv"]
