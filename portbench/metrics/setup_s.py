"""Seconds from the process start to the measured window: imports, the
weights, the kernels (built on a checkout's first run), warm-up of the
cell's shapes, the frame pool and the traffic ramp."""

def read(win):
    return win.setup_s
