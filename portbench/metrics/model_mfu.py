"""Served frames x the model's conv operations a frame, over the window's
seconds x the card's bf16 peak, in % (the letterbox is not counted). The
window runs to the profiler's stop (see `serving.Window.span_end`)."""

from portbench import flops


def read(win):
    if "bf16_flops_per_s" not in win.peak or not win.results_to_span_end:
        return None
    per_frame = flops.flops_per_frame(win.cfg["model"])
    return (100.0 * win.results_to_span_end * per_frame
            / ((win.span_end - win.w0) * win.peak["bf16_flops_per_s"]))
