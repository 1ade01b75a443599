"""Results delivered inside the window over the window's seconds."""

def read(win):
    return win.results_in_window / win.seconds
