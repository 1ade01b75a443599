"""p50 host ms of the program's `engine.launch` span a traced step: the
step's launch (`InferenceEngine.dispatch_gathered`), as the program times
it (`portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "engine.launch")
