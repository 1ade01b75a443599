"""p50 host ms of the program's `step.model` span a traced step: the model's
launches (`forward_decoded[_levels]`), inside the step's launch
(`portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "step.model")
