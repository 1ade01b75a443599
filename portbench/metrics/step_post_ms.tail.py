"""p50 host ms of the program's `step.post` span a traced step: decode,
threshold, top-K, suppression and packing (`postprocess_batch[_levels]` +
`pack_outputs`), inside the step's launch (`portbench/spans.py`)."""

from portbench import spans


def read(win):
    return spans.median_per_step_ms(win, "step.post")
