"""Microseconds of flush a write: the traced steps' `cache.flush` spans
over the writes they applied (the span's counter; `portbench/spans.py`)."""

from portbench import spans


def read(win):
    st = spans.steps(win)
    if st is None:
        return None
    writes = int(st.snap["a"][st.mask("cache.flush")].sum())
    if not writes:
        return None
    return float(st.seconds("cache.flush").sum()) * 1e6 / writes
