"""Share of the traced window that no step's device interval
(`device.step`, on the host clock; `portbench/spans.py`) covers, in %: the
device idle between steps, where `device_idle_share.tail` is idle inside
them too."""

from portbench import spans


def read(win):
    st = spans.steps(win)
    if st is None:
        return None
    iv = st.device_intervals()
    if not len(iv):
        return None
    covered, end = 0.0, st.t0
    for a, b in iv:
        a, b = max(a, end), min(b, st.t1)
        if b > a:
            covered += b - a
            end = b
    return 100.0 * (1.0 - covered / (st.t1 - st.t0))
