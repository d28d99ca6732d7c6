"""The share of the traced window in which the card ran no kernel and no
copy: 100 x (1 - the union of their intervals over the window)."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
