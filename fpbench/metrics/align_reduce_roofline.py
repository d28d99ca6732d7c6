"""The exhaustive scan's least time (``flops.align_bound_s`` of the work the
inputs need, whatever the layout pads) over the device time of the kernels
named ``align_reduce`` in the traced window.  Nothing for the screen, whose
work depends on the data."""

from fpbench import flops


def read(r):
    if r.trace is None or r.engine != "align":
        return None
    busy = sum(t for name, t in r.trace.kernels if "align_reduce" in name)
    if busy <= 0:
        return None
    cfg, tr = r.cell.config, r.cell.traffic
    bound = flops.align_bound_s(tr["query_rows"], cfg["model"]["d"], tr["batch"],
                                cfg["n_songs"] * cfg["song_rows"], cfg["n_songs"])
    return 100.0 * r.batches * bound / busy
