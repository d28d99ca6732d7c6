"""The whole serving step's share of the card's bf16 peak over the traced
window: the operations of every segment embedded (log-mel's DFT and mel
products, the FpNetwork forward) and of every exhaustive scan (every query
row against every catalogue row), counted from the configuration's widths
by ``fpbench/flops.py``.  Nothing where the engine's work depends on the
data (the screen)."""

from fpbench import flops


def read(r):
    if r.trace is None or r.trace.busy_s <= 0 or r.engine != "align":
        return None
    cfg, tr = r.cell.config, r.cell.traffic
    ops = r.segments * flops.segment_flops(cfg) + r.batches * flops.align_ops(
        tr["query_rows"], cfg["model"]["d"], tr["batch"], cfg["n_songs"] * cfg["song_rows"])
    return 100.0 * ops / (r.trace.window_s * flops.PEAK_BF16_OPS)
