"""The screen's stage-3 least time (``flops.align_bound_s`` of each call's
escalated queries against the catalogue's own rows) over the device time
of the ``align_reduce`` kernels launched inside ``screen.stage3`` in the
traced window."""

from fpbench.program_trace import stage3_roofline


def read(r):
    return stage3_roofline(r.program, r.cell.config, r.cell.traffic)
