"""The share of the traced window in which the card was idle while the
host prepared work for it: idle gaps whose midpoint falls under the
program's spans of packing, uploads, the filters and the answer list
(``program_trace.HOST_PREP_SPANS``)."""

from fpbench.program_trace import host_prep_idle_pct


def read(r):
    return host_prep_idle_pct(r.program)
