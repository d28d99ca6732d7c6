"""Host ms a batch inside the program's span ``db.filters``
(``Database._filters``' per-query loop, which builds the batch's filter
array) in the traced window."""

from fpbench.program_trace import host_ms


def read(r):
    return host_ms(r.program, "db.filters", r.batches)
