"""Device ms a batch of the kernels and copies launched inside the
program's span ``screen.stage3`` (the rescue's exhaustive scan of the
escalated queries, and its top-1) in the traced window."""

from fpbench.program_trace import device_ms


def read(r):
    return device_ms(r.program, "screen.stage3", r.batches)
