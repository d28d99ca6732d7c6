"""Device ms a batch of the kernels and copies launched inside the
program's span ``embedder.encoder`` (FpNetwork and the L2 norm) in the
traced window."""

from fpbench.program_trace import device_ms


def read(r):
    return device_ms(r.program, "embedder.encoder", r.batches)
