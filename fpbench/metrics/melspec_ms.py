"""Device ms a batch of the kernels and copies launched inside the
program's span ``embedder.melspec`` (the int16 scaling, hop unfold,
de-mean and log-mel) in the traced window."""

from fpbench.program_trace import device_ms


def read(r):
    return device_ms(r.program, "embedder.melspec", r.batches)
