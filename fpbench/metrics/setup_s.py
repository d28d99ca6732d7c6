"""Process start to the first timed batch: imports, inputs, the DB write,
the program's loaders, the source songs' embedding, warm-up (and, in a
checkout's first run, the kernel's build)."""


def read(r):
    return r.setup_s
