"""Align-reduce kernel launches in the window (the program's counter
``align_reduce.launches``) per batch: 1 for the exhaustive engine, 1 for
the screen's stage 1 plus 1 for each batch its stage 3 rescues."""


def read(r):
    return r.launches / r.batches if r.batches else None
