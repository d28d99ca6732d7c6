"""Queries answered in the window over the window's seconds (host clock,
first batch sent to the last batch answered that was sent in time)."""


def read(r):
    return (r.attempted - r.failed) / r.window_s
