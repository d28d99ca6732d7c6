"""The 95th percentile of every batch's time in the window, from the call
until its top-1 answers are on the host (host clock)."""

import numpy as np


def read(r):
    return float(np.percentile(np.asarray(r.latencies) * 1e3, 95))
