"""Tracing and timing helpers (port of ``pfann_tpu/utils/profiling.py``).

``stage_timer`` logs the '<name> N.NNNNNNs' lines that ``tools/stat.py``
aggregates (the reference's wall-clock logs).  ``device_trace`` wraps a
region in ``torch.profiler`` with the CPU and CUDA activities (CUDA where
a card is visible) and writes a Chrome trace (Perfetto,
chrome://tracing) into ``log_dir``; ``annotate`` names a region inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from pfann_tpu_torch.utils.logging import get_logger


@contextlib.contextmanager
def stage_timer(name: str):
    """Logs '<name> N.NNNNNNs' in the format tools/stat.py aggregates."""
    t0 = time.time()
    yield
    get_logger().info("%s %.6fs", name, time.time() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str = "profiles", enabled: bool = True):
    """torch.profiler around a region; yields the profiler (None when
    disabled) and, on exit, writes ``log_dir/trace_<pid>_<ns>.json``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


def annotate(name: str):
    """A named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
