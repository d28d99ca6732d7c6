"""Multiprocess-safe file logging.

A copy of ``pfann_tpu/utils/logging.py``, so that the port imports
nothing of the JAX package.

Parity target: reference simpleutils.py:72-85 — log files named
``logs/<app>-<YYYYmmdd-HHMMSS>.log`` with ``[time][process/level]`` lines,
and a picklable initializer object usable as a DataLoader-style
``worker_init_fn``.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import os


def get_logger() -> logging.Logger:
    return mp.get_logger()


def init_logger(app_name: str, log_dir: str = "logs") -> None:
    os.makedirs(log_dir, exist_ok=True)
    logger = mp.get_logger()
    logger.setLevel(logging.INFO)
    handler = logging.FileHandler(
        os.path.join(log_dir, "%s.log" % app_name), encoding="utf8"
    )
    handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(processName)s/%(levelname)s] %(message)s")
    )
    logger.addHandler(handler)


class MultiProcessInitLogger:
    """Picklable per-process logger initializer (simpleutils.py:80-85)."""

    def __init__(self, app_name: str, log_dir: str = "logs"):
        date_str = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.log_name = app_name + "-" + date_str
        self.log_dir = log_dir

    def __call__(self, *args) -> None:
        init_logger(self.log_name, self.log_dir)
