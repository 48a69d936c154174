"""Copy of biokanga_tpu/utils/diagnostics.py: screen/file log + stopwatch.

Parity role: CDiagnostics (libbiokanga/Diagnostics.cpp:145 DiagOut) and
CStopWatch (libbiokanga/StopWatch.cpp) — every subprocess opens a log file
and reports phase timings.
"""
from __future__ import annotations

import logging
import sys
import time


def open_diagnostics(
    log_file: str | None = None, level: int = logging.INFO, name: str = "biokanga-tpu"
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class StopWatch:
    """Phase timer (cf. gStopWatch started per subprocess, biokanga.cpp:132)."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.marks: list[tuple[str, float]] = []

    def mark(self, label: str) -> float:
        t = time.monotonic() - self.t0
        self.marks.append((label, t))
        return t

    def elapsed(self) -> float:
        return time.monotonic() - self.t0
