"""Logging helpers (copy of vnlb_tpu/utils/logger.py).

``vprint`` prints when VNLB_TPU_VERBOSE is set to a nonzero integer;
``Logger`` tees stdout to a file for sweep scripts.
"""

from __future__ import annotations

import os
import sys

VERBOSE = bool(int(os.environ.get("VNLB_TPU_VERBOSE", "0")))


def vprint(*args, **kwargs):
    if VERBOSE:
        print(*args, **kwargs)


class Logger:
    """Tee stdout to a log file: ``sys.stdout = Logger(path)``."""

    def __init__(self, fname: str):
        self.terminal = sys.stdout
        self.log = open(fname, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()
