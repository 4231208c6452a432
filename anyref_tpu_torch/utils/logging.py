"""Timing and tee logging (port of anyref_tpu/utils/logging.py)."""

from __future__ import annotations

import sys
import time


class Logger:
    """Tee stdout to a file."""

    def __init__(self, path: str):
        self.terminal = sys.stdout
        self.file = open(path, "a")
        sys.stdout = self

    def write(self, msg):
        self.terminal.write(msg)
        self.file.write(msg)

    def flush(self):
        self.terminal.flush()
        self.file.flush()

    def close(self):
        sys.stdout = self.terminal
        self.file.close()


class Timer:
    """Context-manager wall timer."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed:.3f}s")


class ProgressTimer:
    """ETA estimation over a known iteration count."""

    def __init__(self, total: int):
        self.total = total
        self.start = time.time()
        self.done = 0

    def update(self, n: int = 1) -> str:
        self.done += n
        dt = time.time() - self.start
        rate = self.done / max(dt, 1e-9)
        remain = (self.total - self.done) / max(rate, 1e-9)
        return (f"{self.done}/{self.total} "
                f"({rate:.2f}/s, eta {remain/60:.1f} min)")
