"""A lock between processes, for builds into a shared directory."""

from __future__ import annotations

import contextlib
import fcntl
from pathlib import Path


@contextlib.contextmanager
def file_lock(path: Path):
    """Hold an exclusive ``flock`` on ``path`` (created if missing) for the
    body: a second process waits at the door until the first leaves it or
    dies (the kernel drops the lock with the process, so a killed build
    leaves none behind)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
