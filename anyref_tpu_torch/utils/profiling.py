"""Profiler hooks (port of anyref_tpu/utils/profiling.py on torch.profiler).

``trace`` records a region with torch.profiler (host ops, and the CUDA
kernels where a CUDA device exists) and writes a Chrome trace
(chrome://tracing, Perfetto) into a directory; ``annotate`` names a region
inside a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; on exit write ``log_dir/trace-<ns>.json``. Yields
    the profiler, whose ``key_averages()`` summarises the region."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def annotate(name: str):
    """A named region of a trace, as a context manager or a decorator."""
    return record_function(name)
