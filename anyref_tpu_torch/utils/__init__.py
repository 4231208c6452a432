"""Runtime utilities: timing, stdout-tee logging, profiler hooks (port of
anyref_tpu/utils)."""

from .logging import Logger, ProgressTimer, Timer
from .profiling import annotate, trace

__all__ = ["Logger", "Timer", "ProgressTimer", "trace", "annotate"]
