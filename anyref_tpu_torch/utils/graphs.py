"""CUDA graph programs: the port's counterpart of a jitted function whose
loop runs on the device (the reference's ``jax.jit`` of a function holding
a ``lax.while_loop`` or a ``lax.scan``).

A program is three graphs captured by PyTorch into one memory pool (the
part before the loop, one loop body, the part after it) and stitched by
``csrc/graph_loop.cu`` into prefix -> WHILE { body } -> suffix, the loop's
predicate set on the device by a one-warp condition kernel: ``i < bound``
of the carry's int32 position ``i``, and, where the carry has done flags,
while some flag is unset. ``GraphPool`` holds one owner's pool and capture
stream (eval/runner.py's Predictor, train/trainer.py's Trainer): all its
programs share the pool, which holds its memory for the owner's life, and
replay in turn on one stream. Captures run on a side stream in
``thread_local`` error mode, so another thread's launches on its own
stream (a loader's mel front end) do not invalidate them; a capture or a
launch that fails raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import flash


class GraphProgram(NamedTuple):
    """One key's captured program: its static input buffers, its static
    outputs, the captured graphs (prefix, loop body, suffix: PyTorch's,
    which hold the pool), the instantiated program (a cudaGraphExec_t of
    csrc/graph_loop.cu) and the seconds the capture took. The carry lives
    in the pool only while the program runs: each run's prefix writes it
    before the loop reads it, so later captures in the pool may reuse its
    memory. A program in two parts (train/trainer.py on a data mesh) also
    has ``between``, the host's work after ``exec`` (the data sum of the
    gradients and the metrics, in place on the carry, which it keeps, and
    on the outputs), and ``then``, one more graph of the pool replayed
    after it; a run is ``run``."""
    inputs: dict
    outputs: tuple
    graphs: tuple
    exec: int
    capture_s: float
    between: Optional[Callable] = None
    then: Optional[torch.cuda.CUDAGraph] = None

    def run(self, pool: "GraphPool") -> torch.cuda.Stream:
        """One run on the current stream, which it returns: the program,
        then ``between`` and ``then`` where there are."""
        stream = pool.launch(self.exec)
        if self.between is not None:
            self.between()
            self.then.replay()
        return stream


class GraphPool:
    """The graph memory pool and capture stream of one owner on
    ``device``, both made at its first capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = None
        self.stream = None

    def capture(self, fn: Callable):
        """(graph, fn's result): ``fn`` captured into a kept graph in the
        pool. A capture records kernels and their launch counts and runs
        none."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return g, out

    def graph(self, fn: Callable):
        """(graph, fn's result): ``fn`` captured alone into an instantiated
        graph in the pool, replayed with its ``replay``."""
        g, out = self.capture(fn)
        g.instantiate()
        return g, out

    def program(self, graphs: tuple, i: torch.Tensor,
                done: Optional[torch.Tensor], bound: int) -> int:
        """The instantiated program (a cudaGraphExec_t) of the captured
        (prefix, body, suffix) ``graphs``: the body runs while ``i`` (the
        carry's 0-d int32 position) < ``bound`` and, with ``done`` (bool
        flags), some flag is unset. Destroyed with ``graphs[0]``."""
        handle = ctypes.c_void_p()
        flash._launch("anyref_graph_program",
                      *(g.raw_cuda_graph() for g in graphs), i.data_ptr(),
                      None if done is None else done.data_ptr(),
                      0 if done is None else done.numel(), bound,
                      flash.launch_counter("loop_condition",
                                           self.device).data_ptr(),
                      ctypes.byref(handle))
        weakref.finalize(graphs[0], flash._library().anyref_graph_destroy,
                         handle.value)
        return handle.value

    def launch(self, exec_: int) -> torch.cuda.Stream:
        """One run of a program on the current stream, which it returns."""
        stream = torch.cuda.current_stream(self.device)
        flash._launch("anyref_graph_launch", exec_, stream.cuda_stream)
        return stream

    def bytes(self) -> int:
        """Device bytes the pool holds (0 before the first capture)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg["segment_pool_id"]) == pool)


def stage(inputs: dict, host: dict) -> None:
    """Copy ``host``'s numpy arrays into the static ``inputs`` through
    pinned memory, on the current stream, without waiting. A pinned buffer
    may be dropped as soon as its copy is queued: the pinned allocator
    reuses it only once the copy's event completed."""
    for k, v in host.items():
        dst = inputs[k]
        if tuple(dst.shape) != v.shape:
            raise ValueError(f"{k}: {v.shape} for a program of "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(v).pin_memory(), non_blocking=True)

