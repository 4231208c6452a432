"""The dispatch mode of the graph-program tests (tests/test_torch_graph_
program.py, test_torch_train_program.py, the ranks of
test_torch_mesh_program.py): it refuses every op that a CUDA graph capture
cannot hold, so a program run under it on the CPU reads nothing back from
the device and uploads no host data. Imports no JAX."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose output a read of the device decides (a value on the host, or a
# shape that depends on the data), and lift_fresh, which brings host data
# (torch.tensor, from_numpy, a Python value written by index) into the
# program: a CUDA graph capture holds neither
HOST_READS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.is_nonzero.default,
              torch.ops.aten.nonzero.default,
              torch.ops.aten.repeat_interleave.self_Tensor,
              torch.ops.aten.lift_fresh.default}


def _reads(func, args) -> bool:
    if func in (torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
                torch.ops.aten.index_put_.default):
        # integer indices gather on the device; a boolean mask is nonzero
        return any(i is not None and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1])
    return (func in HOST_READS
            or torch.Tag.data_dependent_output in func.tags
            or torch.Tag.dynamic_output_shape in func.tags)


class NoDeviceReads(TorchDispatchMode):
    """Raises on any op that would read the device back to the host or
    copy host data into the program."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _reads(func, args):
            raise AssertionError(f"{func} reads the device")
        return func(*args, **(kwargs or {}))
