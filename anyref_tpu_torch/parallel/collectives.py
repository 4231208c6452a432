"""Collectives that autograd differentiates, for training on a mesh
(parallel/mesh.py).

Megatron's pair for a tensor-parallel block over "model":
``copy_to_group`` at the input of a column-parallel product (identity
forward, the gradient summed over the group backward: each rank's block of
output features gives a partial gradient at the shared input) and
``reduce_from_group`` at the output of a row-parallel product, the
vocabulary-parallel embedding and logits, and rephrase's head sum
(all-reduce-sum forward, identity backward: the gradient at the sum is the
same on every rank). ``torch.distributed.nn.functional.all_reduce`` is not
the second: its backward sums the incoming gradient over the group again,
which counts a replicated gradient once per rank.

Over "data", ``reduce_from_group`` sums a loss's numerator and its count
(ops/losses.py), so that the loss is the global batch's mean and each
rank's backward gives its rows' share of the global gradient;
``all_reduce_grads`` then sums the gradients, in fp32, rounding once to
each leaf's dtype (the compiled step of a data mesh sums the same buckets
of its fp32 gradient buffer in place between two graphs: train/step.py).

With autograd off (serving under ``torch.inference_mode``, the frozen
towers under ``torch.no_grad``) ``reduce_from_group`` all-reduces in place
and ``copy_to_group`` returns its input, as the serving path always did.
A None group is the axis of size 1: both return their input.

Every sum over a "model" group (one that parallel/mesh.py ``make_mesh``
registered with the all-reduce op) goes through ops/flash.py
``all_reduce``: on the card the kernel of csrc/all_reduce.cu, which a CUDA
graph captures, on the CPU its plain version over the group. Sums over
"data" go through torch.distributed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash

# elements an all_reduce_grads call sums at once (256 MiB of fp32)
BUCKET_ELEMENTS = 1 << 26


def _sum(x, group):
    """``x`` summed over ``group``, a new contiguous tensor: the
    all-reduce op for a "model" group, torch.distributed for any other."""
    key = flash.group_key(group)
    if key is not None:
        return flash.all_reduce(x, key)
    total = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, group=group)
    return total


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = _sum(grad.to(torch.promote_types(grad.dtype, torch.float32)),
                     ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, group):
    """``x`` unchanged; under autograd, its gradient summed over ``group``
    (in fp32, rounded once to the gradient's dtype)."""
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """``x`` summed over ``group``; under autograd a new tensor whose
    gradient passes to ``x`` unchanged, else ``x`` summed in place."""
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return x.copy_(_sum(x, group))
    return _ReduceFromGroup.apply(x, group)


def buckets(sizes: list) -> list:
    """(first, end) index ranges of consecutive tensors of ``sizes``
    elements, each summing to at most BUCKET_ELEMENTS (a larger tensor
    alone): the buckets of ``all_reduce_grads``."""
    out, first, size = [], 0, 0
    for i, n in enumerate(sizes):
        if i > first and size + n > BUCKET_ELEMENTS:
            out.append((first, i))
            first, size = i, 0
        size += n
    if first < len(sizes):
        out.append((first, len(sizes)))
    return out


@torch.no_grad()
def all_reduce_grads(grads: list, group, scale: float = 1.0) -> list:
    """Each tensor of ``grads`` summed over ``group`` and multiplied by
    ``scale``: the tensors are flattened into fp32 buckets of at most
    BUCKET_ELEMENTS, one all-reduce each, and each sum rounded once to its
    tensor's dtype. Returns new tensors in order (the inputs where the
    group is None and the scale 1)."""
    if group is None and scale == 1.0:
        return list(grads)
    out = []
    for a, b in buckets([g.numel() for g in grads]):
        bucket = grads[a:b]
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        if group is not None:
            flat = _sum(flat, group)
        if scale != 1.0:
            flat.mul_(scale)
        out.extend(part.view(g.shape).to(g.dtype) for g, part in
                   zip(bucket, flat.split([g.numel() for g in bucket])))
    return out
