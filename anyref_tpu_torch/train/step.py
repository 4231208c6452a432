"""The training step (port of anyref_tpu/train/step.py).

Optimizer: AdamW after clipping by the global norm, with a linear warmup
then a linear decay to zero, computed as optax computes
``chain(clip_by_global_norm(1.0), adamw(schedule))``: the schedule is read
at the step count *before* it is raised (so the first update uses lr(0),
which is 0), and a clipped gradient is ``g / norm * max_norm`` (no epsilon
in the norm, unlike ``torch.nn.utils.clip_grad_norm_``). The count is a
0-d int32 tensor beside the trainables; the schedule and the bias
corrections are computed from it on the device, in fp32, so an update reads
nothing back. Trainables: the LoRA adapters and the dense
``modules_to_save`` set (train/lora.py). ``remat`` checkpoints each decoder
layer where the reference checkpoints its whole loss with a policy that
keeps the matmul outputs: here only the layer inputs are kept and each
layer is recomputed in the backward.

A step is a program in the form of the reference's jitted step, whose
micro-steps are one ``lax.scan`` body (``StepProgram``): a prefix that
zeroes the fp32 gradient and metric sums of a carry, a body that runs
micro-step ``i`` of the stacked batch (picked on the device by the carry's
``i``) and adds into the carry, and a suffix that averages, clips, runs the
optimizer and writes the trainables and the optimizer state in place (the
counterpart of the reference's donated state). None of it reads the device
or uploads host data, so the same program runs from the host
(``make_train_step``) or, on a CUDA device, captured into one CUDA graph
with the body a WHILE node (train/trainer.py).

On a mesh (parallel/mesh.py; one process a rank) a step computes what the
reference's single-device step computes on the global batch, the union of
the "data" ranks' rows in rank order: the decoder and its trainables are
Megatron blocks over "model" (parallel/partition.py ``shard_params``,
``trainable_spec``), the loss terms the global batch's means (ops/losses.py),
and each rank's gradient its rows' share. ``value_and_grad`` then sums
LoRA's replicated a over "model" (each model rank's gradient of a comes
from its block of the adapted columns) and every leaf over "data", in fp32,
rounding once to the leaf's dtype; the replicated leaves downstream of the
decoder's last sum (text_hidden_fcs, the mask decoder, loc_embeddings) and
those whose gradient reaches them through the whole residual stream
(roi_embed, audio_projector) already hold the whole gradient on every model
rank. The Adam moments live on the blocks, and the clipping norm sums the
sharded leaves' squares over "model" and counts the replicated ones once.
On a mesh of several "data" ranks the micro-steps hold no collective over
"data": the host stages each micro-step's global loss counts with the
batch, each rank's loss terms are its shares of the global means (the
same gradients bit for bit), and the data sum of the gradients and the
metrics runs between the gradient part and the update, issued by the host,
so that each part is captured as a graph on every rank. The sums over
"model" (the decoder's and its backward's, LoRA's a, the clipping norm)
stay inside the parts: on the card they are launches of the all-reduce
kernel (parallel/collectives.py), which a graph holds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import AnyRefConfig
from ..models import anyref
from ..parallel.collectives import (all_reduce_grads, buckets,
                                   reduce_from_group)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.partition import trainable_spec
from . import lora as lora_mod

METRICS = ("lm_loss", "bce_loss", "dice_loss", "loss")
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


def tree_leaves(tree) -> list:
    """Tensor leaves of a tree of dicts, lists and tuples, in order; None
    entries are empty subtrees."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of ``tree`` and the matching leaves of
    ``rest``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def sharded_leaves(tree, spec) -> list:
    """For each tensor leaf of ``tree`` (tree_leaves' order), whether its
    partition spec names an axis."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [f for k, v in tree.items() for f in sharded_leaves(v, spec[k])]
    if isinstance(tree, (list, tuple)):
        return [f for v, sp in zip(tree, spec) for f in sharded_leaves(v, sp)]
    return [any(spec)]


class OptState(NamedTuple):
    count: torch.Tensor     # updates made so far: 0-d int32 on the device
    mu: tuple               # first moments, a (lora, dense) tree
    nu: tuple               # second moments


class TrainState(NamedTuple):
    step: int
    lora: dict
    dense: dict     # trainable dense subtree (modules_to_save), None elsewhere
    opt_state: OptState


class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay=weight_decay))`` on trees of tensors."""

    def __init__(self, schedule, weight_decay: float = 0.0,
                 grad_clip: float | None = 1.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params) -> OptState:
        leaves = tree_leaves(params)
        count = torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None)
        return OptState(count, tree_map(torch.zeros_like, params),
                        tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params, mesh=None):
        """(updates, new state); updates are added to params by the caller.
        All on the device the tensors live on, the count's arithmetic
        included: nothing is read back. ``mesh``: the trees are a (lora,
        dense) pair of this rank's blocks, and the clipping norm is the
        whole tree's."""
        if self.grad_clip:
            squares = [(g.float() * g.float()).sum()
                       for g in tree_leaves(grads)]
            group = None if mesh is None else mesh.group(MODEL_AXIS)
            if group is None:
                total = sum(squares)
            else:
                sharded = sharded_leaves(grads, trainable_spec(grads))
                total = reduce_from_group(
                    sum(q for q, b in zip(squares, sharded) if b), group) \
                    + sum(q for q, b in zip(squares, sharded) if not b)
            norm = torch.sqrt(total)
            keep = norm < self.grad_clip
            grads = tree_map(lambda g: torch.where(
                keep, g, g / norm.to(g.dtype) * self.grad_clip), grads)
        count = state.count + 1
        bc1 = 1 - _decay_power(B1, count)
        bc2 = 1 - _decay_power(B2, count)
        mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads,
                      state.nu)
        step_size = -self.schedule(state.count)

        def upd(m, v, p):
            # optax divides by the corrections, and scales by the step
            # size, in the moment's dtype
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                         + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return u * step_size.to(u.dtype)
        return tree_map(upd, mu, nu, params), OptState(count, mu, nu)


def _decay_power(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``decay ** count`` (an fp32 decay, an int32 count) in fp32:
    the power taken in fp64 and rounded once; XLA's fp32 power, which
    optax runs, is within an ulp of it."""
    return torch.pow(float(np.float32(decay)), count.double()).float()


def warmup_decay_schedule(lr: float, warmup: int, total_steps: int):
    """optax join_schedules of linear_schedule(0, lr, warmup) and
    linear_schedule(lr, 0, total_steps - warmup) at ``warmup``, of a count
    (a 0-d int32 tensor, or an int): a 0-d fp32 tensor on the count's
    device, computed as optax computes it."""
    def linear(init, end, steps, count):
        if steps <= 0:
            return torch.full((), init, dtype=torch.float32,
                              device=count.device)
        frac = 1 - torch.clamp(count, 0, steps) / steps
        return frac * (init - end) + end

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        return torch.where(count < warmup, linear(0.0, lr, warmup, count),
                           linear(lr, 0.0, total_steps - warmup,
                                  count - warmup))
    return schedule


def make_optimizer(lr: float = 5e-5, warmup: int = 200,
                   total_steps: int = 10_000, weight_decay: float = 0.0,
                   grad_clip: float | None = 1.0) -> AdamW:
    return AdamW(warmup_decay_schedule(lr, warmup, total_steps),
                 weight_decay=weight_decay, grad_clip=grad_clip)


def _check_mesh(params_llama: dict, cfg: AnyRefConfig, mesh) -> None:
    group = None if mesh is None else mesh.group(MODEL_AXIS)
    if group is not None and (params_llama["embed_tokens"].shape[0]
                              * mesh.shape[MODEL_AXIS]
                              != cfg.llama.padded_vocab_size):
        raise ValueError("a mesh with a model axis takes the tree of "
                         "parallel.partition.shard_params")


def init_state(generator: torch.Generator, params: dict,
               lora_cfg: lora_mod.LoraConfig,
               optimizer: AdamW) -> tuple[TrainState, dict]:
    """Returns (state, frozen_params). The dense trainables are copied, so
    training never writes into ``params``; the frozen leaves are shared.
    On this rank's blocks of a tree (``shard_params``) the state is the
    single device's cut into blocks: the draw of LoRA's a does not depend
    on the blocks, and b's zeros are the rank's block."""
    lora_params = lora_mod.init(generator, params["llama"], lora_cfg)
    dense, frozen = lora_mod.split_trainable(params)
    dense = tree_map(lambda t: t.detach().clone(), dense)
    for t in tree_leaves((lora_params, dense)):
        t.requires_grad_(True)
    opt_state = optimizer.init((lora_params, dense))
    return TrainState(0, lora_params, dense, opt_state), frozen


def loss_fn(lora_params: dict, dense: dict, frozen: dict, cfg: AnyRefConfig,
            lora_cfg: lora_mod.LoraConfig, batch: dict,
            encoder_path: str = "fused", remat: bool = False, mesh=None):
    params = lora_mod.merge_params(dense, frozen)
    params = {**params,
              "llama": lora_mod.apply(params["llama"], lora_params, lora_cfg)}
    out = anyref.train_forward(params, cfg, batch, encoder_path=encoder_path,
                               remat=remat, mesh=mesh)
    metrics = {k: getattr(out, k).detach() for k in METRICS}
    return out.loss, metrics


def sum_replicated(grads: list, trainables, mesh) -> None:
    """Sum the gradients of LoRA's replicated leaves (a) among ``grads``
    (fp32, in the order of this rank's (lora, dense) ``trainables``) over
    "model", in place: each model rank's gradient of a comes from its
    block of the adapted columns. No-op without a "model" axis."""
    group = None if mesh is None else mesh.group(MODEL_AXIS)
    if group is None:
        return
    n_lora = len(tree_leaves(trainables[0]))
    partial = [i for i, sharded in enumerate(
        sharded_leaves(trainables, trainable_spec(trainables)))
        if i < n_lora and not sharded]
    if partial:
        summed = all_reduce_grads([grads[i] for i in partial], group)
        for i, g in zip(partial, summed):
            grads[i].copy_(g)


def stage_loss_counts(batch: dict, cfg: AnyRefConfig, mesh) -> dict:
    """``batch`` (this rank's rows, arrays or tensors; [B, ...] or [accum,
    B, ...]) with "loss_counts": each micro-step's global counts
    (models/anyref.py ``loss_counts``, [len(LOSS_COUNTS)] or [accum,
    len(LOSS_COUNTS)] fp32), summed over ``mesh.host_group`` on the host
    (each data rank's rows once: its model rank 0's counts). Collective:
    every rank stages its rows of the same step."""
    host = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in batch.items()
            if k in ("input_ids", "labels", "mask_valid")}
    counts = torch.from_numpy(anyref.loss_counts(cfg, host))
    if mesh.coords[MODEL_AXIS] != 0:
        counts.zero_()
    dist.all_reduce(counts, group=mesh.host_group)
    return {**batch, "loss_counts": counts.numpy()}


def _grad_program(lora_params: dict, dense: dict, frozen: dict,
                  cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                  batch: dict, encoder_path: str, remat: bool, mesh,
                  grad_accum: int):
    """(prefix, body, average, reduce, rounded, batch): the gradient part
    of a step's program. ``prefix()`` makes the carry {"i": 0-d int32
    micro-step index, "flat": one fp32 buffer of zeros for every trainable
    leaf's gradient sum, "grads": its views shaped as the leaves,
    "metrics": fp32 zeros [len(METRICS)]}; ``body(carry)`` runs micro-step
    ``i`` (the batch itself where ``grad_accum`` is 1), adds its gradients
    and metrics into the carry's tensors and raises ``i``;
    ``average(carry)`` -> the metrics summed over ``grad_accum``
    micro-steps, over ``grad_accum``; ``reduce(carry, metrics)``, on a mesh
    of several "data" ranks, sums ``carry["flat"]`` (in all_reduce_grads'
    buckets) and the ranks' shares of ``metrics`` over "data" in place
    (issued by the host; None elsewhere); ``rounded(carry)`` -> the
    gradient leaves made the global batch's (LoRA's a summed over "model",
    ``sum_replicated``) over ``grad_accum`` in fp32 and rounded once to
    each leaf's dtype. ``batch`` is the batch as the program reads it:
    tensors on the trainables' device, made here once, on a mesh with
    ``reduce`` staged with its global loss counts first
    (``stage_loss_counts``), so that the micro-steps hold no collective
    over "data"."""
    _check_mesh(dense["llama"], cfg, mesh)
    params = (lora_params, dense)
    leaves = tree_leaves(params)
    dev = leaves[0].device
    data = None if mesh is None else mesh.group(DATA_AXIS)
    split = data is not None
    if split:
        batch = stage_loss_counts(batch, cfg, mesh)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    sizes = [p.numel() for p in leaves]
    starts = np.cumsum([0] + sizes).tolist()

    def prefix() -> dict:
        flat = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        return {"i": torch.zeros((), dtype=torch.int32, device=dev),
                "flat": flat,
                "grads": [part.view(p.shape) for part, p in
                          zip(flat.split(sizes), leaves)],
                "metrics": torch.zeros(len(METRICS), dtype=torch.float32,
                                       device=dev)}

    def body(c: dict) -> dict:
        if grad_accum == 1:
            micro = batch
        else:
            i = c["i"].reshape(1)
            micro = {k: v.index_select(0, i)[0] for k, v in batch.items()}
        loss, m = loss_fn(lora_params, dense, frozen, cfg, lora_cfg, micro,
                          encoder_path, remat, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            for acc, g in zip(c["grads"], grads):
                if g is not None:
                    acc.add_(g)
            c["metrics"].add_(torch.stack([m[k].float() for k in METRICS]))
            c["i"].add_(1)
        return c

    def average(c: dict) -> torch.Tensor:
        return c["metrics"] / grad_accum

    @torch.no_grad()
    def reduce(c: dict, metrics: torch.Tensor) -> None:
        for a, b in buckets(sizes):
            dist.all_reduce(c["flat"][starts[a]:starts[b]], group=data)
        dist.all_reduce(metrics, group=data)

    @torch.no_grad()
    def rounded(c: dict) -> list:
        # all_reduce_grads' arithmetic, in place on the sum
        sum_replicated(c["grads"], params, mesh)
        if grad_accum != 1:
            c["flat"].mul_(1.0 / grad_accum)
        return [g.to(p.dtype) for g, p in zip(c["grads"], leaves)]

    return prefix, body, average, reduce if split else None, rounded, batch


def value_and_grad(lora_params: dict, dense: dict, frozen: dict,
                   cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                   batch: dict, encoder_path: str = "fused",
                   remat: bool = False, mesh=None, grad_accum: int = 1):
    """(loss, metrics, grads) with grads a (lora, dense) tree; a trainable
    the loss does not reach gets a zero gradient. With ``grad_accum`` > 1
    the batch carries a leading micro-step axis ([accum, B, ...],
    stack_microbatches): the gradients are summed over micro-steps in fp32
    and divided by ``grad_accum``, the loss and metrics averaged. On a
    ``mesh`` the batch holds this rank's rows and the trees its blocks; the
    loss and metrics are the global batch's and the gradient of each of
    this rank's leaves the global one. The step program's prefix, body and
    reduce, run from the host."""
    prefix, body, average, reduce, rounded, _ = _grad_program(
        lora_params, dense, frozen, cfg, lora_cfg, batch, encoder_path,
        remat, mesh, grad_accum)
    carry = prefix()
    for _ in range(grad_accum):
        carry = body(carry)
    metrics = average(carry)
    if reduce is not None:
        reduce(carry, metrics)
    grads = iter(rounded(carry))
    metrics = dict(zip(METRICS, metrics.unbind()))
    return (metrics["loss"], metrics,
            tree_map(lambda _: next(grads), (lora_params, dense)))


class StepProgram(NamedTuple):
    """One optimizer step in the form of the reference's jitted step with
    its micro-steps in a ``lax.scan``: ``prefix()`` -> the carry (zeroed
    sums, ``carry["i"]`` the 0-d int32 micro-step index), ``body(carry)``
    one micro-step into the carry, run ``accum`` times (while ``i <
    accum``), ``average(carry)`` -> the step's metrics [len(METRICS)] fp32;
    then ``reduce(carry, metrics)``, where it is not None, the data sum of
    the gradients and the metrics issued by the host (a mesh of several
    "data" ranks), and ``update(carry)``, which rounds the gradients (LoRA's
    a summed over "model"), clips and updates the trainables and the
    optimizer state in place. ``batch``: the device tensors the program reads.
    ``run()`` runs it from the host; train/trainer.py captures it as one
    graph program (prefix, body, ``suffix``) where ``reduce`` is None,
    else as a program (prefix, body, average) and a graph of ``update``,
    ``reduce`` between them."""
    prefix: Callable
    body: Callable
    average: Callable
    reduce: Optional[Callable]
    update: Callable
    accum: int
    batch: dict

    def suffix(self, carry: dict) -> torch.Tensor:
        """``average`` then ``update``: the tail of a step without
        ``reduce``."""
        metrics = self.average(carry)
        self.update(carry)
        return metrics

    def run(self) -> torch.Tensor:
        carry = self.prefix()
        for _ in range(self.accum):
            carry = self.body(carry)
        metrics = self.average(carry)
        if self.reduce is not None:
            self.reduce(carry, metrics)
        self.update(carry)
        return metrics


def step_program(cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                 optimizer: AdamW, state: TrainState, frozen: dict,
                 batch: dict, remat: bool = True, grad_accum: int = 1,
                 encoder_path: str = "fused", mesh=None) -> StepProgram:
    """The step of ``make_train_step`` on ``state`` and ``batch`` as a
    StepProgram. ``update`` adds the updates to the trainables and copies
    the optimizer's new state into ``state.opt_state``'s tensors, so a
    captured program keeps writing the tensors it was captured on."""
    params = (state.lora, state.dense)
    prefix, body, average, reduce, rounded, batch = _grad_program(
        state.lora, state.dense, frozen, cfg, lora_cfg, batch, encoder_path,
        remat, mesh, grad_accum)

    def update(c: dict) -> None:
        grads = iter(rounded(c))
        # the mesh only where there is one: on one device any object with
        # init and update (grads, state, params) serves as the optimizer
        updates, opt_state = optimizer.update(
            tree_map(lambda _: next(grads), params), state.opt_state, params,
            *(() if mesh is None else (mesh,)))
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u)
            for old, new in zip(tree_leaves(state.opt_state),
                                tree_leaves(opt_state)):
                if new is not old:
                    old.copy_(new)

    return StepProgram(prefix, body, average, reduce, update, grad_accum,
                       batch)


def make_train_step(cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                    optimizer: AdamW, remat: bool = True, grad_accum: int = 1,
                    encoder_path: str = "fused", mesh=None):
    """One optimizer step from the host: ``train_step(state, frozen,
    batch) -> (state, metrics)``, the step_program run on the host, the
    returned state holding ``state``'s tensors, updated in place. With
    ``grad_accum`` > 1 the batch carries a leading micro-step axis ([accum,
    B, ...], stack_microbatches); gradients are summed over micro-steps and
    divided by ``grad_accum`` before the single update, and the metrics are
    averaged. ``mesh``: the state holds this rank's blocks and the batch
    its rows (value_and_grad)."""
    def train_step(state: TrainState, frozen: dict, batch: dict):
        metrics = step_program(cfg, lora_cfg, optimizer, state, frozen,
                               batch, remat, grad_accum, encoder_path,
                               mesh).run()
        return (state._replace(step=state.step + 1),
                dict(zip(METRICS, metrics.unbind())))

    return train_step


def stack_microbatches(batches: list) -> dict:
    """Collated batches -> one [accum, B, ...] batch for the accumulating
    train step (host-only keys, with a leading underscore, dropped). A
    reference key that only some micro-batches carry (``ref_images``,
    ``roi_boxes``, ``audio_mels`` and their ``*_valid``) is zeros in the
    others, as the collator fills a row without a reference: no row of
    theirs is valid."""
    keys = list(dict.fromkeys(k for b in batches for k in b
                              if not k.startswith("_")))
    out = {}
    for k in keys:
        like = next(b[k] for b in batches if k in b)
        out[k] = np.stack([b[k] if k in b else np.zeros_like(like)
                           for b in batches])
    return out


def device_batch(batch: dict) -> dict:
    """Drop host-only keys (leading underscore)."""
    return {k: v for k, v in batch.items() if not k.startswith("_")}
