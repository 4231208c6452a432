"""The training step (port of anyref_tpu/train/step.py, one device).

Optimizer: AdamW after clipping by the global norm, with a linear warmup
then a linear decay to zero, computed as optax computes
``chain(clip_by_global_norm(1.0), adamw(schedule))``: the schedule is read
at the step count *before* it is raised (so the first update uses lr(0),
which is 0), and a clipped gradient is ``g / norm * max_norm`` (no epsilon
in the norm, unlike ``torch.nn.utils.clip_grad_norm_``). Trainables: the
LoRA adapters and the dense ``modules_to_save`` set (train/lora.py); they
are updated in place. ``remat`` checkpoints each decoder layer where the
reference checkpoints its whole loss with a policy that keeps the matmul
outputs: here only the layer inputs are kept and each layer is recomputed
in the backward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import AnyRefConfig
from ..models import anyref
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


class OptState(NamedTuple):
    count: int      # updates made so far
    mu: tuple       # first moments, a (lora, dense) tree
    nu: tuple       # second moments


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
        zeros = tree_map(torch.zeros_like, params)
        return OptState(0, zeros, tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """(updates, new state); updates are added to params by the caller.
        All on the device the tensors live on, no host sync."""
        if self.grad_clip:
            norm = torch.sqrt(sum((g.float() * g.float()).sum()
                                  for g in tree_leaves(grads)))
            keep = norm < self.grad_clip
            grads = tree_map(lambda g: torch.where(
                keep, g, g / norm.to(g.dtype) * self.grad_clip), grads)
        count = state.count + 1
        # bias corrections in fp32, as optax computes them
        bc1 = float(1 - np.float32(B1) ** count)
        bc2 = float(1 - np.float32(B2) ** count)
        mu = tree_map(lambda g, m: (1 - B1) * g + B1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - B2) * (g * g) + B2 * v, grads,
                      state.nu)
        lr = float(self.schedule(state.count))

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            return u * -lr
        return tree_map(upd, mu, nu, params), OptState(count, mu, nu)


def warmup_decay_schedule(lr: float, warmup: int, total_steps: int):
    """optax join_schedules of linear_schedule(0, lr, warmup) and
    linear_schedule(lr, 0, total_steps - warmup) at ``warmup``."""
    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(0.0, lr, warmup, count)
        return linear(lr, 0.0, total_steps - warmup, count - warmup)
    return schedule


def make_optimizer(lr: float = 5e-5, warmup: int = 200,
                   total_steps: int = 10_000, weight_decay: float = 0.0,
                   grad_clip: float | None = 1.0) -> AdamW:
    return AdamW(warmup_decay_schedule(lr, warmup, total_steps),
                 weight_decay=weight_decay, grad_clip=grad_clip)


def init_state(generator: torch.Generator, params: dict,
               lora_cfg: lora_mod.LoraConfig,
               optimizer: AdamW) -> tuple[TrainState, dict]:
    """Returns (state, frozen_params). The dense trainables are copied, so
    training never writes into ``params``; the frozen leaves are shared."""
    lora_params = lora_mod.init(generator, params["llama"], lora_cfg)
    dense, frozen = lora_mod.split_trainable(params)
    dense = tree_map(lambda t: t.detach().clone(), dense)
    for t in tree_leaves((lora_params, dense)):
        t.requires_grad_(True)
    opt_state = optimizer.init((lora_params, dense))
    return TrainState(0, lora_params, dense, opt_state), frozen


def loss_fn(lora_params: dict, dense: dict, frozen: dict, cfg: AnyRefConfig,
            lora_cfg: lora_mod.LoraConfig, batch: dict,
            encoder_path: str = "fused", remat: bool = False):
    params = lora_mod.merge_params(dense, frozen)
    params = {**params,
              "llama": lora_mod.apply(params["llama"], lora_params, lora_cfg)}
    out = anyref.train_forward(params, cfg, batch, encoder_path=encoder_path,
                               remat=remat)
    metrics = {k: getattr(out, k).detach() for k in METRICS}
    return out.loss, metrics


def value_and_grad(lora_params: dict, dense: dict, frozen: dict,
                   cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                   batch: dict, encoder_path: str = "fused",
                   remat: bool = False):
    """(loss, metrics, grads) with grads a (lora, dense) tree; a trainable
    the loss does not reach gets a zero gradient."""
    params = (lora_params, dense)
    leaves = tree_leaves(params)
    loss, metrics = loss_fn(lora_params, dense, frozen, cfg, lora_cfg, batch,
                            encoder_path, remat)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def fill(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g
    return loss.detach(), metrics, tree_map(fill, params)


def make_train_step(cfg: AnyRefConfig, lora_cfg: lora_mod.LoraConfig,
                    optimizer: AdamW, remat: bool = True, grad_accum: int = 1,
                    encoder_path: str = "fused"):
    """One optimizer step: ``train_step(state, frozen, batch) -> (state,
    metrics)``. With ``grad_accum`` > 1 the batch carries a leading
    micro-step axis ([accum, B, ...], stack_microbatches); gradients are
    summed over micro-steps and divided by ``grad_accum`` before the single
    update, and the metrics are averaged."""
    def grads_of(state, frozen, batch):
        _, metrics, grads = value_and_grad(state.lora, state.dense, frozen,
                                           cfg, lora_cfg, batch, encoder_path,
                                           remat)
        return metrics, grads

    def train_step(state: TrainState, frozen: dict, batch: dict):
        if grad_accum == 1:
            metrics, grads = grads_of(state, frozen, batch)
        else:
            grads = metrics = None
            for i in range(grad_accum):
                m, g = grads_of(state, frozen,
                                {k: v[i] for k, v in batch.items()})
                grads = g if grads is None else tree_map(torch.add, grads, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in m}
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        params = (state.lora, state.dense)
        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u)
        return TrainState(state.step + 1, state.lora, state.dense,
                          opt_state), metrics

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
