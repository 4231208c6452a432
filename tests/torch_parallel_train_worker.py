"""Rank bodies for tests/test_torch_parallel_train.py: the port's training
on a mesh of CPU ranks over gloo, one spawned process a rank, started by
tests/torch_parallel_worker.py ``run_ranks("tests.torch_parallel_train_
worker:mesh_task", ...)``. Imports no JAX.

Everything crosses the process boundary as numpy (a CPU tensor in a
multiprocessing queue is a shared-memory handle that dies with its
sender).
"""

from __future__ import annotations

import contextlib

import numpy as np

TASK = "tests.torch_parallel_train_worker:mesh_task"


def _np(tree):
    """A tree of tensors as numpy (fp32 for floats), None kept."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def _tensors(tree):
    import torch
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _cfg(rephrase: float = 0.0):
    from anyref_tpu_torch.config import anyref_tiny
    return anyref_tiny().scaled(rephrase_weight=rephrase)


def _rows(batch: dict, mesh, accum: int) -> dict:
    """This rank's rows of a global batch ([B, ...], or [accum, B, ...])."""
    from anyref_tpu_torch.parallel.mesh import DATA_AXIS
    from anyref_tpu_torch.parallel.partition import local_block
    spec = (DATA_AXIS,) if accum == 1 else (None, DATA_AXIS)
    return {k: local_block(np.asarray(v), spec, mesh) for k, v in
            batch.items()}


def _trainables(sp, lora_full, mesh):
    """(lora blocks, dense blocks, frozen) of a sharded tree, the
    trainables fresh leaves that require grad."""
    from anyref_tpu_torch.parallel.partition import lora_spec, shard_tree
    from anyref_tpu_torch.train import lora as lora_mod
    from anyref_tpu_torch.train.step import tree_leaves, tree_map
    lora_p = shard_tree(_tensors(lora_full), lora_spec(lora_full), mesh)
    dense, frozen = lora_mod.split_trainable(sp)
    lora_p, dense = (tree_map(lambda t: t.detach().clone(), t)
                     for t in (lora_p, dense))
    for t in tree_leaves((lora_p, dense)):
        t.requires_grad_(True)
    return lora_p, dense, frozen


def _grads(sp, mesh, lora_full, batch, accum, rephrase, remat):
    """Loss, metrics and the reduced gradient (gathered to whole leaves) of
    this rank's value_and_grad on its rows of ``batch``."""
    from anyref_tpu_torch.parallel.partition import (gather_tree,
                                                     trainable_spec)
    from anyref_tpu_torch.train import lora as lora_mod
    from anyref_tpu_torch.train import step
    lora_p, dense, frozen = _trainables(sp, lora_full, mesh)
    with record_seg_states() as seg:
        loss, metrics, grads = step.value_and_grad(
            lora_p, dense, frozen, _cfg(rephrase), lora_mod.LoraConfig(),
            _rows(batch, mesh, accum), encoder_path="fused", remat=remat,
            mesh=mesh, grad_accum=accum)
    whole = gather_tree(list(grads), trainable_spec(grads), mesh)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np(whole), "seg": seg}


@contextlib.contextmanager
def record_seg_states():
    """The [SEG] states entering text_hidden_fcs (anyref.project_seg_hidden)
    of each forward inside the block, fp32 numpy, in order."""
    from anyref_tpu_torch.models import anyref
    inner, got = anyref.project_seg_hidden, []

    def project(params, hidden):
        got.append(hidden.detach().float().numpy().copy())
        return inner(params, hidden)
    anyref.project_seg_hidden = project
    try:
        yield got
    finally:
        anyref.project_seg_hidden = inner


def _mlp_check(mesh):
    """A column -> row-parallel MLP, y = relu(copy(x) @ W1) @ W2 summed
    over "model", loss = sum(y * c): this rank's gradients of x, W1's
    block and W2's block against the single rank's on the whole weights
    (computed here, without collectives). Returns the largest relative
    errors."""
    import torch
    from anyref_tpu_torch.parallel.collectives import (copy_to_group,
                                                       reduce_from_group)
    from anyref_tpu_torch.parallel.mesh import MODEL_AXIS
    from anyref_tpu_torch.parallel.partition import local_block
    g = torch.Generator().manual_seed(3)
    x, w1, w2, c = (torch.randn(s, generator=g, dtype=torch.float64)
                    for s in ((5, 8), (8, 12), (12, 8), (5, 8)))

    def run(x, w1, w2, group):
        x, w1, w2 = (t.clone().requires_grad_(True) for t in (x, w1, w2))
        y = torch.relu(copy_to_group(x, group) @ w1) @ w2
        (reduce_from_group(y, group) * c).sum().backward()
        return x.grad, w1.grad, w2.grad

    whole = run(x, w1, w2, None)
    col, row = (None, MODEL_AXIS), (MODEL_AXIS, None)
    mine = run(x, local_block(w1, col, mesh), local_block(w2, row, mesh),
               mesh.group(MODEL_AXIS))
    want = (whole[0], local_block(whole[1], col, mesh),
            local_block(whole[2], row, mesh))
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(mine, want)]


def _adamw(sp, mesh, lora_full, grads_list):
    """The sharded AdamW (warmup 0, lr 1e-2, clip 1.0) over the updates
    of ``grads_list`` (whole (lora, dense) gradient trees), cut into this
    rank's blocks; returns the gathered params, mu and nu."""
    import torch
    from anyref_tpu_torch.parallel.partition import (gather_tree, shard_tree,
                                                     trainable_spec)
    from anyref_tpu_torch.train import step
    lora_p, dense, _ = _trainables(sp, lora_full, mesh)
    params = (lora_p, dense)
    spec = trainable_spec(params)
    opt = step.make_optimizer(lr=1e-2, warmup=0, total_steps=3)
    state = opt.init(params)
    for g in grads_list:
        blocks = shard_tree(_tensors(g), spec, mesh)
        updates, state = opt.update(blocks, state, params, mesh)
        with torch.no_grad():
            for p, u in zip(step.tree_leaves(params),
                            step.tree_leaves(updates)):
                p.add_(u)
    return {k: _np(gather_tree(list(t), spec, mesh)) for k, t in
            (("params", params), ("mu", state.mu), ("nu", state.nu))}


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _trainer(tree, samples, out, mesh=None, **tc_kw):
    """A Trainer run on ``samples``; returns the gathered end state (rank 0)
    and the state it started from after a resume."""
    import torch
    from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
    tc = TrainConfig(output_dir=out, grad_accum_steps=1, warmup_steps=1,
                     save_steps=1, log_steps=1, learning_rate=1e-3,
                     remat=True, encoder_path="fused", **tc_kw)
    trainer = Trainer(_cfg(), tc, torch.load(tree), dataset=ListDataset(
        samples), device="cpu", mesh=mesh)
    start = trainer.gathered_state()
    start = {"step": start.step, "lora": _np(start.lora),
             "mu": _np(start.opt_state.mu)}
    trainer.train()
    end = trainer.gathered_state()
    return {"start": start, "step": end.step, "lora": _np(end.lora),
            "dense": _np(end.dense), "mu": _np(end.opt_state.mu),
            "nu": _np(end.opt_state.nu),
            "mesh": dict(trainer.mesh.shape), "writer": trainer.writer,
            "batch_size": trainer.loader.batch_size,
            "shard": (trainer.loader.process_index,
                      trainer.loader.process_count)}


def mesh_task(rank, data, model, tree, lora, batches, grad_cases=(),
              adamw=None, mlp=False, trainers=()):
    """On the (data, model) mesh: ``grad_cases`` [(name, accum, rephrase,
    remat)], value_and_grad on this rank's rows of ``batches[accum]``;
    ``adamw``, a list of whole gradient trees for _adamw; ``mlp``, the
    autograd collectives' check; ``trainers`` [(name, kwargs of _trainer)]
    in order. Whole trees come back from rank 0 only."""
    import torch
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_params
    mesh = make_mesh(data, model, device="cpu")
    sp = shard_params(torch.load(tree), mesh, _cfg())
    out = {"coords": dict(mesh.coords)}
    for name, accum, rephrase, remat in grad_cases:
        out[name] = _grads(sp, mesh, lora, batches[accum], accum, rephrase,
                           remat)
    if adamw is not None:
        out["adamw"] = _adamw(sp, mesh, lora, adamw)
    if mlp:
        out["mlp"] = _mlp_check(mesh)
    for name, kw in trainers:
        out[name] = _trainer(tree, mesh=None if kw.pop("own_mesh", False)
                             else mesh, **kw)
    if rank != 0:   # whole trees from rank 0 only
        out = {k: ({"loss": v["loss"], "metrics": v["metrics"],
                    "seg": v["seg"]}
                   if isinstance(v, dict) and "grads" in v else
                   {"step": v["step"], "writer": v["writer"],
                    "shard": v["shard"], "mesh": v["mesh"]}
                   if isinstance(v, dict) and "writer" in v else v)
               for k, v in out.items() if k not in ("adamw",)}
    return out
