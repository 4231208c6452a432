"""Rank bodies for tests/test_torch_model_program.py: the Predictor's request
program and the Trainer's step on meshes with a "model" axis of 2, (1, 2)
and (2, 2), of CPU ranks over gloo, in the form the card captures
(eval/runner.py, train/step.py), one spawned process a rank, started by
tests/torch_parallel_worker.py ``run_ranks(TASK, ...)``. Imports no JAX.

Everything crosses the process boundary as numpy (a CPU tensor in a
multiprocessing queue is a shared-memory handle that dies with its
sender).
"""

from __future__ import annotations

import contextlib

import numpy as np

from tests import torch_parallel_train_worker as TW
from tests.torch_dispatch_modes import NoDeviceReads
from tests.torch_mesh_program_worker import recorded_collectives

TASK = "tests.torch_model_program_worker:model_program_task"
MNT = 6
BUCKET = 257


@contextlib.contextmanager
def recorded_ops():
    """Every call of the all-reduce op (ops/flash.py all_reduce) inside the
    block, in order: a list of its group's ranks."""
    import torch.distributed as dist
    from anyref_tpu_torch.ops import flash
    calls, inner = [], flash.all_reduce

    def all_reduce(x, key):
        calls.append(tuple(dist.get_process_group_ranks(
            flash._GROUPS[key].group)))
        return inner(x, key)
    flash.all_reduce = all_reduce
    try:
        yield calls
    finally:
        flash.all_reduce = inner


@contextlib.contextmanager
def recorded():
    """(torch.distributed's collectives, the all-reduce op's calls) inside
    the block."""
    with recorded_collectives() as calls, recorded_ops() as ops:
        yield calls, ops


def _plain_sums(mesh, rank):
    """torch.library.opcheck of the all-reduce op on this rank (every rank
    of the group runs it at once: "opcheck"); then a draw of this rank's
    own in fp32 and bf16 through the op's plain version and through
    torch.distributed's all_reduce over the "model" group: {dtype: (the
    op's sum's bytes, gloo's)}."""
    import torch
    import torch.distributed as dist
    from anyref_tpu_torch.ops import flash
    group = mesh.group("model")
    key = flash.group_key(group)
    g = torch.Generator().manual_seed(100 + rank)
    result = torch.library.opcheck(torch.ops.anyref.all_reduce.default,
                                   (torch.randn(5, 3, generator=g), key))
    out = {"opcheck": sorted(set(result.values()))}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 77, 129, generator=g).to(dtype)
        got = flash.all_reduce(x, key)
        want = x.clone()
        dist.all_reduce(want, group=group)
        out[str(dtype)] = (got.view(torch.uint8).numpy().copy(),
                           want.view(torch.uint8).numpy().copy())
    return out


def _program_parts(pred, batch):
    """The Predictor's program on this rank's rows of ``batch``: its
    prefix, each decode pass and its suffix under NoDeviceReads and the
    recorders (the host loop's read of the predicate outside both).
    Returns the collectives and op calls of the parts, the meta rows, the
    low-res logits and the pass count."""
    import torch
    from anyref_tpu_torch.parallel.partition import batch_spec, local_block
    host, _, _ = pred._inputs(batch)
    spec = batch_spec(host)
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        local_block(v, spec[k], pred.mesh))) for k, v in host.items()}
    passes, calls, ops = 0, [], []
    with torch.inference_mode():
        with recorded() as (c, o), NoDeviceReads():
            loop, finish = pred._program(dev)
        calls += c
        ops += o
        while True:
            with recorded() as (c, o), NoDeviceReads():
                go = loop.cond(loop.carry)
            calls += c
            ops += o
            if not bool(go):
                break
            with recorded() as (c, o), NoDeviceReads():
                loop.body(loop.carry)
            calls += c
            ops += o
            passes += 1
        with recorded() as (c, o), NoDeviceReads():
            meta, low = finish(loop.carry)
        calls += c
        ops += o
    return {"calls": calls, "ops": ops, "meta": meta.numpy(),
            "low": low.float().numpy(), "passes": passes}


def _serving(tree, mesh, batches):
    """The Predictor's program parts on each batch at ``mesh``."""
    import torch
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.parallel.partition import shard_params
    cfg = TW._cfg()
    sp = shard_params(torch.load(tree), mesh, cfg)
    pred = Predictor(sp, cfg, max_new_tokens=MNT, prompt_buckets=(BUCKET,),
                     batch_buckets=(2,), device="cpu",
                     encoder_path="unfused", mesh=mesh)
    return {kind: _program_parts(pred, batch)
            for kind, batch in batches.items()}


def _training(tree, mesh, lora_full, batch, accum):
    """One step program at ``mesh`` on this rank's rows of ``batch`` from
    ``lora_full``, run part by part as the card captures it: the staging
    (step_program), part A (prefix, the micro-steps, average) under
    NoDeviceReads, the host's reduce, part B (update) under NoDeviceReads,
    each part's collectives and op calls; the gradient the update read
    (this rank's blocks, and gathered to whole leaves), the metrics and the
    [SEG] states of the micro-steps. Then the eager mesh step
    (value_and_grad from the host) on the same rows and LoRA: its metrics
    and gradient."""
    import torch
    from anyref_tpu_torch.parallel.partition import (gather_tree,
                                                     shard_params,
                                                     trainable_spec)
    from anyref_tpu_torch.train import lora as lora_mod
    from anyref_tpu_torch.train import step
    cfg = TW._cfg()
    sp = shard_params(torch.load(tree), mesh, cfg)
    lora_p, dense, frozen = TW._trainables(sp, lora_full, mesh)
    opt = step.make_optimizer(lr=1e-3, warmup=0, total_steps=4)
    state = step.TrainState(0, lora_p, dense, opt.init((lora_p, dense)))
    seen, inner = [], opt.update

    def update(grads, *a, **kw):
        seen.append(step.tree_map(lambda g: g.detach().clone(), grads))
        return inner(grads, *a, **kw)
    opt.update = update
    rows = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            TW._rows(batch, mesh, accum).items()}
    out = {}
    with recorded() as parts:
        program = step.step_program(cfg, lora_mod.LoraConfig(), opt, state,
                                    frozen, rows, remat=False,
                                    grad_accum=accum, encoder_path="fused",
                                    mesh=mesh)
    out["staging"] = parts
    with recorded() as parts, TW.record_seg_states() as seg:
        with NoDeviceReads():
            carry = program.prefix()
        while int(carry["i"]) < program.accum:
            with NoDeviceReads():
                carry = program.body(carry)
        with NoDeviceReads():
            metrics = program.average(carry)
    out["part_a"] = parts
    with recorded() as parts:
        if program.reduce is not None:
            program.reduce(carry, metrics)
    out["between"] = parts
    with recorded() as parts:
        with NoDeviceReads():
            program.update(carry)
    out["part_b"] = parts
    out["split"] = program.reduce is not None
    out["metrics"] = dict(zip(step.METRICS, metrics.tolist()))
    out["grads"] = TW._np(seen[0])
    out["whole"] = TW._np(gather_tree(list(seen[0]),
                                      trainable_spec(seen[0]), mesh))
    out["seg"] = seg
    out["count"] = int(state.opt_state.count)
    lora_e, dense_e, frozen_e = TW._trainables(sp, lora_full, mesh)
    _, metrics_e, grads_e = step.value_and_grad(
        lora_e, dense_e, frozen_e, cfg, lora_mod.LoraConfig(),
        {k: v.clone() for k, v in rows.items()}, encoder_path="fused",
        remat=False, mesh=mesh, grad_accum=accum)
    out["eager"] = ({k: float(v) for k, v in metrics_e.items()},
                    TW._np(grads_e))
    return out


def model_program_task(rank, data, model, tree, lora, serve_batches,
                       train_batch, accum):
    """At mesh (data, model): the mesh's device exchange and the op's
    group, the plain all-reduce against gloo's, the Predictor's program
    parts (at data 1), and the step program."""
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(data, model, device="cpu")
    key = flash.group_key(mesh.group("model"))
    res = {"exchange": mesh.exchange, "key": key,
           "group_exchange": (None if key is None
                              else flash._GROUPS[key].exchange),
           "data_key": flash.group_key(mesh.group("data")),
           "sums": _plain_sums(mesh, rank),
           "training": _training(tree, mesh, lora, train_batch, accum)}
    if data == 1:
        res["serving"] = _serving(tree, mesh, serve_batches)
    res["closing"] = _close_and_remake(mesh, data, model, key)
    return res


def _close_and_remake(mesh, data, model, key):
    """Close the mesh, make a second one and close it: the keys each
    leaves registered with the op, whether the first key still sums."""
    import torch
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    mesh.close()
    out = {"after_close": sorted(flash._GROUPS)}
    try:
        flash.all_reduce(torch.ones(2), key)
        out["stale_key"] = None
    except ValueError as e:
        out["stale_key"] = str(e)
    again = make_mesh(data, model, device="cpu")
    second = flash.group_key(again.group("model"))
    out["second_key"] = second
    out["second_sum"] = flash.all_reduce(torch.ones(2), second).tolist()
    out["while_open"] = sorted(flash._GROUPS)
    again.close()
    out["after_second"] = sorted(flash._GROUPS)
    return out
