"""Rank bodies for tests/test_torch_mesh_program.py: the Predictor's request
program and the Trainer's step on a ("data", 1) mesh of CPU ranks over
gloo, one spawned process a rank, started by tests/torch_parallel_worker.py
``run_ranks(TASK, ...)``. Imports no JAX.

Everything crosses the process boundary as numpy (a CPU tensor in a
multiprocessing queue is a shared-memory handle that dies with its
sender).
"""

from __future__ import annotations

import contextlib

import numpy as np

from tests import torch_parallel_train_worker as TW
from tests import torch_parallel_worker as W
from tests.torch_dispatch_modes import NoDeviceReads

TASK = "tests.torch_mesh_program_worker:mesh_program_task"
MNT = 4
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "broadcast",
               "broadcast_object_list", "reduce_scatter",
               "reduce_scatter_tensor", "barrier", "send", "recv")


@contextlib.contextmanager
def recorded_collectives():
    """Every torch.distributed collective called inside the block, in
    order: a list of (name, the group's ranks)."""
    import torch.distributed as dist
    calls, inner = [], {n: getattr(dist, n) for n in COLLECTIVES}

    def wrap(name):
        def call(*a, group=None, **kw):
            ranks = (None if group is None
                     else tuple(dist.get_process_group_ranks(group)))
            calls.append((name, ranks))
            return inner[name](*a, group=group, **kw)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in inner.items():
            setattr(dist, name, fn)


def _program_parts(pred, batch):
    """The Predictor's program on this rank's rows of ``batch``, its
    prefix, each decode pass and its suffix under NoDeviceReads and a
    collective recorder (the host loop's read of the predicate outside
    both). Returns (the collectives, the meta rows, the pass count)."""
    import torch
    from anyref_tpu_torch.parallel.partition import batch_spec, local_block
    host, _, _ = pred._inputs(batch)
    spec = batch_spec(host)
    dev = {k: torch.from_numpy(np.ascontiguousarray(
        local_block(v, spec[k], pred.mesh))) for k, v in host.items()}
    passes = 0
    with torch.inference_mode(), recorded_collectives() as calls:
        with NoDeviceReads():
            loop, finish = pred._program(dev)
        while True:
            with NoDeviceReads():
                go = loop.cond(loop.carry)
            if not bool(go):
                break
            with NoDeviceReads():
                loop.body(loop.carry)
            passes += 1
        with NoDeviceReads():
            meta, _ = finish(loop.carry)
    return calls, meta.numpy(), passes


def _serving(tree, mesh, batches, serve_images, serve_texts):
    """At ``mesh``: the program parts on each batch; at a data mesh also
    predict (predict_async, then complete) on each batch with the
    collectives and the handle's rows of each, and the Server (rank 0) and
    follow (rank 1) on the requests in pinned pairs."""
    import torch
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.parallel.mesh import DATA_AXIS
    from anyref_tpu_torch.parallel.partition import shard_params
    from anyref_tpu_torch.serve import Server, follow
    cfg = TW._cfg()
    sp = shard_params(torch.load(tree), mesh, cfg)
    pred = Predictor(sp, cfg, max_new_tokens=MNT, device="cpu",
                     encoder_path="unfused", mesh=mesh)
    out = {}
    for kind, batch in batches.items():
        calls, meta, passes = _program_parts(pred, batch)
        res = {"program_calls": calls, "meta": meta, "passes": passes}
        if mesh.shape[DATA_AXIS] > 1:
            with recorded_collectives() as calls:
                handle = pred.predict_async(batch)
            (meta_h, low_h), _, B = handle
            res["dispatch_calls"] = calls
            res["handle_rows"] = (meta_h.shape[0], low_h.shape[0])
            with recorded_collectives() as calls:
                ids, masks = pred.complete(handle)
            res["complete_calls"] = calls
            res["ids"] = ids
        out[kind] = res
    if mesh.shape[DATA_AXIS] > 1:
        if mesh.rank == 0:
            server = Server(sp, cfg, max_batch=2, speculative=False,
                            max_new_tokens=MNT, device="cpu",
                            encoder_path="unfused", mesh=mesh,
                            **W.PIN_PAIRS)
            try:
                results = W.serve_pairs(server, serve_images, serve_texts)
            finally:
                server.shutdown()
            out["served"] = [{k: r.get(k) for k in ("output_ids", "error")}
                             for r in results]
            out["served_batches"] = server.stats["batches"]
        else:
            out["served_batches"] = follow(sp, cfg)
    return out


def _program_collectives(sp, mesh, lora_full, batch, accum):
    """A step program at ``mesh`` on this rank's rows of ``batch`` from
    ``lora_full`` (the Trainer's state otherwise): the collectives of the
    staging (step_program), of part A (prefix, the micro-steps, average)
    under NoDeviceReads, of the host's reduce and of part B (update); the
    gradient the update read (whole trees), the metrics (the global
    batch's after the reduce) and the count after the step."""
    import torch
    from anyref_tpu_torch.train import lora as lora_mod
    from anyref_tpu_torch.train import step
    cfg = TW._cfg()
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
    with recorded_collectives() as calls:
        program = step.step_program(cfg, lora_mod.LoraConfig(), opt, state,
                                    frozen, rows, remat=False,
                                    grad_accum=accum, encoder_path="fused",
                                    mesh=mesh)
    out["staging"] = calls
    with recorded_collectives() as calls:
        with NoDeviceReads():
            carry = program.prefix()
        while int(carry["i"]) < program.accum:
            with NoDeviceReads():
                carry = program.body(carry)
        with NoDeviceReads():
            metrics = program.average(carry)
    out["part_a"] = calls
    with recorded_collectives() as calls:
        if program.reduce is not None:
            program.reduce(carry, metrics)
    out["between"] = calls
    with recorded_collectives() as calls:
        with NoDeviceReads():
            program.update(carry)
    out["part_b"] = calls
    out["split"] = program.reduce is not None
    out["metrics"] = metrics.numpy()
    out["grads"] = TW._np(seen[0])
    out["count"] = int(state.opt_state.count)
    return out


def present_mesh_grads(sp, mesh, lora_full, batch, accum):
    """The eager mesh step's gradient as the port computed it before the
    data mesh was split: each micro-step's loss terms the global batch's
    means through ops/losses.py's all-reduce of (sum, count), the fp32 sum
    over micro-steps, then all_reduce_grads over "data" with the scale
    1 / accum, rounded once to each leaf's dtype (without remat, as the
    split program here). (metrics, whole grads)."""
    import torch
    from anyref_tpu_torch.models import anyref
    from anyref_tpu_torch.parallel.collectives import all_reduce_grads
    from anyref_tpu_torch.parallel.mesh import DATA_AXIS
    from anyref_tpu_torch.train import lora as lora_mod
    from anyref_tpu_torch.train import step
    cfg = TW._cfg()
    lora_p, dense, frozen = TW._trainables(sp, lora_full, mesh)
    leaves = step.tree_leaves((lora_p, dense))
    rows = {k: torch.as_tensor(v) for k, v in
            TW._rows(batch, mesh, accum).items()}
    sums = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    metrics = torch.zeros(len(step.METRICS))
    for i in range(accum):
        micro = rows if accum == 1 else {k: v[i] for k, v in rows.items()}
        params = lora_mod.merge_params(dense, frozen)
        params = {**params, "llama": lora_mod.apply(
            params["llama"], lora_p, lora_mod.LoraConfig())}
        out = anyref.train_forward(params, cfg, micro, encoder_path="fused",
                                   mesh=mesh)
        grads = torch.autograd.grad(out.loss, leaves, allow_unused=True)
        with torch.no_grad():
            for acc, g in zip(sums, grads):
                if g is not None:
                    acc.add_(g)
            metrics += torch.stack([getattr(out, k).detach().float()
                                    for k in step.METRICS])
    grads = all_reduce_grads(sums, mesh.group(DATA_AXIS), 1.0 / accum)
    grads = iter([g.to(p.dtype) for g, p in zip(grads, leaves)])
    return ((metrics / accum).numpy(),
            TW._np(step.tree_map(lambda _: next(grads), (lora_p, dense))))


def _training(tree, mesh, lora_full, batch, accum, samples, out_dir):
    """At the data mesh: the split step program's collectives and the
    gradient its update read, beside the present mesh step's, and a
    Trainer's steps with their batches."""
    import torch
    from anyref_tpu_torch.parallel.partition import shard_params
    from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = TW._cfg()
    sp = shard_params(torch.load(tree), mesh, cfg)
    out = {"program": _program_collectives(sp, mesh, lora_full, batch,
                                           accum)}
    out["present"] = present_mesh_grads(sp, mesh, lora_full, batch, accum)
    tc = TrainConfig(output_dir=out_dir, per_device_batch_size=1,
                     grad_accum_steps=1, max_steps=2, warmup_steps=1,
                     save_steps=10 ** 9, log_steps=1, learning_rate=1e-3,
                     remat=False, encoder_path="fused", resume=False)
    trainer = Trainer(cfg, tc, torch.load(tree),
                      dataset=TW.ListDataset(samples), device="cpu",
                      mesh=mesh)
    batches, inner = [], trainer.step_fn

    def step_fn(state, frozen_, b):
        batches.append({k: np.array(v) for k, v in b.items()})
        return inner(state, frozen_, b)
    trainer.step_fn = step_fn
    trainer.train()
    out["trainer_batches"] = batches
    out["writer"] = trainer.writer
    return out


def mesh_program_task(rank, tree, lora, serve_batches, serve_images,
                      serve_texts, train_batch, accum, samples, out):
    """On two ranks: serving at (2, 1) and the program parts at (1, 2),
    then training at (2, 1) (tests/test_torch_mesh_program.py)."""
    from anyref_tpu_torch.parallel.mesh import make_mesh
    data_mesh = make_mesh(2, 1, device="cpu")
    model_mesh = make_mesh(1, 2, device="cpu")
    res = {"serving": _serving(tree, data_mesh, serve_batches, serve_images,
                               serve_texts),
           "model_axis": _serving(tree, model_mesh,
                                  {"text": serve_batches["text"]}, None,
                                  None)}
    res["training"] = _training(tree, data_mesh, lora, train_batch, accum,
                                samples, out)
    return res
