"""Rank processes for tests/test_torch_parallel.py: the port on a mesh of
CPU ranks over gloo, one spawned process a rank. Imports no JAX (the
ranks run the port alone; the test process holds the JAX reference).

``run_ranks(task, world, tmp, **kw)`` starts ``world`` processes (spawn),
each joining a process group through a FileStore of its own in a new
directory under ``tmp`` with a collective timeout of ``collective_s``
(60 s), runs ``TASKS[task](rank, **kw)`` (or, for a task named
"module:function", that function of that module) and returns the results
in rank order; a rank that fails, or a run past ``timeout`` seconds, fails
the caller and kills every rank still alive.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

COLLECTIVE_TIMEOUT_S = 60.0
PIN_PAIRS = dict(max_wait_ms=2000.0, fill_wait_ms=30000.0)


def run_ranks(task: str, world: int, tmp, timeout: float = 300.0,
              collective_s: float = COLLECTIVE_TIMEOUT_S, **kw):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(
        prefix=f"{task.rsplit(':', 1)[-1]}-{world}-", dir=str(tmp)), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, collective_s, task, kw, q),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.time() + timeout
        while len(results) < world:
            try:
                rank, ok, out = q.get(
                    timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                raise AssertionError(
                    f"{task}: ranks {sorted(set(range(world)) - set(results))}"
                    f" gave no result within {timeout} s") from None
            if not ok:
                raise AssertionError(f"{task}, rank {rank}:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=20)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


def _rank_main(rank, world, store, collective_s, task, kw, q):
    import torch
    import torch.distributed as dist
    from anyref_tpu_torch.parallel.mesh import init_process_group
    torch.set_num_threads(1)
    try:
        init_process_group(rank, world, f"file://{store}", "gloo",
                           timeout_s=collective_s)
        if ":" in task:
            module, name = task.split(":")
            fn = getattr(importlib.import_module(module), name)
        else:
            fn = TASKS[task]
        out = fn(rank, **kw)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cfg():
    from anyref_tpu_torch.config import anyref_tiny
    return anyref_tiny()


def _generate(params, cfg, batch, mesh, mnt, **kw):
    from anyref_tpu_torch.models import anyref
    from anyref_tpu_torch.parallel.partition import shard_batch
    out = anyref.generate(params, cfg, shard_batch(batch, mesh),
                          max_new_tokens=mnt, device="cpu",
                          encoder_path="unfused", mesh=mesh, **kw)
    return {"ids": out.output_ids.numpy(),
            "seg_valid": out.seg_valid.numpy(),
            "low_res": out.low_res_masks.numpy(),
            "seg_emb": out.seg_embeddings.numpy(),
            "passes": int(out.decode_passes)}


def generate_task(rank, data, model, tree, batch, mnt, int8=False,
                  meter=False, seg_scale=None, staged=False):
    """Greedy and speculative generate of this rank's rows on the sharded
    tree; with ``int8`` also greedy and speculative on the sharded int8
    tree quantised from it; with ``meter`` an AverageMeter's all_reduce;
    with ``seg_scale`` greedy and speculative at rephrase_weight 0.1 on the
    tree whose lm_head [SEG] column is scaled by it; with ``staged`` the
    bytes a mesh Predictor counts as uploaded for the batch
    (``h2d_bytes_total``: this rank's rows)."""
    import torch
    from anyref_tpu_torch.ops.quant import quantize_llama
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_params
    cfg = _cfg()
    mesh = make_mesh(data, model, device="cpu")
    sp = shard_params(torch.load(tree), mesh, cfg)
    out = {"coords": dict(mesh.coords),
           "greedy": _generate(sp, cfg, batch, mesh, mnt),
           "speculative": _generate(sp, cfg, batch, mesh, mnt,
                                    speculative=True, draft_len=3),
           "local_heads": sp["llama"]["layers"][0]["attn"]["q"]["w"].shape}
    if int8:
        params = torch.load(tree)
        params["llama"] = quantize_llama(params["llama"])
        sq = shard_params(params, mesh, cfg)
        out["int8"] = _generate(sq, cfg, batch, mesh, mnt)
        out["int8_speculative"] = _generate(sq, cfg, batch, mesh, mnt,
                                            speculative=True, draft_len=3)
    if seg_scale is not None:
        params = torch.load(tree)
        params["llama"]["lm_head"][:, cfg.tokens.seg] *= seg_scale
        cfg_r = cfg.scaled(rephrase_weight=0.1)
        sr = shard_params(params, mesh, cfg_r)
        out["rephrase_greedy"] = _generate(sr, cfg_r, batch, mesh, mnt)
        out["rephrase_speculative"] = _generate(
            sr, cfg_r, batch, mesh, mnt, speculative=True, draft_len=3)
    if staged:
        import numpy as np
        from anyref_tpu_torch.eval.runner import Predictor
        pred = Predictor(sp, cfg, max_new_tokens=mnt, device="cpu",
                         encoder_path="unfused", mesh=mesh)
        ids = batch["input_ids"]
        pred.predict_async(dict(batch, prompt_lens=np.full(
            len(ids), ids.shape[1], np.int32)))
        out["h2d_bytes"] = pred.h2d_bytes_total
    if meter:
        import numpy as np
        from anyref_tpu_torch.eval.metrics import AverageMeter
        m = AverageMeter("iou")
        m.update(np.asarray([1.0 + rank, 2.0 * rank]), n=rank + 1)
        s = AverageMeter("scalar")
        s.update(0.5 * (rank + 1))
        m.all_reduce()
        s.all_reduce()
        out["meter"] = (m.sum, m.count, s.sum, s.count)
    return out


def serve_task(rank, tree, images, texts, idle_s=0.0, fail_at=None):
    """The leader Server on rank 0, a follower on rank 1, mesh (1, 2), the
    Server's defaults (speculative), requests in pinned pairs, the Server
    idle for ``idle_s`` seconds after the first pair. With ``fail_at`` the
    follower's generate raises on its batch of that index, the follower
    returns the error, and the leader submits one request more once the
    pairs are answered."""
    import torch
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_params
    from anyref_tpu_torch.serve import Request, Server, follow
    cfg = _cfg()
    mesh = make_mesh(1, 2, device="cpu")
    sp = shard_params(torch.load(tree), mesh, cfg)
    if rank != 0:
        if fail_at is not None:
            _fail_generate_at(fail_at)
        try:
            return {"batches": follow(sp, cfg)}
        except RuntimeError as e:
            return {"error": repr(e)}
    server = Server(sp, cfg, max_batch=2, device="cpu", **PIN_PAIRS)
    try:
        results, seconds = serve_pairs(server, images, texts, idle_s,
                                       times=True)
        late = None
        if fail_at is not None:    # a request after the failure
            late = server.submit(Request(image=images[0], text=texts[0]))
            late = late.result(timeout=60)
    finally:
        server.shutdown()
    return {"results": [{k: r.get(k) for k in ("text", "mask", "error")}
                        for r in results],
            "seconds": seconds, "late": late,
            "layout": sorted(sp["llama"]["layers"][0]["attn"]),
            "batches": server.stats["batches"]}


def _fail_generate_at(index):
    """Make anyref.generate_program (the Predictor's program) raise on its
    call of ``index`` (from 0)."""
    from anyref_tpu_torch.models import anyref
    inner, calls = anyref.generate_program, []

    def generate_program(*a, **kw):
        calls.append(None)
        if len(calls) == index + 1:
            raise RuntimeError("injected failure of a follower's step")
        return inner(*a, **kw)

    anyref.generate_program = generate_program


def serve_pairs(server, images, texts, idle_s=0.0, times=False):
    """Submit in pinned pairs (wait between pairs), so that every server
    coalesces the same micro-batches, sleeping ``idle_s`` after the first
    pair; with ``times`` also each pair's seconds from submit to its last
    answer."""
    from anyref_tpu_torch.serve import Request
    out, seconds = [], []
    for i in range(0, len(images), 2):
        if i == 2:
            time.sleep(idle_s)
        t0 = time.time()
        reqs = [server.submit(Request(image=im, text=t))
                for im, t in zip(images[i:i + 2], texts[i:i + 2])]
        out.extend(r.result(timeout=240) for r in reqs)
        seconds.append(time.time() - t0)
    return (out, seconds) if times else out


def race_build(so, start, out):
    """One of two processes racing the first RLE build into ``so``: puts
    whether it compiled, after loading the library."""
    import ctypes
    from pathlib import Path
    from anyref_tpu_torch.data import rle
    start.wait(timeout=60)
    compiled = rle.build_library(rle.SOURCE, Path(so))
    ctypes.CDLL(so).rle_area
    out.put(compiled)


TASKS = {"generate": generate_task, "serve": serve_task}
