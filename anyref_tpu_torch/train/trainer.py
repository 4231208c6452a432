"""The training loop (port of anyref_tpu/train/trainer.py).

Gradient accumulation over micro-batches, one optimizer step, metrics to
``metrics.jsonl``, a train-state checkpoint every ``save_steps`` with
resume, ``merged_params`` for deployment, and ``torch.profiler`` around the
steps named by ``profile_steps``. Runs on the CUDA device unless the caller
passes ``device="cpu"``. Without a dataset the Trainer builds the mix that
``train_datasets`` names under ``data_root`` (data/registry.py), its AVS
readers' mel front end on the Trainer's device.

Across ranks (one process a rank, torch.distributed initialised by the
caller, or a ``mesh`` passed in): a ("data", "model") mesh of
``mesh_model_axis`` model ranks (parallel/mesh.py ``make_mesh``); the
params cut into this rank's blocks (``shard_params``, consuming the
caller's tree where the model axis is larger than 1), the state kept as
blocks, each data rank loading ``per_device_batch_size`` rows of its own
shard (the global batch is ``per_device_batch_size`` x data ranks), and the
step of train/step.py on the mesh. Rank 0 alone writes ``metrics.jsonl``
and the console line; a checkpoint gathers the blocks and rank 0 writes
one file of the single-device format, so a run saved on one mesh resumes
on another (every rank reads it and cuts its blocks).

On a CUDA device, on every mesh, ``step_fn`` is the compiled step, the
counterpart of the reference's ``jax.jit`` of its step with the state
donated: each batch key ``(grad_accum, sorted (name, shape, dtype))`` is
one CUDA graph program (utils/graphs.py) whose replay is one optimizer
step, the micro-steps one captured body run
``grad_accum`` times by a WHILE node (train/step.py ``step_program``), the
trainables, the moments and the count updated in place. A key's first
step runs the program from the host (its results are that step's), then
``_capture`` records it on a side stream; every later step of the key
stages the batch in pinned memory, copies it into the program's static
inputs, replays and returns; ``train()`` reads the metrics at
``log_steps``. On a mesh of several data ranks the step is two graphs on
every rank: the micro-steps, which hold no collective over "data" (the
host stages each micro-step's global loss counts with the batch), then
the data sum of the gradients and the metrics issued by the host, then
the clip and AdamW. The sums over a "model" axis stay inside the graphs,
launches of the all-reduce kernel (parallel/collectives.py). All keys
share one graph memory pool, held for the Trainer's life. A failed
capture or replay raises. On the CPU the same program runs from the host.
Python code inside the step (a monkeypatched function) runs at a key's
first step and its capture only.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import checkpoint as ckpt
from ..config import AnyRefConfig, check_encoder_path
from ..data.collator import Collator
from ..data.loader import DataLoader
from ..params import resolve_device
from ..parallel import partition
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from ..tokenizer import AnyRefTokenizer
from ..utils.graphs import GraphPool, GraphProgram, stage
from . import lora as lora_mod
from . import step as step_mod


@dataclass
class TrainConfig:
    """Launch parameters (reference train.sh:1-22)."""

    train_datasets: str = "refer_seg"
    data_root: str = "/data"
    output_dir: str = "output"
    per_device_batch_size: int = 6
    grad_accum_steps: int = 8
    learning_rate: float = 5e-5
    warmup_steps: int = 200
    max_steps: int = 10_000
    save_steps: int = 100
    log_steps: int = 10
    seed: int = 0
    itisseg: bool = False
    roi: bool = False
    no_mask: bool = False
    resume: bool = True
    profile_steps: tuple = ()          # e.g. (20, 30) traces steps 20..30
    profile_dir: str = "profile"
    mesh_model_axis: int = 1
    remat: bool = True
    encoder_path: str = "fused"        # the towers' path (config.ENCODER_PATHS)


class Trainer:
    def __init__(self, cfg: AnyRefConfig, tc: TrainConfig, params: dict,
                 dataset=None, tokenizer: Optional[AnyRefTokenizer] = None,
                 device="cuda", mesh=None):
        """``mesh``: this rank's view of a ("data", "model") grid; without
        one, the grid over every rank of the initialised process group
        with ``tc.mesh_model_axis`` model ranks on ``device``, or one
        device where no process group is initialised."""
        check_encoder_path(tc.encoder_path)
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = make_mesh(model=tc.mesh_model_axis, device=device)
        dev = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and mesh.shape[MODEL_AXIS] > 1:
            params = partition.shard_params(params, mesh, cfg)
        p_dev = params["llama"]["embed_tokens"].device
        if p_dev.type != dev.type:
            raise ValueError(f"params live on {p_dev}, the Trainer was "
                             f"asked to run on {dev}")
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.device = dev
        self.tokenizer = tokenizer or AnyRefTokenizer()
        self.lora_cfg = lora_mod.LoraConfig()
        self.optimizer = step_mod.make_optimizer(
            lr=tc.learning_rate, warmup=tc.warmup_steps,
            total_steps=tc.max_steps)
        # the LoRA draw is made on the CPU, so a seed gives the same
        # adapters on every device
        self.state, self.frozen = step_mod.init_state(
            torch.Generator().manual_seed(tc.seed), params, self.lora_cfg,
            self.optimizer)
        self._host_step = step_mod.make_train_step(
            cfg, self.lora_cfg, self.optimizer, remat=tc.remat,
            grad_accum=tc.grad_accum_steps, encoder_path=tc.encoder_path,
            mesh=mesh)
        # the compiled programs (CUDA): key -> GraphProgram (outputs: the
        # metrics), all in one graph memory pool
        self.programs: Dict[tuple, GraphProgram] = {}
        compiled = dev.type == "cuda"
        self.graphs = GraphPool(dev) if compiled else None
        self._replay_stream = None
        self.step_fn = self._compiled_step if compiled else self._host_step
        if dataset is None:
            from ..data.registry import build_train_datasets
            dataset = build_train_datasets(
                tc.train_datasets, tc.data_root, cfg, itisseg=tc.itisseg,
                roi=tc.roi, no_mask=tc.no_mask, device=dev)
        self.loader = DataLoader(
            dataset, Collator(self.tokenizer, cfg, train=True, roi=tc.roi),
            batch_size=tc.per_device_batch_size, shuffle=True, num_workers=8,
            seed=tc.seed, drop_last=True,
            process_index=0 if mesh is None else mesh.coords[DATA_AXIS],
            process_count=1 if mesh is None else mesh.shape[DATA_AXIS])
        self.profiler = None
        self.writer = mesh is None or mesh.rank == 0
        os.makedirs(tc.output_dir, exist_ok=True)
        self._log_path = os.path.join(tc.output_dir, "metrics.jsonl")

        if tc.resume:
            latest = ckpt.latest_checkpoint(tc.output_dir)
            if latest:
                s = self.state
                restored = ckpt.restore_train_state(
                    latest, {"step": 0, "lora": s.lora, "dense": s.dense,
                             "opt_state": s.opt_state}, cut=self._cut)
                # into the state's own tensors, which a compiled step's
                # graphs hold
                with torch.no_grad():
                    for dst, src in zip(
                            step_mod.tree_leaves((s.lora, s.dense,
                                                  s.opt_state)),
                            step_mod.tree_leaves((restored["lora"],
                                                  restored["dense"],
                                                  restored["opt_state"]))):
                        dst.copy_(src)
                self.state = s._replace(step=int(restored["step"]))
                if self.writer:
                    print(f"resumed from {latest}")

    def _specs(self):
        """Partition specs of the (lora, dense) trainables."""
        return partition.trainable_spec((self.state.lora, self.state.dense))

    def _cut(self, saved: dict) -> dict:
        """This rank's blocks of a saved train state's whole leaves."""
        if self.mesh is None:
            return saved
        spec = self._specs()
        cut = partition.shard_tree([saved["lora"], saved["dense"]], spec,
                                   self.mesh)
        opt = saved["opt_state"]
        return {**saved, "lora": cut[0], "dense": cut[1], "opt_state": {
            **opt, "mu": partition.shard_tree(opt["mu"], spec, self.mesh),
            "nu": partition.shard_tree(opt["nu"], spec, self.mesh)}}

    def _compiled_step(self, state: step_mod.TrainState, frozen: dict,
                       batch: dict):
        """``step_fn`` on a CUDA device: the batch key's
        program, captured after the key's first step, which runs from the
        host; later steps stage, copy, replay and return with the metrics
        on the device. On a data mesh the batch is this rank's rows, its
        global loss counts are staged with it (by the program at a key's
        first step), and the data sum runs between the program's two
        graphs. The programs write the Trainer's own state, so ``state``
        and ``frozen`` must be its own."""
        own = self.state
        if (state.lora is not own.lora or state.dense is not own.dense
                or state.opt_state is not own.opt_state
                or frozen is not self.frozen):
            raise ValueError("the compiled step runs on the Trainer's own "
                             "state and frozen params")
        host = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        key = (self.tc.grad_accum_steps, tuple(sorted(
            (k, v.shape, str(v.dtype)) for k, v in host.items())))
        program = self.programs.get(key)
        if program is None:
            tc = self.tc
            step = step_mod.step_program(
                self.cfg, self.lora_cfg, self.optimizer, state, frozen,
                {k: torch.from_numpy(v).to(self.device)
                 for k, v in host.items()},
                tc.remat, tc.grad_accum_steps, tc.encoder_path, self.mesh)
            # the key's warm-up, from the host: its results are this
            # step's, and its inputs become the program's buffers
            metrics = step.run()
            self.programs[key] = self._capture(step)
        else:
            if "loss_counts" in program.inputs:
                host = step_mod.stage_loss_counts(host, self.cfg, self.mesh)
            stage(program.inputs, host)
            self._replay_stream = program.run(self.graphs)
            metrics = program.outputs[0].clone()
        return (state._replace(step=state.step + 1),
                dict(zip(step_mod.METRICS, metrics.unbind())))

    def _capture(self, step: step_mod.StepProgram) -> GraphProgram:
        """Capture ``step`` (a key's step program, whose device inputs
        become the static inputs) into three graphs in the Trainer's pool
        and stitch them into one, the body a WHILE node over the carry's
        micro-step index (utils/graphs.py). On a data mesh the third graph
        averages the metrics only, and the update (the gradients' rounding,
        the clip and AdamW) is a fourth graph, replayed after the host's
        data sum on the carry and the metrics. A capture records kernels
        and their launch counts and runs none; each replay counts what it
        runs, on the device."""
        t0 = time.perf_counter()
        g0, carry = self.graphs.capture(step.prefix)
        g1, _ = self.graphs.capture(lambda: step.body(carry))
        g2, metrics = self.graphs.capture(lambda: (
            step.suffix if step.reduce is None else step.average)(carry))
        graphs = (g0, g1, g2)
        exec_ = self.graphs.program(graphs, carry["i"], None, step.accum)
        if step.reduce is None:
            return GraphProgram(step.batch, (metrics,), graphs, exec_,
                                time.perf_counter() - t0)
        then, _ = self.graphs.graph(lambda: step.update(carry))
        return GraphProgram(step.batch, (metrics,), graphs, exec_,
                            time.perf_counter() - t0,
                            lambda: step.reduce(carry, metrics), then)

    def graph_pool_bytes(self) -> int:
        """Device bytes the compiled steps' memory pool holds (0 before the
        first capture, and off CUDA)."""
        return 0 if self.graphs is None else self.graphs.bytes()

    def _wait_replays(self) -> None:
        """Make the current stream wait for the last replay's stream, so
        that a read of the state sees every step dispatched."""
        if self._replay_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._replay_stream)

    def gathered_state(self) -> step_mod.TrainState:
        """The train state with whole leaves (collective over "model" on a
        mesh; the state itself elsewhere), after every step dispatched."""
        self._wait_replays()
        s = self.state
        if self.mesh is None:
            return s
        spec = self._specs()
        lora, dense = partition.gather_tree([s.lora, s.dense], spec,
                                            self.mesh)
        opt = s.opt_state
        return step_mod.TrainState(s.step, lora, dense, step_mod.OptState(
            opt.count, partition.gather_tree(opt.mu, spec, self.mesh),
            partition.gather_tree(opt.nu, spec, self.mesh)))

    def save(self, step: int) -> None:
        """``checkpoint-{step}`` in the single-device format: the blocks
        gathered, rank 0 writing, every rank waiting until it has."""
        state = self.gathered_state()
        if self.writer:
            ckpt.save_train_state(self.tc.output_dir, step, state)
        if self.mesh is not None and self.mesh.host_group is not None:
            dist.barrier(group=self.mesh.host_group)

    def log(self, step: int, metrics: dict, extra: Optional[dict] = None):
        if not self.writer:
            return
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if extra:
            rec.update(extra)
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in rec.items()), flush=True)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=acts)
        self.profiler.__enter__()

    def _stop_profiler(self, step: int):
        """Stop after ``step`` and write its chrome trace; the events stay
        readable on ``self.profiler``. Of a replayed step the trace may
        lose, or repeat, the records of the micro-step loop (a CUDA graph's
        conditional node): the card's count of the loop's condition kernel
        (ops/flash.py launch_counts) says whether it did."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(None, None, None)
        os.makedirs(self.tc.profile_dir, exist_ok=True)
        rank = "" if self.mesh is None else f"-rank{self.mesh.rank}"
        self.profiler.export_chrome_trace(os.path.join(
            self.tc.profile_dir, f"trace-{self.tc.profile_steps[0]}-{step}"
            f"{rank}.json"))

    def train(self):
        tc = self.tc
        step = self.state.step
        t0 = time.time()
        if len(self.loader) == 0:
            raise ValueError(
                f"dataset smaller than one batch ({len(self.loader.dataset)} "
                f"items < batch {self.loader.batch_size})")
        micro = []
        data_iter = iter(self.loader)
        while step < tc.max_steps:
            try:
                batch = next(data_iter)
            except StopIteration:
                data_iter = iter(self.loader)
                continue
            micro.append(batch)
            if len(micro) < tc.grad_accum_steps:
                continue
            if tc.grad_accum_steps == 1:
                batch = step_mod.device_batch(micro[0])
            else:
                batch = step_mod.stack_microbatches(micro)
            micro = []

            if tc.profile_steps and step == tc.profile_steps[0]:
                self._start_profiler()
            self.state, metrics = self.step_fn(self.state, self.frozen, batch)
            if tc.profile_steps and step == tc.profile_steps[-1]:
                self._stop_profiler(step)

            step += 1
            if step % tc.log_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                self.log(step, m,
                         {"steps_per_s": tc.log_steps / max(dt, 1e-9)})
                t0 = time.time()
            if step % tc.save_steps == 0:
                self.save(step)
        return self.state

    def merged_params(self) -> dict:
        """Deployment params: the dense trainables merged back and LoRA
        folded in; on a mesh the whole tree on every rank (collective over
        "model")."""
        state, frozen = self.gathered_state(), self.frozen
        if self.mesh is not None:
            frozen = partition.gather_tree(
                frozen, partition.anyref_spec(frozen, self.cfg), self.mesh)
        params = lora_mod.merge_params(
            step_mod.tree_map(torch.Tensor.detach, state.dense), frozen)
        return {**params,
                "llama": lora_mod.merge(params["llama"], state.lora,
                                        self.lora_cfg)}
