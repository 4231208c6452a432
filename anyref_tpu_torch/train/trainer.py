"""The training loop (port of anyref_tpu/train/trainer.py, one device).

Gradient accumulation over micro-batches, one optimizer step, metrics to
``metrics.jsonl``, a train-state checkpoint every ``save_steps`` with
resume, ``merged_params`` for deployment, and ``torch.profiler`` around the
steps named by ``profile_steps``. Runs on the CUDA device unless the caller
passes ``device="cpu"``. Without a dataset the Trainer builds the mix that
``train_datasets`` names under ``data_root`` (data/registry.py), its AVS
readers' mel front end on the Trainer's device.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .. import checkpoint as ckpt
from ..config import AnyRefConfig, check_encoder_path
from ..data.collator import Collator
from ..data.loader import DataLoader
from ..params import resolve_device
from ..tokenizer import AnyRefTokenizer
from . import lora as lora_mod
from . import step as step_mod


@dataclass
class TrainConfig:
    """Launch parameters (reference train.sh:1-22), one device."""

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
    remat: bool = True
    encoder_path: str = "fused"        # the towers' path (config.ENCODER_PATHS)


class Trainer:
    def __init__(self, cfg: AnyRefConfig, tc: TrainConfig, params: dict,
                 dataset=None, tokenizer: Optional[AnyRefTokenizer] = None,
                 device="cuda"):
        check_encoder_path(tc.encoder_path)
        dev = resolve_device(device)
        p_dev = params["llama"]["embed_tokens"].device
        if p_dev.type != dev.type:
            raise ValueError(f"params live on {p_dev}, the Trainer was "
                             f"asked to run on {dev}")
        self.cfg = cfg
        self.tc = tc
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
        self.step_fn = step_mod.make_train_step(
            cfg, self.lora_cfg, self.optimizer, remat=tc.remat,
            grad_accum=tc.grad_accum_steps, encoder_path=tc.encoder_path)
        if dataset is None:
            from ..data.registry import build_train_datasets
            dataset = build_train_datasets(
                tc.train_datasets, tc.data_root, cfg, itisseg=tc.itisseg,
                roi=tc.roi, no_mask=tc.no_mask, device=dev)
        self.loader = DataLoader(dataset,
                                 Collator(self.tokenizer, cfg, train=True,
                                          roi=tc.roi),
                                 batch_size=tc.per_device_batch_size,
                                 shuffle=True, num_workers=8, seed=tc.seed,
                                 drop_last=True)
        self.profiler = None
        os.makedirs(tc.output_dir, exist_ok=True)
        self._log_path = os.path.join(tc.output_dir, "metrics.jsonl")

        if tc.resume:
            latest = ckpt.latest_checkpoint(tc.output_dir)
            if latest:
                s = self.state
                restored = ckpt.restore_train_state(
                    latest, {"step": 0, "lora": s.lora, "dense": s.dense,
                             "opt_state": s.opt_state})
                self.state = step_mod.TrainState(
                    int(restored["step"]), restored["lora"],
                    restored["dense"], restored["opt_state"])
                for t in step_mod.tree_leaves((self.state.lora,
                                               self.state.dense)):
                    t.requires_grad_(True)
                print(f"resumed from {latest}")

    def log(self, step: int, metrics: dict, extra: Optional[dict] = None):
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
        readable on ``self.profiler``."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(None, None, None)
        os.makedirs(self.tc.profile_dir, exist_ok=True)
        self.profiler.export_chrome_trace(os.path.join(
            self.tc.profile_dir, f"trace-{self.tc.profile_steps[0]}-{step}"
            ".json"))

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
                ckpt.save_train_state(tc.output_dir, step, self.state)
        return self.state

    def merged_params(self) -> dict:
        """Deployment params: the dense trainables merged back and LoRA
        folded in."""
        params = lora_mod.merge_params(
            step_mod.tree_map(torch.Tensor.detach, self.state.dense),
            self.frozen)
        return {**params,
                "llama": lora_mod.merge(params["llama"], self.state.lora,
                                        self.lora_cfg)}
