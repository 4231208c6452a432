"""Predictor: prompt batch -> generated ids + original-size mask logits
(port of anyref_tpu/eval/runner.py).

Prompts are left-padded into length buckets and batches into batch buckets
(padding rows copy row 0 and are dropped), so the shapes the device sees come
from a small fixed set. The reference keys (crops, boxes, audio clips and
their validity) ride along, padded the same way. uint8 images are
normalized on the device. The fetch packs ids, [SEG] validity and the
decode pass count into one int32 array; the variable-shape tail (crop the
padded canvas, resize to each image's size) runs on the host. A speculative
Predictor first converts the caller's decoder tree to the serving layout
(models/llama.py fuse_for_serving), in place.

On a CUDA device, each shape key ``(bucket, batch bucket, sorted (name,
dtype))`` is one compiled program, as the reference's ``jax.jit`` of its
``run`` is: at the key's first use the program runs once eagerly (its
results are that call's; the kernels load), then ``_capture`` records it
into one CUDA graph whose inputs and outputs are static buffers: the
device normalisation and generate's prefix, the decode loop as a WHILE
conditional node whose body is one captured decoder pass and whose
predicate a kernel of csrc/graph_loop.cu sets on the device, and the
suffix with the meta / low-res packing. Every later call of the key stages
the batch in pinned memory, copies it into the static inputs, replays the
graph and clones the outputs, all on the stream, with no read from the
device, and returns: the Server's device loop (serve.py) then collates and
dispatches the next batch while this one runs. All keys of a Predictor
share one memory pool, which holds its memory for as long as the Predictor
lives. A failed capture or replay raises. On the CPU the program runs
eagerly with the decode loop on the host.

On a mesh of several ranks (parallel/mesh.py; the tree of
parallel/partition.py ``shard_params``), every rank calls the same
Predictor methods on the same batch, in the same order: the batch bucket is
a multiple of the "data" size and each rank stages and runs its rows (its
data coordinate's block of the padded batch, the host-side counterpart of
``shard_batch``); the key stays the whole batch's, so every rank captures
the same keys in the same order. The program is captured as on one
device; on a "model" axis above 1 its decoder layers' sums over the axis
are launches of the all-reduce kernel (parallel/collectives.py), which the
graph holds, and every model rank replays it in step with the others. A handle
holds the rank's rows on the device; ``complete`` (and ``fetch``, a
serving follower's part of it) reads them back and, with more than one
data rank, gathers every data rank's rows over the host group in batch
order, so every rank's results are the whole batch's. A sharded tree keeps
its layout, as the reference's does: speculative decode runs on the [in,
out] (or transposed) layout, an int8 tree included.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import (SAM_PIXEL_MEAN, SAM_PIXEL_STD, AnyRefConfig,
                      check_encoder_path)
from ..models import anyref, clip_vit, llama
from ..ops.common import device_constant
from ..ops.quant import is_quantized
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.partition import batch_spec, local_block
from ..ops.resize import postprocess_low_res_np
from ..params import resolve_device
from ..utils.graphs import GraphPool, GraphProgram, stage

def _sam_normalize_device(x_u8, resized_sizes):
    """Normalize uint8 SAM canvases and re-zero the pad beyond each row's
    resized extent (the host pipeline's normalize-then-pad order)."""
    S = x_u8.shape[-1]
    dev = x_u8.device
    mean = device_constant(SAM_PIXEL_MEAN, torch.float32, dev).reshape(
        1, 3, 1, 1)
    std = device_constant(SAM_PIXEL_STD, torch.float32, dev).reshape(
        1, 3, 1, 1)
    x = (x_u8.float() - mean) / std
    nh = resized_sizes[:, 0].reshape(-1, 1, 1, 1)
    nw = resized_sizes[:, 1].reshape(-1, 1, 1, 1)
    row = torch.arange(S, device=dev).reshape(1, 1, S, 1)
    col = torch.arange(S, device=dev).reshape(1, 1, 1, S)
    return torch.where((row < nh) & (col < nw), x, 0.0)


class Predictor:
    def __init__(self, params, cfg: AnyRefConfig,
                 max_new_tokens: Optional[int] = None,
                 prompt_buckets=(129, 193, 257, 385, 513),
                 batch_buckets=(1, 2, 4, 8),
                 speculative: bool = False,
                 draft_len: Optional[int] = None,
                 max_accept: Optional[int] = None,
                 force_accept: bool = False,
                 mask_fetch_dtype: str = "float32",
                 fetch_segs: Optional[int] = None,
                 device="cuda", encoder_path: str = "fused", mesh=None):
        # buckets = 1 (mod 128): the +255 image expansion lands prefill on
        # multiples of 128 (384/448/512/640/768)
        # the mesh: the argument, or the one shard_params cut the tree for;
        # it names the device
        self.mesh = mesh if mesh is not None else getattr(params, "mesh",
                                                          None)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.encoder_path = check_encoder_path(encoder_path)
        # the reference converts a single-device tree only
        sharded = self.mesh is not None and self.mesh.size > 1
        if speculative and not sharded and is_quantized(params["llama"]):
            # the reference's speculative Predictor first converts the
            # decoder to its bf16 serving layout (transposed, fused
            # matrices), which an int8 tree does not have
            raise ValueError(
                "an int8 decoder (ops.quant.quantize_llama) is served with "
                "speculative=False: the reference's speculative serving "
                "needs the bf16 serving layout of the decoder")
        if speculative and not sharded:
            # the reference's serving layout (transposed, fused q/k/v and
            # gate/up matrices), made IN PLACE, weight by weight: it
            # consumes the caller's tree, as the reference's does
            params["llama"] = llama.fuse_for_serving(
                llama.transpose_for_serving(params["llama"]))
        self.params = params
        self.cfg = cfg
        self.mnt = max_new_tokens or cfg.max_new_tokens
        self.buckets = sorted(prompt_buckets)
        self.batch_buckets = sorted(batch_buckets)
        self.speculative = speculative
        self.gen_kw = {}
        if speculative and draft_len is not None:
            self.gen_kw["draft_len"] = draft_len
        if speculative and max_accept is not None:
            self.gen_kw["max_accept"] = max_accept
            # benchmark only: the output is the draft stream, not greedy
            self.gen_kw["force_accept"] = force_accept
        # serving fetches bf16 masks (one bf16 ulp is ~0.03 on the logit
        # scale, inside the sigmoid > 0.5 margin); eval keeps float32
        self.mask_fetch_dtype = getattr(torch, mask_fetch_dtype)
        # serving fetches only the first fetch_segs mask slots
        self.fetch_segs = fetch_segs
        self.decode_passes_total = 0
        self.completed_batches = 0
        # bytes staged host -> device by predict_async and fetched device ->
        # host by complete (the serving benchmark's wire cost per query;
        # on a mesh, both this rank's rows only)
        self.h2d_bytes_total = 0
        self.d2h_bytes_total = 0
        # the compiled programs (CUDA): key -> GraphProgram, all in one
        # graph memory pool
        self.programs: Dict[tuple, GraphProgram] = {}
        self.graphs = GraphPool(self.device)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, batch: Dict[str, np.ndarray]):
        """batch: collator output. Returns (output_ids [B, mnt], masks: list
        of [n_seg, H, W] logits or None)."""
        return self.complete(self.predict_async(batch))

    def predict_async(self, batch: Dict[str, np.ndarray]):
        """Upload and dispatch the device program; returns a handle whose
        results (this rank's rows) still live on the device, for
        complete(). On a CUDA device a key's later calls only stage, copy,
        replay and clone: nothing is read back before this returns."""
        host, key, B = self._inputs(batch)
        if self.mesh is not None:
            spec = batch_spec(host)     # this rank's rows
            host = {k: np.ascontiguousarray(local_block(v, spec[k],
                                                        self.mesh))
                    for k, v in host.items()}
        self.h2d_bytes_total += sum(v.nbytes for v in host.values())
        if key in self.programs:
            return self._replay(self.programs[key], host, batch, B)
        dev = {k: torch.from_numpy(v).to(self.device)
               for k, v in host.items()}
        with torch.inference_mode():
            loop, finish = self._program(dev)
            meta, low = finish(anyref.run_loop(loop))
        if self.device.type == "cuda":
            # the eager run above was the key's warm-up: its results are
            # this call's, and its inputs become the program's buffers
            self.programs[key] = self._capture(dev)
        return (meta, low), batch, B

    def _inputs(self, batch: Dict[str, np.ndarray]):
        """The program's inputs on the host (the prompts left-padded into
        their bucket, the rows padded to the batch bucket with copies of
        row 0), their key (bucket, batch bucket, sorted (name, dtype)) and
        the batch's real rows."""
        bucket = self._bucket(int(batch["prompt_lens"].max()))
        ids = batch["input_ids"]
        B = ids.shape[0]
        BB = max(next((b for b in self.batch_buckets if b >= B),
                      self.batch_buckets[-1]), B)
        n_data = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        BB = -(-BB // n_data) * n_data     # padded rows split over "data"
        left = np.zeros((BB, bucket), ids.dtype)
        for b in range(B):
            n = min(int(batch["prompt_lens"][b]), bucket)
            left[b, bucket - n:] = ids[b, :n]
        left[B:] = left[0]

        def pad_rows(x):
            if x.shape[0] == BB:
                return x
            return np.concatenate(
                [x, np.repeat(x[:1], BB - x.shape[0], axis=0)], axis=0)

        host = {"input_ids": left,
                "clip_images": pad_rows(batch["clip_images"]),
                "sam_images": pad_rows(batch["sam_images"])}
        for k in ("ref_images", "ref_valid", "audio_mels", "audio_valid",
                  "roi_boxes"):
            if k in batch:
                host[k] = pad_rows(np.asarray(batch[k]))
        if batch["sam_images"].dtype == np.uint8:
            host["sam_resized_sizes"] = pad_rows(
                np.asarray(batch["sam_resized_sizes"], np.int32))
        host = {k: np.ascontiguousarray(v) for k, v in host.items()}
        key = (bucket, BB, tuple(sorted((k, str(v.dtype))
                                        for k, v in host.items())))
        return host, key, B

    def _program(self, dev: dict):
        """The reference's ``run`` up to its decode loop: the device
        normalisation of uint8 images, then generate's prefix. Returns
        (DecodeLoop, finish), finish(carry) -> (meta, low-res masks) packed
        as the reference packs them: ids, [SEG] validity and the pass count
        in one int32 array, the fetched mask slots in the fetch dtype."""
        dev = dict(dev)
        if dev["sam_images"].dtype == torch.uint8:
            dev["sam_images"] = _sam_normalize_device(
                dev["sam_images"], dev.pop("sam_resized_sizes"))
        for k in ("clip_images", "ref_images"):
            if k in dev and dev[k].dtype == torch.uint8:
                dev[k] = clip_vit.normalize_pixels(dev[k].float())
        loop, generated = anyref.generate_program(
            self.params, self.cfg, dev, max_new_tokens=self.mnt,
            speculative=self.speculative, device=self.device,
            encoder_path=self.encoder_path, mesh=self.mesh, **self.gen_kw)

        def finish(carry):
            out = generated(carry)
            low = out.low_res_masks
            if self.fetch_segs is not None:
                low = low[:, :self.fetch_segs]
            B = out.output_ids.shape[0]
            meta = torch.cat([
                out.output_ids.int(), out.seg_valid.int(),
                out.decode_passes.int().reshape(1, 1).expand(B, 1)], 1)
            return meta, low.to(self.mask_fetch_dtype)

        return loop, finish

    def _capture(self, inputs: dict) -> GraphProgram:
        """Capture the program on ``inputs`` (device tensors, which become
        its static inputs) into three graphs in the Predictor's pool and
        stitch them into one with the loop as a WHILE node
        (utils/graphs.py). A capture records kernels and their launch
        counts and runs none; each replay counts what it runs, on the
        device."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            g0, (loop, finish) = self.graphs.capture(
                lambda: self._program(inputs))
            g1, _ = self.graphs.capture(lambda: loop.body(loop.carry))
            g2, outputs = self.graphs.capture(lambda: finish(loop.carry))
        graphs = (g0, g1, g2)
        exec_ = self.graphs.program(graphs, loop.carry["i"],
                                    loop.carry["done"], self.mnt)
        return GraphProgram(inputs, outputs, graphs, exec_,
                            time.perf_counter() - t0)

    def _replay(self, program: GraphProgram, host: dict, batch, B: int):
        """Stage, copy, replay, clone: nothing waits for the device."""
        stage(program.inputs, host)
        program.run(self.graphs)
        return tuple(t.clone() for t in program.outputs), batch, B

    def graph_pool_bytes(self) -> int:
        """Device bytes the programs' memory pool holds (0 before the first
        capture)."""
        return self.graphs.bytes()

    def _gather_rows(self, meta, low):
        """Every data rank's rows, in rank order, on the host: each rank
        sends its fetched rows over the mesh's host group and keeps those
        of the model rank 0 of each data rank (the model ranks of one data
        rank hold the same rows)."""
        mesh = self.mesh
        parts = [None] * mesh.size
        dist.all_gather_object(parts, (meta, low), group=mesh.host_group)
        keep = parts[::mesh.shape[MODEL_AXIS]]
        return (torch.cat([m for m, _ in keep]),
                torch.cat([lo for _, lo in keep]))

    def fetch(self, handle):
        """(meta, low-res masks) of a predict_async handle on the host, the
        whole batch's: this rank's rows read back, then, on a mesh of
        several data ranks, every data rank's gathered in batch order
        (collective: every rank fetches each handle, in dispatch
        order)."""
        (meta, low), _, _ = handle
        self.d2h_bytes_total += sum(t.numel() * t.element_size()
                                    for t in (meta, low))
        meta, low = meta.cpu(), low.cpu()
        if self.mesh is not None and self.mesh.shape[DATA_AXIS] > 1:
            meta, low = self._gather_rows(meta, low)
        return meta, low

    def complete(self, handle):
        """Fetch + host postprocess for a predict_async handle."""
        _, batch, B = handle
        meta, low_res = self.fetch(handle)
        meta_np = meta.numpy()
        low = low_res.float().numpy()[:B]
        output_ids = meta_np[:B, :self.mnt]
        seg_valid = meta_np[:B, self.mnt:-1]
        # the most a data rank took (each data rank decodes its own rows)
        passes = int(meta_np[:, -1].max())
        self.decode_passes_total += passes
        self.completed_batches += 1
        masks: List[Optional[np.ndarray]] = []
        for b in range(low.shape[0]):
            n = min(int(seg_valid[b].sum()), low.shape[1])
            if n == 0:
                masks.append(None)
                continue
            m = batch["_meta"][b]
            rs = tuple(int(v) for v in batch["sam_resized_sizes"][b])
            masks.append(postprocess_low_res_np(
                low[b, :n], self.cfg.sam.image_size, rs,
                (int(m["height"]), int(m["width"]))))
        return output_ids, masks


def binary_mask(logits: Optional[np.ndarray], h: int, w: int) -> np.ndarray:
    """sigmoid > 0.5; None (no [SEG] emitted) -> zero mask."""
    if logits is None:
        return np.zeros((h, w), np.int32)
    return (1.0 / (1.0 + np.exp(-logits[0])) > 0.5).astype(np.int32)
