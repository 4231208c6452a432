"""Predictor: prompt batch -> generated ids + original-size mask logits
(port of anyref_tpu/eval/runner.py).

Prompts are left-padded into length buckets and batches into batch buckets
(padding rows copy row 0 and are dropped), so the shapes the device sees come
from a small fixed set. uint8 images are normalized on the device. The
fetch packs ids, [SEG] validity and the decode pass count into one int32
array; the variable-shape tail (crop the padded canvas, resize to each
image's size) runs on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import (SAM_PIXEL_MEAN, SAM_PIXEL_STD, AnyRefConfig,
                      check_encoder_path)
from ..models import anyref, clip_vit
from ..ops.quant import is_quantized
from ..ops.resize import postprocess_low_res_np
from ..params import resolve_device


def _sam_normalize_device(x_u8, resized_sizes):
    """Normalize uint8 SAM canvases and re-zero the pad beyond each row's
    resized extent (the host pipeline's normalize-then-pad order)."""
    S = x_u8.shape[-1]
    dev = x_u8.device
    mean = torch.tensor(SAM_PIXEL_MEAN, device=dev).reshape(1, 3, 1, 1)
    std = torch.tensor(SAM_PIXEL_STD, device=dev).reshape(1, 3, 1, 1)
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
                 device="cuda", encoder_path: str = "fused"):
        # buckets = 1 (mod 128): the +255 image expansion lands prefill on
        # multiples of 128 (384/448/512/640/768)
        self.device = resolve_device(device)
        self.encoder_path = check_encoder_path(encoder_path)
        if speculative and is_quantized(params["llama"]):
            # the reference's speculative Predictor first converts the
            # decoder to its bf16 serving layout (transposed, fused
            # matrices), which an int8 tree does not have
            raise ValueError(
                "an int8 decoder (ops.quant.quantize_llama) is served with "
                "speculative=False: the reference's speculative serving "
                "needs the bf16 serving layout of the decoder")
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
        # host by complete (the serving benchmark's wire cost per query)
        self.h2d_bytes_total = 0
        self.d2h_bytes_total = 0

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
        """Upload and run the device program; returns a handle whose results
        still live on the device, for complete()."""
        bucket = self._bucket(int(batch["prompt_lens"].max()))
        ids = batch["input_ids"]
        B = ids.shape[0]
        BB = max(next((b for b in self.batch_buckets if b >= B),
                      self.batch_buckets[-1]), B)
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
        if batch["sam_images"].dtype == np.uint8:
            host["sam_resized_sizes"] = pad_rows(
                np.asarray(batch["sam_resized_sizes"], np.int32))
        self.h2d_bytes_total += sum(int(v.nbytes) for v in host.values())
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in host.items()}
        if dev["sam_images"].dtype == torch.uint8:
            dev["sam_images"] = _sam_normalize_device(
                dev["sam_images"], dev.pop("sam_resized_sizes"))
        if dev["clip_images"].dtype == torch.uint8:
            dev["clip_images"] = clip_vit.normalize_pixels(
                dev["clip_images"].float())
        out = anyref.generate(self.params, self.cfg, dev,
                              max_new_tokens=self.mnt,
                              speculative=self.speculative,
                              device=self.device,
                              encoder_path=self.encoder_path, **self.gen_kw)
        low = out.low_res_masks
        if self.fetch_segs is not None:
            low = low[:, :self.fetch_segs]
        meta = torch.cat([
            out.output_ids.int(), out.seg_valid.int(),
            torch.full((BB, 1), out.decode_passes, dtype=torch.int32,
                       device=self.device)], 1)
        return (meta, low.to(self.mask_fetch_dtype)), batch, B

    def complete(self, handle):
        """Fetch + host postprocess for a predict_async handle."""
        (meta, low_res), batch, B = handle
        self.d2h_bytes_total += sum(t.numel() * t.element_size()
                                    for t in (meta, low_res))
        meta_np = meta.cpu().numpy()
        low = low_res.float().cpu().numpy()[:B]
        output_ids = meta_np[:B, :self.mnt]
        seg_valid = meta_np[:B, self.mnt:-1]
        self.decode_passes_total += int(meta_np[0, -1])
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
