"""Batch collator (port of anyref_tpu/data/collator.py, text references):
samples -> fixed-shape numpy batches.

Prompt mode (``train=False``, the default here; the Predictor's input):
input_ids pad on the right to cfg.max_text_len (the Predictor re-pads them
on the left into its prompt bucket). Train mode (``train=True``): the whole
conversation with its labels (IGNORE_INDEX outside the answer), ground-truth
masks packed to a fixed budget [B, S, g, g] on the SAM canvas with
``mask_valid`` [B, S], and ``sam_resized_sizes`` for the in-image pixel
mask. Images stack as they come (float or uint8).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..config import IGNORE_INDEX, AnyRefConfig
from ..tokenizer import (PAD_ID, AnyRefTokenizer, tokenize_conversation,
                         tokenize_prompt)
from .preprocess import mask_to_canvas_np


class Collator:
    def __init__(self, tokenizer: AnyRefTokenizer, cfg: AnyRefConfig,
                 train: bool = False):
        self.tok = tokenizer
        self.cfg = cfg
        self.train = train

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = len(instances)
        T = cfg.max_text_len
        S = cfg.max_seg_per_sample
        g = cfg.sam.image_size
        input_ids = np.full((B, T), PAD_ID, np.int32)
        labels = np.full((B, T), IGNORE_INDEX, np.int32)
        prompt_lens = np.zeros((B,), np.int32)
        sizes = np.asarray([i["sam_resized_size"] for i in instances],
                           np.int32)
        if self.train:
            gt_masks = np.zeros((B, S, g, g), np.float32)
            mask_valid = np.zeros((B, S), bool)
        orig_masks, meta = [], []
        for b, inst in enumerate(instances):
            if self.train:
                tc = tokenize_conversation(self.tok, inst["question"],
                                           inst["answer"])
                ids, labs = tc.input_ids, tc.labels
                prompt_lens[b] = tc.prompt_len
            else:
                ids = tokenize_prompt(self.tok, inst["question"])
                labs = None
                prompt_lens[b] = len(ids)
            # cutting the tail would lose the answer, or at eval hand the
            # Predictor a prompt cut off before "ASSISTANT:"
            if len(ids) > T:
                raise ValueError(
                    f"{'conversation' if self.train else 'prompt'} is "
                    f"{len(ids)} tokens > max_text_len {T}; raise "
                    f"cfg.max_text_len or shorten it")
            input_ids[b, :len(ids)] = ids
            if labs is not None:
                labels[b, :len(ids)] = labs
            masks = inst.get("gt_masks")
            if self.train and masks is not None:
                for s in range(min(len(masks), S)):
                    gt_masks[b, s] = mask_to_canvas_np(
                        masks[s], tuple(sizes[b]), g)
                    mask_valid[b, s] = True
            orig_masks.append(None if masks is None else np.asarray(masks))
            meta.append({k: inst.get(k) for k in
                         ("file_name", "height", "width", "image_id",
                          "sentence")})
        batch = {
            "input_ids": input_ids,
            "prompt_lens": prompt_lens,
            "clip_images": np.stack([i["clip_image"] for i in instances]),
            "sam_images": np.stack([i["sam_image"] for i in instances]),
            "sam_resized_sizes": sizes,
        }
        if self.train:
            batch.update(labels=labels, gt_masks=gt_masks,
                         mask_valid=mask_valid)
        # host-side extras for eval, never uploaded
        batch["_orig_masks"] = orig_masks
        batch["_meta"] = meta
        return batch
