"""Prompt-mode batch collator (port of anyref_tpu/data/collator.py with
train=False): samples -> fixed-shape numpy batches for the Predictor.

input_ids pad on the right to cfg.max_text_len (the Predictor re-pads them
on the left into its prompt bucket); images stack as they come (float or
uint8).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..config import AnyRefConfig
from ..tokenizer import PAD_ID, AnyRefTokenizer, tokenize_prompt


class Collator:
    def __init__(self, tokenizer: AnyRefTokenizer, cfg: AnyRefConfig):
        self.tok = tokenizer
        self.cfg = cfg

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        B = len(instances)
        T = self.cfg.max_text_len
        input_ids = np.full((B, T), PAD_ID, np.int32)
        prompt_lens = np.zeros((B,), np.int32)
        orig_masks, meta = [], []
        for b, inst in enumerate(instances):
            ids = tokenize_prompt(self.tok, inst["question"])
            if len(ids) > T:
                raise ValueError(
                    f"prompt is {len(ids)} tokens > max_text_len {T}; raise "
                    f"cfg.max_text_len or shorten the prompt")
            input_ids[b, :len(ids)] = ids
            prompt_lens[b] = len(ids)
            masks = inst.get("gt_masks")
            orig_masks.append(None if masks is None else np.asarray(masks))
            meta.append({k: inst.get(k) for k in
                         ("file_name", "height", "width", "image_id",
                          "sentence")})
        return {
            "input_ids": input_ids,
            "prompt_lens": prompt_lens,
            "clip_images": np.stack([i["clip_image"] for i in instances]),
            "sam_images": np.stack([i["sam_image"] for i in instances]),
            "sam_resized_sizes": np.asarray(
                [i["sam_resized_size"] for i in instances], np.int32),
            # host-side extras for eval, never uploaded
            "_orig_masks": orig_masks,
            "_meta": meta,
        }
