"""Batch collator (port of anyref_tpu/data/collator.py): samples ->
fixed-shape numpy batches.

Prompt mode (``train=False``, the default here; the Predictor's input):
input_ids pad on the right to cfg.max_text_len (the Predictor re-pads them
on the left into its prompt bucket). Train mode (``train=True``): the whole
conversation with its labels (IGNORE_INDEX outside the answer), ground-truth
masks packed to a fixed budget [B, S, g, g] on the SAM canvas with
``mask_valid`` [B, S], and ``sam_resized_sizes`` for the in-image pixel
mask. Images stack as they come (float or uint8).

References: where any sample carries one, ``ref_images`` [B, 3, 224, 224]
(crops; without ``roi``) or ``roi_boxes`` [B, 4] (normalized boxes; with
``roi``, and only where some row has a box) come with ``ref_valid`` [B], and
``audio_mels`` [B, 3, 1, 128, 204] with ``audio_valid`` [B]; rows without
one are zeros and not valid. With ``roi`` a crop is ignored, and without
it a box, as in the reference.
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
                 train: bool = False, roi: bool = False):
        self.tok = tokenizer
        self.cfg = cfg
        self.train = train
        self.roi = roi

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
        has_ref = any("ref_image" in i or "ref_bbox" in i for i in instances)
        has_audio = any("audio_mels" in i for i in instances)
        ref_images = audio_mels = None
        ref_valid = np.zeros((B,), bool)
        audio_valid = np.zeros((B,), bool)
        if has_ref and not self.roi:
            c = cfg.clip.image_size
            ref_images = np.zeros((B, 3, c, c), np.float32)
        roi_boxes = np.zeros((B, 4), np.float32) if self.roi else None
        if has_audio and cfg.audio is not None:
            a = cfg.audio
            audio_mels = np.zeros((B, a.clips_per_audio, 1, a.mel_bins,
                                   a.target_len), np.float32)
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
            if self.roi and "ref_bbox" in inst:
                roi_boxes[b] = inst["ref_bbox"]
                ref_valid[b] = True
            elif ref_images is not None and "ref_image" in inst:
                ref_images[b] = inst["ref_image"]
                ref_valid[b] = True
            if audio_mels is not None and "audio_mels" in inst:
                audio_mels[b] = inst["audio_mels"]
                audio_valid[b] = True
            meta.append({k: inst.get(k) for k in
                         ("file_name", "height", "width", "image_id",
                          "gt_classes", "sentence", "video_name",
                          "orig_ref_img")})
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
        if ref_images is not None:
            batch.update(ref_images=ref_images, ref_valid=ref_valid)
        if roi_boxes is not None and ref_valid.any():
            batch.update(roi_boxes=roi_boxes, ref_valid=ref_valid)
        if audio_mels is not None:
            batch.update(audio_mels=audio_mels, audio_valid=audio_valid)
        # host-side extras for eval, never uploaded
        batch["_orig_masks"] = orig_masks
        batch["_meta"] = meta
        return batch
