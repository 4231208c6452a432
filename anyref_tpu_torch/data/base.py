"""Sample construction (port of anyref_tpu/data/base.py make_sample, text
prompts)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import AnyRefConfig
from .preprocess import (preprocess_clip_np, preprocess_clip_u8_np,
                         preprocess_sam_np, preprocess_sam_u8_np)


class SegDataset:
    """Builds collator-ready samples. ``uint8_images`` emits clip/sam images
    as uint8 pixels and leaves normalization to the device (the serving
    path's upload is 4x smaller)."""

    def __init__(self, cfg: Optional[AnyRefConfig] = None,
                 uint8_images: bool = False):
        self.cfg = cfg
        self.uint8_images = uint8_images

    def make_sample(self, image: np.ndarray, question: str,
                    answer: Optional[str], gt_masks: Optional[np.ndarray],
                    file_name: str = "", **extra) -> dict:
        sam_size = self.cfg.sam.image_size if self.cfg else 1024
        clip_size = self.cfg.clip.image_size if self.cfg else 224
        if self.uint8_images:
            sam_image, resized = preprocess_sam_u8_np(image, sam_size)
            clip_image = preprocess_clip_u8_np(image, clip_size)
        else:
            sam_image, resized = preprocess_sam_np(image, sam_size)
            clip_image = preprocess_clip_np(image, clip_size)
        sample = {
            "clip_image": clip_image,
            "sam_image": sam_image,
            "sam_resized_size": resized,
            "question": question,
            "answer": answer,
            "gt_masks": gt_masks,
            "height": image.shape[0],
            "width": image.shape[1],
            "file_name": file_name,
        }
        sample.update(extra)
        return sample
