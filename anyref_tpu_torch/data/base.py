"""Sample construction (port of anyref_tpu/data/base.py make_sample and
the reference-box helpers)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import AnyRefConfig
from .preprocess import (crop_box_np, preprocess_clip_np,
                         preprocess_clip_u8_np, preprocess_sam_np,
                         preprocess_sam_u8_np)


class SegDataset:
    """Builds collator-ready samples. ``uint8_images`` emits clip/sam images
    as uint8 pixels and leaves normalization to the device (the serving
    path's upload is 4x smaller); a reference crop is always the float CLIP
    image, as in the reference."""

    def __init__(self, cfg: Optional[AnyRefConfig] = None,
                 uint8_images: bool = False):
        self.cfg = cfg
        self.uint8_images = uint8_images

    def make_sample(self, image: np.ndarray, question: str,
                    answer: Optional[str], gt_masks: Optional[np.ndarray],
                    file_name: str = "", ref_image: Optional[np.ndarray] = None,
                    ref_bbox: Optional[np.ndarray] = None,
                    audio_mels: Optional[np.ndarray] = None,
                    **extra) -> dict:
        """``ref_image``: a [h, w, 3] uint8 crop; ``ref_bbox``: a normalized
        xyxy box; ``audio_mels``: [clips, 1, mel_bins, target_len]
        (ops.mel.audio_to_mel_clips)."""
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
        if ref_image is not None:
            sample["ref_image"] = preprocess_clip_np(ref_image, clip_size)
        if ref_bbox is not None:
            sample["ref_bbox"] = np.asarray(ref_bbox, np.float32)
        if audio_mels is not None:
            sample["audio_mels"] = audio_mels
        sample.update(extra)
        return sample

    @staticmethod
    def ref_crop(image: np.ndarray, xyxy, mask: Optional[np.ndarray] = None):
        return crop_box_np(image, np.asarray(xyxy, np.float64), mask)


def mask_to_xyxy(mask: np.ndarray) -> np.ndarray:
    """The tight pixel box [x1, y1, x2, y2) of a mask's nonzero pixels;
    zeros for an empty mask."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros(4, np.float64)
    return np.asarray([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                      np.float64)


def normalized_bbox_0_100(xyxy, h: int, w: int) -> np.ndarray:
    """Pixel xyxy -> normalized and scaled to integers 0-100 (the
    reference's [LOC] / RoI encoding, utils/coco_instance.py:431-436)."""
    b = np.asarray(xyxy, np.float64)
    b = b / np.asarray([w, h, w, h], np.float64)
    return np.round(b * 100).astype(np.int64)
