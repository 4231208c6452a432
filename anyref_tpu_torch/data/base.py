"""Dataset base (port of anyref_tpu/data/base.py): image IO (PIL, imported
where an image is read), the bad-sample retry and the sample template every
dataset shares."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from ..config import AnyRefConfig
from .preprocess import (crop_box_np, preprocess_clip_np,
                         preprocess_clip_u8_np, preprocess_sam_np,
                         preprocess_sam_u8_np)


def load_image_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


class SegDataset:
    """Base: a reader implements ``__len__`` and ``_get(index)``, which
    returns a sample from ``make_sample`` or None for a bad one.
    ``uint8_images`` emits clip/sam images as uint8 pixels and leaves
    normalization to the device (the serving path's upload is 4x smaller);
    a reference crop is always the float CLIP image, as in the
    reference."""

    def __init__(self, cfg: Optional[AnyRefConfig] = None,
                 retry_bad: bool = True, uint8_images: bool = False):
        self.cfg = cfg
        self.retry_bad = retry_bad
        self.uint8_images = uint8_images
        self._rng = random.Random(0)

    def __getitem__(self, index: int) -> dict:
        """The sample at ``index``; a missing file or a bad sample moves to
        a random index, up to 32 tries (the reference's recursion to a
        random index, utils/coco_instance.py:399-400); one try without
        ``retry_bad``."""
        for _ in range(32 if self.retry_bad else 1):
            try:
                out = self._get(index)
            except FileNotFoundError:
                out = None
            if out is not None:
                return out
            index = self._rng.randrange(len(self))
        raise RuntimeError(f"{type(self).__name__}: no valid sample found")

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
