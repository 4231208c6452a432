"""ReasonSeg: reasoning-query segmentation (port of
anyref_tpu/data/reason.py; reference utils/reason.py).

Masks come from per-image polygon JSONs (the reference's missing
``get_mask_from_json`` helper, reconstructed here: LISA-style JSON with
``shapes`` = [{label, points}], where label "target" adds and "ignore"
removes/flags regions); long-sentence vs phrase prompt forms
(reason.py:193-201); train answers from reason_answer_train.txt."""

from __future__ import annotations

import glob
import json
import os
import random

import numpy as np

from .base import SegDataset, load_image_rgb
from .rle import from_polygons, decode


def get_mask_from_json(json_path: str, height: int, width: int):
    """LISA/ReasonSeg annotation JSON -> (mask uint8 [H, W], sentences,
    is_sentence)."""
    with open(json_path) as f:
        ann = json.load(f)
    sents = ann.get("text", [])
    if isinstance(sents, str):
        sents = [sents]
    is_sentence = bool(ann.get("is_sentence", False))
    mask = np.zeros((height, width), np.uint8)
    shapes = sorted(ann.get("shapes", []),
                    key=lambda s: s.get("label") == "ignore")
    for shape in shapes:
        pts = np.asarray(shape.get("points", []), np.float64).reshape(-1)
        if len(pts) < 6:
            continue
        m = decode(from_polygons([pts.tolist()], height, width)[0])
        label = shape.get("label", "target")
        if label == "ignore":
            mask[m > 0] = 255
        else:
            mask[m > 0] = 1
    return mask, sents, is_sentence


class ReasonSeg(SegDataset):
    def __init__(self, data_root: str, split: str = "train",
                 itisseg: bool = True, only1: bool = False, seed: int = 0):
        super().__init__(retry_bad=split == "train")
        self.split = split
        self.itisseg = itisseg
        self._rng = random.Random(seed)
        root = os.path.join(data_root, split)
        self.json_paths = sorted(glob.glob(os.path.join(root, "*.json")))
        self.answers = [""] * len(self.json_paths)
        if split == "train":
            ans_file = os.path.join(data_root, "reason_answer_train.txt")
            if os.path.exists(ans_file):
                with open(ans_file) as f:
                    self.answers = [a.strip() for a in f]
        if only1:
            i = self._rng.randrange(len(self.json_paths))
            self.json_paths = self.json_paths[i:i + 1]
            self.answers = self.answers[i:i + 1]

    def __len__(self):
        return len(self.json_paths)

    def _get(self, index):
        json_path = self.json_paths[index]
        image_path = json_path.replace(".json", ".jpg")
        image = load_image_rgb(image_path)
        h, w = image.shape[:2]
        mask, sents, is_sentence = get_mask_from_json(json_path, h, w)
        if not sents:
            return None
        sent = self._rng.choice(sents) if len(sents) > 1 else sents[0]
        mask = (mask == 1).astype(np.uint8)
        # prompt forms (reference reason.py:193-201)
        if is_sentence:
            q = f"<image>\n{sent} Can you segment it in this image?"
        else:
            q = f"<image>\nCan you segment {sent} in this image?"
        gt_answer = self.answers[index] if index < len(self.answers) else ""
        if self.itisseg or gt_answer == "":
            a = "it is [SEG]."
        else:
            a = f"{gt_answer}[SEG]."
        return self.make_sample(image, q, a if self.split == "train" else None,
                                mask[None], file_name=image_path,
                                sentence=sent)
