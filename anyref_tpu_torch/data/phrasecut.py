"""PhraseCut (Visual Genome) referring dataset (port of
anyref_tpu/data/phrasecut.py; reference utils/phrasecut.py RefVGLoader +
utils/phrasecutplus.py — present in the reference but unused by its entry
points; kept for parity).

Expects the public PhraseCut release layout under ``data_root``:
  VGPhraseCut_v0/refer_{split}.json   — tasks with phrase + Polygons
  VGPhraseCut_v0/images/{image_id}.jpg
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from ..tokenizer import seg_answer, seg_question
from .base import SegDataset, load_image_rgb
from .rle import decode, from_polygons, merge


class PhraseCut(SegDataset):
    def __init__(self, data_root: str, split: str = "train",
                 itisseg: bool = False, min_mask_frac: float = 0.0,
                 seed: int = 0):
        super().__init__()
        base = os.path.join(data_root, "VGPhraseCut_v0")
        with open(os.path.join(base, f"refer_{split}.json")) as f:
            self.tasks = json.load(f)
        self.image_root = os.path.join(base, "images")
        self.split = split
        self.itisseg = itisseg
        self.min_mask_frac = min_mask_frac
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.tasks)

    def _get(self, index):
        task = self.tasks[index]
        path = os.path.join(self.image_root, f"{task['image_id']}.jpg")
        image = load_image_rgb(path)
        h, w = image.shape[:2]
        # Polygons: list of polygon groups (one group per instance)
        rles = []
        for group in task.get("Polygons", []):
            for poly in group:
                flat = np.asarray(poly, np.float64).reshape(-1)
                if len(flat) >= 6:
                    rles.append(from_polygons([flat.tolist()], h, w)[0])
        if not rles:
            return None
        mask = decode(merge(rles)) if len(rles) > 1 else decode(rles[0])
        if mask.mean() < self.min_mask_frac:
            return None
        phrase = task["phrase"].strip().lower()
        return self.make_sample(
            image, seg_question(phrase),
            seg_answer(phrase, itisseg=self.itisseg) if self.split == "train"
            else None,
            mask[None].astype(np.uint8), file_name=path, sentence=phrase)
