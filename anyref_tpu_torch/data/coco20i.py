"""COCO-20i one-shot segmentation (port of anyref_tpu/data/coco20i.py;
reference utils/coco20i.py:205-458):
query image from FSS split lists; support = a random same-class reference
crop; image-reference prompt."""

from __future__ import annotations

import json
import os
import random

import numpy as np

from ..tokenizer import img_ref_question
from .base import SegDataset, load_image_rgb
from .categories import COCO_THING_CLASSES
from .coco import CocoSemanticSeg


def coco20i_split_ids(split: int) -> list[int]:
    """FSS split s: contiguous class indices s+1, s+5, ... mapped to original
    COCO category ids (reference coco20i.py:32-51)."""
    thing_ids = list(COCO_THING_CLASSES.keys())
    return [thing_ids[i - 1] for i in range(split + 1, 81, 4)]


class Coco20i(SegDataset):
    def __init__(self, image_root: str, json_file: str, ref_index_file: str,
                 fss_list_root: str, split: int = 0, mode: str = "val",
                 apply_mask: bool = False, min_mask_frac: float = 0.1,
                 seed: int = 0):
        super().__init__()
        # filter_area=None: the ref_index ann positions are built unfiltered
        # (coco.build_ref_index), and the reference's mycoco20i also runs
        # unfiltered (utils/coco20i.py:308 default None)
        self.sem = CocoSemanticSeg(image_root, json_file, filter_area=None)
        with open(os.path.join(fss_list_root, mode,
                               f"data_list_{split}.txt")) as f:
            self.data_list = [tuple(line.split()) for line in f
                              if line.strip()]
        with open(ref_index_file) as f:
            self.ref_index = json.load(f)
        self.split_ids = set(coco20i_split_ids(split))
        self.apply_mask = apply_mask
        self.min_mask_frac = min_mask_frac
        self._rng = random.Random(seed)
        self._id_to_index = {iid: i for i, iid in enumerate(self.sem.index.ids)}

    def __len__(self):
        return len(self.data_list)

    def _get(self, index):
        image_path, _ = self.data_list[index]
        image_id = int(os.path.basename(image_path).split(".")[0][-12:])
        rec_idx = self._id_to_index.get(image_id)
        if rec_idx is None:
            return None
        rec = self.sem.semantic_record(rec_idx)
        if rec is None:
            return None
        # the reference's selection loop overwrites gt_class on every match
        # (utils/coco20i.py:249-252), so the LAST split-class present in the
        # image's semantic record is the one evaluated — match that exactly
        gt_i = next((i for i in range(len(rec["sem_classes"]) - 1, -1, -1)
                     if rec["sem_classes"][i] in self.split_ids), None)
        if gt_i is None:
            return None
        gt_mask = rec["sem_masks"][gt_i]
        if gt_mask.sum() / gt_mask.size < self.min_mask_frac:
            return None   # reference's area filter (coco20i.py:256-259)
        cls = rec["sem_classes"][gt_i]
        refs = self.ref_index.get(str(cls))
        if not refs:
            return None
        ref_img_idx, ref_ann_idx = self._rng.choice(refs)
        ref_rec = self.sem.index.load(ref_img_idx)
        if (ref_rec is None or ref_ann_idx >= len(ref_rec["gt_classes"])
                or ref_rec["gt_classes"][ref_ann_idx] != cls):
            return None
        ref_image = load_image_rgb(ref_rec["file_name"])
        mask = ref_rec["gt_masks"][ref_ann_idx] if self.apply_mask else None
        box = ref_rec["bbox_xyxy"][ref_ann_idx] + np.asarray([1, 1, -1, -1])
        crop = self.ref_crop(ref_image, box, mask)

        image = load_image_rgb(rec["file_name"])
        name = COCO_THING_CLASSES.get(cls, "object")
        return self.make_sample(
            image, img_ref_question(), f"{name}[SEG].",
            gt_mask[None].astype(np.uint8), file_name=rec["file_name"],
            ref_image=crop, gt_classes=[name],
            orig_ref_img=crop)  # raw crop for qualitative dumps
                                # (reference eval_coco20i.py:175-178)
