"""COCO instance/semantic datasets + image-reference (inverse) variant +
the reference-sample index builder (port of anyref_tpu/data/coco.py;
reference utils/coco_instance.py:246-869, samples.py)."""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from ..tokenizer import img_ref_question, seg_question
from .base import SegDataset, load_image_rgb
from .categories import COCO_THING_CLASSES
from .refer import CocoIndex


class CocoInstances:
    """Shared COCO index with mask decoding and empty-image filtering
    (reference COCOIns, utils/coco_instance.py:246-326)."""

    def __init__(self, image_root: str, json_file: str,
                 filter_area: Optional[float] = None):
        self.image_root = image_root
        self.coco = CocoIndex(json_file)
        self.filter_area = filter_area
        self.ids = sorted(i for i in self.coco.imgs
                          if self.coco.img_to_anns.get(i))

    def __len__(self):
        return len(self.ids)

    def load(self, index: int) -> Optional[dict]:
        image_id = self.ids[index]
        info = self.coco.imgs[image_id]
        h, w = info["height"], info["width"]
        boxes, classes, masks = [], [], []
        for ann in self.coco.img_to_anns[image_id]:
            if ann.get("iscrowd", 0):
                continue
            m = self.coco.ann_to_mask(ann)
            if self.filter_area is not None and m.sum() / (h * w) < self.filter_area:
                continue
            masks.append(m)
            classes.append(ann["category_id"])
            x, y, bw, bh = ann["bbox"]
            boxes.append([x, y, x + bw, y + bh])
        if not masks:
            return None
        return {
            "image_id": image_id,
            "file_name": os.path.join(self.image_root, info["file_name"]),
            "height": h, "width": w,
            "bbox_xyxy": np.asarray(boxes, np.float64),
            "gt_classes": np.asarray(classes, np.int64),
            "gt_masks": np.stack(masks).astype(np.uint8),
        }


class CocoInstanceSeg(SegDataset):
    """'Can you segment {class}?' -> '{class}[SEG],...' per instance
    (reference COCOInstanceTokenized, utils/coco_instance.py:329-570)."""

    def __init__(self, image_root: str, json_file: str,
                 filter_area: Optional[float] = 0.01,
                 sampled_class_num: int = 1, max_instances: int = 8,
                 use_loc_tokens: bool = False, overfit: bool = False,
                 unexist_prob: float = 0.0, seed: int = 0):
        super().__init__()
        self.index = CocoInstances(image_root, json_file, filter_area)
        self.sampled_class_num = sampled_class_num
        self.max_instances = max_instances
        self.use_loc = use_loc_tokens
        self.overfit = overfit
        self.unexist_prob = unexist_prob
        self._rng = random.Random(seed)

    def __len__(self):
        return 40000 if self.overfit else len(self.index)

    def _get(self, index):
        rec = self.index.load(0 if self.overfit else index)
        if rec is None:
            return None
        image = load_image_rgb(rec["file_name"])
        uniq = sorted(set(rec["gt_classes"].tolist()))
        if self._rng.random() < self.unexist_prob:
            # negative sampling: ask for a class absent from the image
            # (reference utils/coco_instance.py:451-458, dormant p=0.0)
            absent = [c for c in COCO_THING_CLASSES if c not in uniq]
            name = COCO_THING_CLASSES[self._rng.choice(absent)]
            return self.make_sample(
                image, seg_question(name),
                f"there is no {name} in this image.", None,
                file_name=rec["file_name"], gt_classes=[name])
        n = min(self.sampled_class_num, len(uniq))
        sampled = self._rng.sample(uniq, n)
        names, parts, masks = [], [], []
        for c in sampled:
            sel = rec["gt_classes"] == c
            name = COCO_THING_CLASSES.get(c, str(c))
            names.append(name)
            texts = []
            count = 0
            for i in np.nonzero(sel)[0]:
                if count >= self.max_instances:
                    break
                if self.use_loc:
                    b = rec["bbox_xyxy"][i] / np.asarray(
                        [rec["width"], rec["height"]] * 2)
                    locs = "".join(f"[LOC{int(round(v * 100))}]" for v in b)
                    texts.append(f"{name}{locs}[SEG]")
                else:
                    texts.append(f"{name}[SEG]")
                masks.append(rec["gt_masks"][i])
                count += 1
            parts.append(",".join(texts))
        class_text = names[0] if n == 1 else \
            ", ".join(names[:-1]) + f" and {names[-1]}"
        answer_text = parts[0] if n == 1 else \
            ", ".join(parts[:-1]) + f" and {parts[-1]}"
        return self.make_sample(
            image, seg_question(class_text), f"{answer_text}.",
            np.stack(masks).astype(np.uint8), file_name=rec["file_name"],
            gt_classes=names)


class CocoSemanticSeg(SegDataset):
    """Instances merged per class (reference COCOSemantic,
    utils/coco_instance.py:587-683)."""

    def __init__(self, image_root: str, json_file: str,
                 filter_area: Optional[float] = 0.01,
                 sampled_class_num: int = 1, itisseg: bool = False,
                 seed: int = 0):
        super().__init__()
        self.index = CocoInstances(image_root, json_file, filter_area)
        self.sampled_class_num = sampled_class_num
        self.itisseg = itisseg
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.index)

    def semantic_record(self, index: int) -> Optional[dict]:
        rec = self.index.load(index)
        if rec is None:
            return None
        classes, masks, boxes, single = [], [], [], []
        for c in sorted(set(rec["gt_classes"].tolist())):
            sel = rec["gt_classes"] == c
            classes.append(c)
            masks.append(rec["gt_masks"][sel].max(axis=0))
            only = sel.sum() == 1
            single.append(bool(only))
            boxes.append(rec["bbox_xyxy"][sel][0] if only else np.zeros(4))
        rec.update(sem_classes=classes, sem_masks=np.stack(masks),
                   sem_boxes=np.stack(boxes), sem_single=single)
        return rec

    def _get(self, index):
        rec = self.semantic_record(index)
        if rec is None:
            return None
        image = load_image_rgb(rec["file_name"])
        i = self._rng.randrange(len(rec["sem_classes"]))
        name = COCO_THING_CLASSES.get(rec["sem_classes"][i], "object")
        answer = "it is [SEG]." if self.itisseg else f"{name}[SEG]."
        return self.make_sample(
            image, seg_question(name), answer,
            rec["sem_masks"][i:i + 1].astype(np.uint8),
            file_name=rec["file_name"], gt_classes=[name])


class CocoImageRefSeg(SegDataset):
    """Image-reference referring: query image + a same-class reference crop
    from a prebuilt index (reference COCOSemantic_inv_Tokenized,
    utils/coco_instance.py:599-869; index built by build_ref_index below,
    replacing samples.py)."""

    def __init__(self, image_root: str, json_file: str, ref_index_file: str,
                 apply_mask_prob: float = 0.0, person_keep_frac: float = 0.1,
                 seed: int = 0):
        super().__init__()
        # filter_area=None: the image-ref pathway runs UNFILTERED on both
        # sides in the reference (samples.py builds via COCOSemantic()
        # defaults, train.py's coco_inv passes no filter_area), and the
        # (img_idx, ann_idx) pairs in the index are positions in the
        # UNfiltered ann list — a filtered consumer would shift them
        self.sem = CocoSemanticSeg(image_root, json_file, filter_area=None)
        with open(ref_index_file) as f:
            self.ref_index: Dict[str, List] = json.load(f)
        self._rng = random.Random(seed)
        # "too many person": subsample (reference coco_instance.py:614-617)
        if "1" in self.ref_index and person_keep_frac < 1.0:
            lst = self.ref_index["1"]
            self.ref_index["1"] = self._rng.sample(
                lst, max(1, int(len(lst) * person_keep_frac)))
        self.apply_mask_prob = apply_mask_prob

    def __len__(self):
        return len(self.sem)

    def _get(self, index):
        rec = self.sem.semantic_record(index)
        if rec is None:
            return None
        image = load_image_rgb(rec["file_name"])
        candidates = [i for i, c in enumerate(rec["sem_classes"])
                      if str(c) in self.ref_index]
        if not candidates:
            return None
        i = self._rng.choice(candidates)
        cls = rec["sem_classes"][i]
        ref_img_idx, ref_ann_idx = self._rng.choice(self.ref_index[str(cls)])
        ref_rec = self.sem.index.load(ref_img_idx)
        if ref_rec is None or ref_ann_idx >= len(ref_rec["gt_classes"]) or \
                ref_rec["gt_classes"][ref_ann_idx] != cls:
            return None
        ref_image = load_image_rgb(ref_rec["file_name"])
        mask = None
        if self._rng.random() < self.apply_mask_prob:
            mask = ref_rec["gt_masks"][ref_ann_idx]
        box = ref_rec["bbox_xyxy"][ref_ann_idx]
        crop = self.ref_crop(ref_image, box + np.asarray([1, 1, -1, -1]),
                             mask)
        name = COCO_THING_CLASSES.get(cls, "object")
        return self.make_sample(
            image, img_ref_question(), f"{name}[SEG].",
            rec["sem_masks"][i:i + 1].astype(np.uint8),
            file_name=rec["file_name"], ref_image=crop, gt_classes=[name])


def build_ref_index(image_root: str, json_file: str, out_file: str,
                    box_img_threshold: float = 0.1,
                    mask_box_threshold: float = 0.4) -> dict:
    """Build the reference-sample index (replaces samples.py: classes ->
    [(img_idx, ann_idx)] where box/img area > thr1 and mask/box > thr2,
    single-instance classes only; reference coco_instance.py:635-650).

    filter_area=None matches the consumers (CocoImageRefSeg, Coco20i):
    ann_idx positions are only meaningful against the same filtering."""
    index = CocoInstances(image_root, json_file, filter_area=None)
    out: Dict[str, List] = {}
    for i in range(len(index)):
        rec = index.load(i)
        if rec is None:
            continue
        classes = rec["gt_classes"]
        for c in set(classes.tolist()):
            sel = np.nonzero(classes == c)[0]
            if len(sel) != 1:
                continue
            j = int(sel[0])
            x1, y1, x2, y2 = rec["bbox_xyxy"][j]
            box_area = (x2 - x1) * (y2 - y1)
            img_area = rec["height"] * rec["width"]
            if box_area <= 0:
                continue
            if (box_area / img_area > box_img_threshold and
                    rec["gt_masks"][j].sum() / box_area > mask_box_threshold):
                out.setdefault(str(c), []).append((i, j))
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out
