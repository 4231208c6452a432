"""ADE20K instance/semantic datasets (port of anyref_tpu/data/ade.py;
reference utils/ade_instance.py, utils/ade_semantic.py): instance ids from
the 2-channel PNG (channel 0 = category, channel 1 = instance id); semantic
classes from the label PNG. Each reader draws its class from
``random.Random(seed)`` in the JAX readers' order, so one seed and one
order of reads pick the same class in both packages."""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from ..tokenizer import seg_answer, seg_question
from .base import SegDataset, load_image_rgb
from .categories import ADE_INSTANCE_CLASSES, ADE_SEMANTIC_CLASSES


def _list_images(image_root: str, label_root: str):
    """(images, labels): the .jpg files of ``image_root`` in name order
    that have a .png of the same name in ``label_root``."""
    images, labels = [], []
    for name in sorted(os.listdir(image_root)):
        if not name.endswith(".jpg"):
            continue
        lbl = os.path.join(label_root, name.replace(".jpg", ".png"))
        if os.path.exists(lbl):
            images.append(os.path.join(image_root, name))
            labels.append(lbl)
    return images, labels


class AdeInstanceSeg(SegDataset):
    def __init__(self, image_root: str, label_root: str,
                 filter_area: Optional[float] = 0.01,
                 sampled_class_num: int = 1, max_instances: int = 8,
                 seed: int = 0):
        super().__init__()
        self.images, self.labels = _list_images(image_root, label_root)
        self.filter_area = filter_area
        self.sampled_class_num = sampled_class_num
        self.max_instances = max_instances
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.images)

    def _get(self, index):
        from PIL import Image
        with Image.open(self.labels[index]) as im:
            seg = np.asarray(im)
        cat_ids, ins_ids = seg[..., 0], seg[..., 1]
        classes, masks = [], []
        for tid in np.unique(ins_ids):
            if tid == 0:
                continue
            m = ins_ids == tid
            if self.filter_area and m.mean() < self.filter_area:
                continue
            cid = int(np.unique(cat_ids[m])[0])
            classes.append(cid)
            masks.append(m.astype(np.uint8))
        if not masks:
            return None
        image = load_image_rgb(self.images[index])
        classes = np.asarray(classes)
        uniq = sorted(set(classes.tolist()))
        sampled = self._rng.sample(uniq, min(self.sampled_class_num, len(uniq)))
        names, parts, out_masks = [], [], []
        for c in sampled:
            name = ADE_INSTANCE_CLASSES.get(c, str(c))
            names.append(name)
            idxs = [i for i, cc in enumerate(classes) if cc == c][: self.max_instances]
            parts.append(",".join(f"{name}[SEG]" for _ in idxs))
            out_masks.extend(masks[i] for i in idxs)
        class_text = names[0] if len(names) == 1 else \
            ", ".join(names[:-1]) + f" and {names[-1]}"
        answer = (parts[0] if len(parts) == 1 else
                  ", ".join(parts[:-1]) + f" and {parts[-1]}") + "."
        return self.make_sample(image, seg_question(class_text), answer,
                                np.stack(out_masks),
                                file_name=self.images[index],
                                gt_classes=names)


class AdeSemanticSeg(SegDataset):
    def __init__(self, image_root: str, label_root: str,
                 filter_area: Optional[float] = 0.01, itisseg: bool = False,
                 seed: int = 0):
        super().__init__()
        self.images, self.labels = _list_images(image_root, label_root)
        self.filter_area = filter_area
        self.itisseg = itisseg
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.images)

    def _get(self, index):
        from PIL import Image
        with Image.open(self.labels[index]) as im:
            label = np.asarray(im)
        classes, masks = [], []
        for tid in np.unique(label):
            if tid == 0:
                continue
            m = label == tid
            if self.filter_area and m.mean() < self.filter_area:
                continue
            classes.append(int(tid))
            masks.append(m.astype(np.uint8))
        if not masks:
            return None
        image = load_image_rgb(self.images[index])
        i = self._rng.randrange(len(classes))
        cid = classes[i]
        name = (ADE_SEMANTIC_CLASSES[cid - 1]
                if 1 <= cid <= len(ADE_SEMANTIC_CLASSES) else str(cid))
        return self.make_sample(image, seg_question(name),
                                seg_answer(name, itisseg=self.itisseg),
                                masks[i][None], file_name=self.images[index],
                                gt_classes=[name])
