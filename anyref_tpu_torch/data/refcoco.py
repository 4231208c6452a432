"""refCOCO-family datasets (port of anyref_tpu/data/refcoco.py): text
referring segmentation and the inverse region-captioning task (reference
utils/refer_seg.py, utils/refer_seg_invert.py). The readers draw from
``random.Random(seed)`` in the JAX readers' order, so one seed picks the
same sentence and ref in both packages.
"""

from __future__ import annotations

import os
import random
import numpy as np

from ..tokenizer import region_caption_question, seg_answer, seg_question
from .base import SegDataset, load_image_rgb, mask_to_xyxy
from .refer import open_refer


def _coco_train2017_path(data_root: str, image_info: dict) -> str:
    return os.path.join(data_root, "coco/train2017",
                        f"{str(image_info['id']).zfill(12)}.jpg")


def _image_path(data_root: str, dataset: str, image_info: dict) -> str:
    """refclef images live under saiapr_tc-12 (reference refer_seg.py:69-71);
    every other family shares coco/train2017."""
    if dataset == "refclef":
        return os.path.join(data_root, "saiapr_tc-12",
                            image_info["file_name"])
    return _coco_train2017_path(data_root, image_info)


class RefCocoTrain(SegDataset):
    """Training referring-seg over refcoco/refcoco+/refcocog/refclef (+
    grefcoco). One image per item; a random sentence per ref at train time
    (reference refer_seg.py:129-134)."""

    def __init__(self, data_root: str, datasets: str = "refcoco,refcoco+,refcocog,refclef",
                 split: str = "train", itisseg: bool = False,
                 all_sentences: bool = False, seed: int = 0):
        super().__init__()
        self.data_root = data_root
        self.itisseg = itisseg
        self.all_sentences = all_sentences
        self._rng = random.Random(seed)
        self.entries = []  # (api, image_info, refs, file_name)
        for name in datasets.split(","):
            api = open_refer(data_root, name)
            ref_ids = api.getRefIds(split=split)
            img_ids = api.getImgIds(ref_ids)
            refs_by_img = {}
            for r in api.loadRefs(ref_ids):
                refs_by_img.setdefault(r["image_id"], []).append(r)
            for iid in img_ids:
                info = api.Imgs[iid]
                path = _image_path(data_root, name, info)
                self.entries.append((api, info, refs_by_img[iid], path))

    def __len__(self):
        return len(self.entries)

    def _get(self, index):
        api, info, refs, path = self.entries[index]
        image = load_image_rgb(path)
        pairs = []
        for ref in refs:
            chosen = (ref["sentences"] if self.all_sentences
                      else [self._rng.choice(ref["sentences"])])
            for s in chosen:
                pairs.append((ref, s["sent"].strip().lower()))
        # one (sentence, mask) pair per item at train (single [SEG] answer);
        # sample FIRST, then decode only the chosen ref's mask (decoding all
        # refs multiplied per-sample CPU cost by the image's ref count)
        ref, sent = pairs[self._rng.randrange(len(pairs))]
        mask = api.get_mask(ref)
        q = seg_question(sent)
        if mask.sum() == 0:
            # gRefCOCO no-target refs: negative answer, no mask supervision
            # (reference's unexist branch, utils/refer_seg.py:408-409)
            a = f"there is no {sent} in this image."
            return self.make_sample(image, q, a, None, file_name=path,
                                    sentence=sent)
        a = seg_answer(sent, itisseg=self.itisseg)
        return self.make_sample(image, q, a,
                                np.stack([mask]).astype(np.uint8),
                                file_name=path, sentence=sent)


class RefCocoVal(SegDataset):
    """Per-ref eval dataset; uses the LAST sentence of each ref (reference
    refer_seg.py:489-490)."""

    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split: str = "val"):
        super().__init__(retry_bad=False)
        self.data_root = data_root
        self.dataset = dataset
        self.api = open_refer(data_root, dataset)
        self.ref_ids = self.api.getRefIds(split=split)

    def __len__(self):
        return len(self.ref_ids)

    def _get(self, index):
        ref = self.api.loadRefs(self.ref_ids[index])[0]
        info = self.api.Imgs[ref["image_id"]]
        path = _image_path(self.data_root, self.dataset, info)
        image = load_image_rgb(path)
        mask = self.api.get_mask(ref)
        sent = ref["sentences"][-1]["sent"].strip().lower()
        return self.make_sample(image, seg_question(sent), None,
                                np.stack([mask]).astype(np.uint8),
                                file_name=path, sentence=sent)


class RefCocoInverse(SegDataset):
    """Inverse task: image-crop reference -> region description (+[SEG])
    (reference utils/refer_seg_invert.py:360-440)."""

    def __init__(self, data_root: str, datasets: str = "refcoco,refcoco+,refcocog,refclef",
                 split: str = "train", no_mask: bool = False, roi: bool = False,
                 seed: int = 0):
        super().__init__()
        self.no_mask = no_mask
        self.roi = roi
        self._rng = random.Random(seed)
        self.base = RefCocoTrain(data_root, datasets, split=split, seed=seed)

    def __len__(self):
        return len(self.base)

    def _get(self, index):
        api, info, refs, path = self.base.entries[index]
        image = load_image_rgb(path)
        ref = self._rng.choice(refs)
        sent = self._rng.choice(ref["sentences"])["sent"].strip().lower()
        mask = api.get_mask(ref)
        box = mask_to_xyxy(mask)
        if box[2] - box[0] < 3 or box[3] - box[1] < 3:
            return None
        crop = self.ref_crop(image, box)
        answer = f"{sent}." if self.no_mask else f"{sent}[SEG]."
        norm_box = (box / np.asarray([image.shape[1], image.shape[0]] * 2)
                    ).astype(np.float32)
        return self.make_sample(
            image, region_caption_question(), answer,
            None if self.no_mask else np.stack([mask]).astype(np.uint8),
            file_name=path, ref_image=None if self.roi else crop,
            ref_bbox=norm_box if self.roi else None, sentence=sent)


class RefCocoValInverse(RefCocoVal):
    """Eval side of the inverse task: generate a region description from the
    crop; GT sentence kept for caption scoring (reference
    refer_seg_invert.py per-ref val + eval_refer_inv.py)."""

    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split: str = "val", roi: bool = False, no_mask: bool = True):
        super().__init__(data_root, dataset, split)
        self.roi = roi
        self.no_mask = no_mask

    def _get(self, index):
        ref = self.api.loadRefs(self.ref_ids[index])[0]
        info = self.api.Imgs[ref["image_id"]]
        path = _image_path(self.data_root, self.dataset, info)
        image = load_image_rgb(path)
        mask = self.api.get_mask(ref)
        box = mask_to_xyxy(mask)
        crop = self.ref_crop(image, box)
        norm_box = (box / np.asarray([image.shape[1], image.shape[0]] * 2)
                    ).astype(np.float32)
        sents = [s["sent"].strip().lower() for s in ref["sentences"]]
        return self.make_sample(
            image, region_caption_question(), None,
            np.stack([mask]).astype(np.uint8),
            file_name=path, ref_image=None if self.roi else crop,
            ref_bbox=norm_box if self.roi else None,
            sentence=sents, ref_id=ref["ref_id"])
