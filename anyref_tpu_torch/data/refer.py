"""REFER / G_REFER annotation APIs (port of anyref_tpu/data/refer.py).

The standard public REFER API (refcoco/refcoco+/refcocog/refclef pickles +
instances.json; grefcoco json).

Data layout expected under ``data_root``:
  {dataset}/refs({split_by}).p      — pickled list of ref records
  {dataset}/instances.json          — COCO-format annotations
  grefcoco/grefs(unc).json          — gRefCOCO refs (json, ann_id lists)

A ref record: {ref_id, ann_id, image_id, category_id, split, file_name,
sentences: [{sent, raw, tokens, sent_id}], sent_ids}. The pickles are the
dataset's own files: unpickle only a data root you trust.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np

from . import rle


class CocoIndex:
    """Minimal COCO instances.json index (replaces pycocotools.coco.COCO)."""

    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, (str, os.PathLike)):
            with open(ann_file_or_dict) as f:
                data = json.load(f)
        else:
            data = ann_file_or_dict
        self.dataset = data
        self.imgs: Dict[int, dict] = {im["id"]: im for im in data.get("images", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in data.get("annotations", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {}
        for a in data.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    def get_ann_ids(self, img_id: int) -> List[int]:
        return [a["id"] for a in self.img_to_anns.get(img_id, [])]

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    def load_imgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def ann_to_mask(self, ann: dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return rle.annotation_to_mask(ann["segmentation"], img["height"],
                                      img["width"])


class Refer:
    """refcoco / refcoco+ / refcocog / refclef."""

    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split_by: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        base = os.path.join(data_root, dataset)
        with open(os.path.join(base, f"refs({split_by}).p"), "rb") as f:
            self.refs_list: List[dict] = pickle.load(f)
        self.coco = CocoIndex(os.path.join(base, "instances.json"))
        self.Refs = {r["ref_id"]: r for r in self.refs_list}
        self.Anns = self.coco.anns
        self.Imgs = self.coco.imgs
        self.Cats = {cid: c.get("name", str(cid))
                     for cid, c in self.coco.cats.items()}
        self.img_to_refs: Dict[int, List[dict]] = {}
        for r in self.refs_list:
            self.img_to_refs.setdefault(r["image_id"], []).append(r)

    # REFER-compatible accessors (reference call sites refer_seg.py:74-81)
    def getRefIds(self, split: str = "") -> List[int]:
        return [r["ref_id"] for r in self.refs_list
                if not split or r["split"] == split]

    def getImgIds(self, ref_ids=None) -> List[int]:
        if ref_ids is None:
            return list(self.Imgs.keys())
        if isinstance(ref_ids, int):
            ref_ids = [ref_ids]
        seen, out = set(), []
        for rid in ref_ids:
            iid = self.Refs[rid]["image_id"]
            if iid not in seen:
                seen.add(iid)
                out.append(iid)
        return out

    def loadRefs(self, ref_ids) -> List[dict]:
        if isinstance(ref_ids, int):
            ref_ids = [ref_ids]
        return [self.Refs[r] for r in ref_ids]

    def loadImgs(self, image_ids) -> List[dict]:
        return [self.Imgs[i] for i in image_ids]

    def get_mask(self, ref: dict) -> np.ndarray:
        """Binary mask for a ref's annotation."""
        return self.ann_mask(ref["ann_id"])

    def ann_mask(self, ann_id) -> np.ndarray:
        ann = self.Anns[ann_id]
        return self.coco.ann_to_mask(ann)


class GRefer:
    """gRefCOCO: refs in json; ann_id is a *list* (multi-target) and may be
    empty / [-1] (no-target)."""

    def __init__(self, data_root: str, dataset: str = "grefcoco",
                 split_by: str = "unc"):
        base = os.path.join(data_root, dataset)
        with open(os.path.join(base, f"grefs({split_by}).json")) as f:
            self.refs_list: List[dict] = json.load(f)
        self.coco = CocoIndex(os.path.join(base, "instances.json"))
        self.Refs = {r["ref_id"]: r for r in self.refs_list}
        self.Anns = self.coco.anns
        self.Imgs = self.coco.imgs
        self.img_to_refs: Dict[int, List[dict]] = {}
        for r in self.refs_list:
            self.img_to_refs.setdefault(r["image_id"], []).append(r)

    getRefIds = Refer.getRefIds
    getImgIds = Refer.getImgIds
    loadRefs = Refer.loadRefs
    loadImgs = Refer.loadImgs

    def is_no_target(self, ref: dict) -> bool:
        aids = ref["ann_id"]
        if not isinstance(aids, list):
            aids = [aids]
        return len(aids) == 0 or aids[0] in (-1, None)

    def get_mask(self, ref: dict) -> np.ndarray:
        img = self.Imgs[ref["image_id"]]
        h, w = img["height"], img["width"]
        if self.is_no_target(ref):
            return np.zeros((h, w), np.uint8)
        aids = ref["ann_id"] if isinstance(ref["ann_id"], list) else [ref["ann_id"]]
        m = np.zeros((h, w), np.uint8)
        for aid in aids:
            m = np.maximum(m, self.coco.ann_to_mask(self.Anns[aid]))
        return m


def open_refer(data_root: str, dataset: str):
    """Factory following the reference's splitBy convention
    (refer_seg.py:50-65: umd for refcocog, unc otherwise)."""
    split_by = "umd" if dataset == "refcocog" else "unc"
    if dataset == "grefcoco":
        return GRefer(data_root, dataset, split_by)
    return Refer(data_root, dataset, split_by)
