"""Dataset registry (port of anyref_tpu/data/registry.py): comma-string mix
-> concatenated dataset (mirrors the reference's registry in
train.py:136-295 and torch ConcatDataset). The AVS readers' mel front end
runs on ``device`` (the port's device rule: "cuda" unless told)."""

from __future__ import annotations

import os
from typing import List, Sequence


class ConcatDataset:
    """The datasets one after another: index i falls in the last dataset
    whose offset is at most i."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = []
        total = 0
        for d in self.datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self):
        return self.total

    def __getitem__(self, index):
        for d, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if index >= off:
                return d[index - off]
        raise IndexError(index)


def build_train_datasets(names: str, data_root: str, cfg, *,
                         itisseg: bool = False, roi: bool = False,
                         no_mask: bool = False,
                         ref_index_file: str | None = None, device="cuda"):
    """names: comma string like the reference's --train_datasets
    ("refer_seg,coco_instance,avs_object,..."); one dataset, or a
    ConcatDataset of several, each given ``cfg``. An unknown name raises
    ValueError."""
    from .ade import AdeInstanceSeg, AdeSemanticSeg
    from .avs import AVSMulti, AVSObject
    from .coco import CocoImageRefSeg, CocoInstanceSeg
    from .reason import ReasonSeg
    from .refcoco import RefCocoInverse, RefCocoTrain

    coco_images = os.path.join(data_root, "coco/train2017")
    coco_json = os.path.join(data_root,
                             "coco/annotations/instances_train2017.json")
    ref_index = ref_index_file or os.path.join(data_root,
                                               "samples_0.05_0.25.json")
    out: List = []
    for name in names.split(","):
        name = name.strip()
        if name == "coco_instance":
            out.append(CocoInstanceSeg(coco_images, coco_json,
                                       filter_area=0.01,
                                       use_loc_tokens=cfg.use_loc_tokens))
        elif name == "coco_inv":
            out.append(CocoImageRefSeg(coco_images, coco_json, ref_index))
        elif name == "ade_instance":
            out.append(AdeInstanceSeg(
                os.path.join(data_root, "ADEChallengeData2016/images/training"),
                os.path.join(data_root, "ADEChallengeData2016/annotations_instance/training"),
                filter_area=0.01))
        elif name == "ade_semantic":
            out.append(AdeSemanticSeg(
                os.path.join(data_root, "ADEChallengeData2016/images/training"),
                os.path.join(data_root, "ADEChallengeData2016/annotations/training"),
                filter_area=0.01, itisseg=itisseg))
        elif name == "refer_seg":
            out.append(RefCocoTrain(data_root,
                                    "refcoco,refcoco+,refcocog,refclef",
                                    itisseg=itisseg))
        elif name == "grefcoco":
            out.append(RefCocoTrain(data_root, "grefcoco", itisseg=itisseg))
        elif name.startswith("refer_seg_inv"):
            suffix = name[len("refer_seg_inv"):].lstrip("_")
            datasets = suffix if suffix else "refcoco,refcoco+,refcocog,refclef"
            out.append(RefCocoInverse(data_root, datasets, no_mask=no_mask,
                                      roi=roi))
        elif name.startswith("refer_seg_"):
            out.append(RefCocoTrain(data_root, name[len("refer_seg_"):],
                                    itisseg=itisseg))
        elif name == "reason":
            out.append(ReasonSeg(os.path.join(data_root, "reason"),
                                 split="train", itisseg=True))
        elif name == "avs_object":
            out.append(AVSObject(os.path.join(data_root,
                                              "avsbench/Single-source"),
                                 split="train", itisseg=itisseg,
                                 device=device))
        elif name == "avs_multi":
            out.append(AVSMulti(os.path.join(data_root,
                                             "avsbench/Multi-sources"),
                                split="train", device=device))
        else:
            raise ValueError(f"unknown dataset {name!r}")
    for d in out:
        d.cfg = cfg
    return out[0] if len(out) == 1 else ConcatDataset(out)
