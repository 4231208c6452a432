"""The ReasonSeg, COCO-20i, AVSBench and region-caption inverse eval
harnesses (port of anyref_tpu/eval/harnesses.py; reference eval_reason.py,
eval_coco20i.py, eval_avs_object.py, eval_refer_inv.py)."""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Optional

import numpy as np

from ..data.collator import Collator
from ..data.loader import DataLoader
from .caption_metrics import bleu_n, cider_d, meteor, spice
from .metrics import f_measure, mask_iou
from .referseg import evaluate_segmentation
from .runner import Predictor


def evaluate_reason(predictor: Predictor, tokenizer, data_root: str,
                    out_root: str = "eval_out",
                    limit: Optional[int] = None) -> dict:
    """ReasonSeg val cIoU/gIoU (reference eval_reason.py:139-159)."""
    from ..data.reason import ReasonSeg
    ds = ReasonSeg(os.path.join(data_root, "reason"), split="val")
    ds.cfg = predictor.cfg
    out_dir = os.path.join(out_root, "reason", "val")
    return evaluate_segmentation(predictor, ds, tokenizer, out_dir=out_dir,
                                 limit=limit)


def evaluate_coco20i(predictor: Predictor, tokenizer, data_root: str,
                     out_root: str = "eval_out", splits=(0, 1, 2, 3),
                     limit: int = 101) -> dict:
    """COCO-20i one-shot eval, capped at 101 samples per split like the
    reference smoke-eval pattern (eval_coco20i.py:207-208)."""
    from ..data.coco20i import Coco20i
    results = {}
    for split in splits:
        ds = Coco20i(
            os.path.join(data_root, "coco/train2017"),
            os.path.join(data_root, "coco/annotations/instances_train2017.json"),
            os.path.join(data_root, "samples_0.05_0.25.json"),
            os.path.join(data_root, "coco_20i/lists/coco/fss_list"),
            split=split, mode="val")
        ds.cfg = predictor.cfg
        out_dir = os.path.join(out_root, "coco20i", str(split))
        results[split] = evaluate_segmentation(
            predictor, ds, tokenizer, out_dir=out_dir, limit=limit,
            save_qualitative=True)
        print(f"coco20i split {split}: {results[split]}")
    return results


def evaluate_avs(predictor: Predictor, tokenizer, data_root: str,
                 task: str = "object", split: str = "test",
                 out_root: str = "eval_out",
                 limit: Optional[int] = None) -> dict:
    """AVSBench mIoU + F-measure in 5-frame video groups (reference
    eval_avs_object.py:137-192). The reader's mel front end runs on the
    Predictor's device."""
    from ..data.avs import AVSMulti, AVSObject
    if task == "object":
        ds = AVSObject(os.path.join(data_root, "avsbench/Single-source"),
                       split=split)
    else:
        ds = AVSMulti(os.path.join(data_root, "avsbench/Multi-sources"),
                      split=split)
    ds.cfg = predictor.cfg
    ds.device = predictor.device
    col = Collator(tokenizer, predictor.cfg, train=False)
    loader = DataLoader(ds, col, batch_size=1, num_workers=4)

    miou_vals = []
    fscores = []
    group_pred, group_gt = [], []
    group_video = None
    seen = 0

    def flush_group():
        # the reference (eval_avs_object.py:171-180) scores whole 5-frame
        # video groups; a shorter group (a limit, the trailing flush) is
        # dropped, not scored
        if len(group_pred) < 5:
            group_pred.clear()
            group_gt.clear()
            return
        hs = min(p.shape[0] for p in group_pred)
        ws = min(p.shape[1] for p in group_pred)
        fscores.append(f_measure(
            np.stack([p[:hs, :ws] for p in group_pred]),
            np.stack([g[:hs, :ws] for g in group_gt])))
        group_pred.clear()
        group_gt.clear()

    batches = iter(loader)
    for batch in batches:
        _, masks = predictor.predict(batch)
        gt = batch["_orig_masks"][0]
        if gt is None:
            continue
        gt = gt[0].astype(np.float32)
        h, w = gt.shape
        logits = (masks[0][0] if masks[0] is not None
                  else np.full((h, w), -10.0, np.float32))
        miou_vals.append(mask_iou(logits[None], gt[None]))
        # F-measure groups are per video: the unshuffled eval loader hands
        # each video's frames out one after another
        video = batch["_meta"][0].get("video_name")
        if group_pred and video != group_video:
            flush_group()
        group_video = video
        group_pred.append(logits)
        group_gt.append(gt)
        seen += 1
        if limit is not None and seen >= limit:
            break
    batches.close()
    flush_group()
    result = {"miou": float(np.mean(miou_vals)) if miou_vals else 0.0,
              "fscore": float(np.mean(fscores)) if fscores else 0.0,
              "n": seen}
    out_dir = os.path.join(out_root, f"avs_{task}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "avs_result.txt"), "a") as f:
        f.write(json.dumps(result) + "\n")
    return result


def evaluate_refer_inverse(predictor: Predictor, tokenizer, data_root: str,
                           dataset: str = "refcocog", split: str = "val",
                           roi: bool = False, out_root: str = "eval_out",
                           limit: Optional[int] = None,
                           timings: Optional[dict] = None) -> dict:
    """Region-caption inverse eval: generate a description of each ref from
    its crop (or, with ``roi``, its box) and score BLEU-4, CIDEr-D, METEOR
    and SPICE against the ref's sentences (reference eval_refer_inv.py:
    183-211; pycocoevalcap replaced by native scorers). METEOR and SPICE
    are NaN, with a warning, where nltk is missing. Appends the result to
    ``out_root/dataset/split/inv_result.txt``.

    ``timings``, where given, gains the wall seconds spent waiting on the
    loader (``loader_s``), in ``predictor.predict`` (``predict_s``) and
    decoding and scoring the captions on the host (``score_s``)."""
    from ..data.refcoco import RefCocoValInverse
    ds = RefCocoValInverse(data_root, dataset, split=split, roi=roi)
    ds.cfg = predictor.cfg
    col = Collator(tokenizer, predictor.cfg, train=False, roi=roi)
    loader = DataLoader(ds, col, batch_size=1, num_workers=4)
    wall = {"loader_s": 0.0, "predict_s": 0.0, "score_s": 0.0}
    hyps, refs = [], []
    seen = 0
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        t1 = time.perf_counter()
        wall["loader_s"] += t1 - t0
        if batch is None:
            break
        output_ids, _ = predictor.predict(batch)
        t2 = time.perf_counter()
        wall["predict_s"] += t2 - t1
        text = tokenizer.decode(
            [t for t in output_ids[0].tolist() if t != 2], skip_special=True)
        hyps.append(text.strip().rstrip(".").strip())
        gts = batch["_meta"][0]["sentence"]
        refs.append(gts if isinstance(gts, list) else [gts])
        wall["score_s"] += time.perf_counter() - t2
        seen += 1
        if limit is not None and seen >= limit:
            break
    batches.close()     # stops the loader's workers after a limit
    t0 = time.perf_counter()
    # meteor and spice stem with nltk's PorterStemmer: NaN without nltk,
    # not a failed eval
    try:
        met, spc = meteor(hyps, refs), spice(hyps, refs)
    except ImportError:
        warnings.warn("nltk unavailable: meteor/spice reported as NaN")
        met = spc = float("nan")
    result = {"bleu4": bleu_n(hyps, refs, 4), "cider": cider_d(hyps, refs),
              "meteor": met, "spice": spc, "n": seen}
    wall["score_s"] += time.perf_counter() - t0
    if timings is not None:
        for k, v in wall.items():
            timings[k] = timings.get(k, 0.0) + v
    out_dir = os.path.join(out_root, dataset, split)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "inv_result.txt"), "a") as f:
        f.write(json.dumps(result) + "\n")
    return result
