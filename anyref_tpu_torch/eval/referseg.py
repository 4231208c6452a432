"""Referring-segmentation eval harness (port of anyref_tpu/eval/referseg.py;
reference eval_referseg.py:25-257).

Computes cIoU (dataset-level intersection/union of the foreground class) and
gIoU (mean per-image IoU, empty-union images counting 1.0), optionally saving
per-image prediction PNGs and appending result.txt — the same artifacts the
reference writes.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..data.collator import Collator
from ..data.loader import DataLoader
from .metrics import AverageMeter, intersection_and_union
from .runner import Predictor, binary_mask


def evaluate_segmentation(predictor: Predictor, dataset, tokenizer,
                          out_dir: Optional[str] = None,
                          save_masks: bool = False,
                          save_qualitative: bool = False,
                          limit: Optional[int] = None,
                          batch_size: int = 1,
                          num_workers: int = 4,
                          progress: bool = True,
                          timings: Optional[dict] = None) -> dict:
    """Generic cIoU/gIoU loop shared by refCOCO / ReasonSeg / COCO-20i.

    ``save_qualitative`` reproduces the reference coco20i harness's output
    contract (eval_coco20i.py:150-183): generated caption text appended to
    exp_gen.txt plus per-sample pred/gt/orig/ref PNG dumps.

    ``timings``, where given, gains the wall seconds spent waiting on the
    loader (``loader_s``), in ``predictor.predict`` (``predict_s``) and in
    host scoring, ``binary_mask`` and ``intersection_and_union``
    (``score_s``)."""
    col = Collator(tokenizer, predictor.cfg, train=False)
    loader = DataLoader(dataset, col, batch_size=batch_size,
                        num_workers=num_workers)
    inter_m = AverageMeter("intersection")
    union_m = AverageMeter("union")
    giou_m = AverageMeter("gIoU")
    if out_dir and (save_masks or save_qualitative):
        os.makedirs(os.path.join(out_dir, "pred_masks"), exist_ok=True)
    wall = {"loader_s": 0.0, "predict_s": 0.0, "score_s": 0.0}

    seen = 0
    img_id = 0
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        t1 = time.perf_counter()
        wall["loader_s"] += t1 - t0
        if batch is None:
            break
        output_ids, masks = predictor.predict(batch)
        wall["predict_s"] += time.perf_counter() - t1
        for b in range(len(batch["_meta"])):
            gt = batch["_orig_masks"][b]
            if gt is None:
                img_id += 1
                continue
            t2 = time.perf_counter()
            gt = gt[0].astype(np.int32)
            h, w = gt.shape
            pred = binary_mask(masks[b], h, w)
            wall["score_s"] += time.perf_counter() - t2
            if out_dir and (save_masks or save_qualitative):
                _save_pngs(out_dir, str(img_id).zfill(4), pred, gt,
                           batch["_meta"][b], output_ids[b], tokenizer,
                           save_qualitative)
            t2 = time.perf_counter()
            inter, union, _ = intersection_and_union(pred, gt, K=2,
                                                     ignore_index=255)
            acc = inter / (union + 1e-5)
            acc[union == 0] += 1.0  # no-object target (eval_referseg.py:208)
            inter_m.update(inter)
            union_m.update(union)
            giou_m.update(acc, n=1)
            wall["score_s"] += time.perf_counter() - t2
            img_id += 1
            seen += 1
        if progress and seen and seen % 50 == 0:
            print(f"  [{seen}] running cIoU="
                  f"{(inter_m.sum / (union_m.sum + 1e-10))[1]:.4f}")
        if limit is not None and seen >= limit:
            break
    batches.close()     # stops the loader's workers after a limit
    if timings is not None:
        for k, v in wall.items():
            timings[k] = timings.get(k, 0.0) + v

    inter_m.all_reduce()
    union_m.all_reduce()
    giou_m.all_reduce()
    iou_class = inter_m.sum / (union_m.sum + 1e-10)
    result = {"ciou": float(iou_class[1]),
              "giou": float(giou_m.avg[1]),
              "n": seen}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "result.txt"), "a") as f:
            f.write(f"ciou: {result['ciou']:.4f}\ngiou: {result['giou']:.4f}\n")
    return result


def _save_pngs(out_dir: str, name: str, pred, gt, meta: dict, ids,
               tokenizer, qualitative: bool) -> None:
    """pred_masks/NNNN.png; with ``qualitative`` also the generated text
    (exp_gen.txt) and the _gt, _orig and _ref PNGs."""
    from PIL import Image
    pdir = os.path.join(out_dir, "pred_masks")
    Image.fromarray((pred * 255).astype(np.uint8)).convert("P").save(
        os.path.join(pdir, f"{name}.png"))
    if not qualitative:
        return
    text = tokenizer.decode([t for t in ids.tolist() if t != 2])
    with open(os.path.join(out_dir, "exp_gen.txt"), "a") as f:
        f.write(text + "\n")
    Image.fromarray((gt.astype(np.uint8) * 255)).convert("P").save(
        os.path.join(pdir, f"{name}_gt.png"))
    if meta.get("file_name") and os.path.exists(meta["file_name"]):
        with Image.open(meta["file_name"]) as im:
            im.convert("RGB").save(os.path.join(pdir, f"{name}_orig.png"))
    if meta.get("orig_ref_img") is not None:
        Image.fromarray(meta["orig_ref_img"]).convert("RGB").save(
            os.path.join(pdir, f"{name}_ref.png"))


def evaluate_referseg(predictor: Predictor, tokenizer, data_root: str,
                      val_datasets: str = "refcoco_val", out_root: str = "eval_out",
                      limit: Optional[int] = None,
                      timings: Optional[dict] = None) -> dict:
    """Multi-split driver (reference eval_referseg.py __main__: comma list of
    '<dataset>_<split>' like 'refcoco_val,refcoco+_testA,refcocog_test')."""
    from ..data.refcoco import RefCocoVal
    results = {}
    for val_ds in val_datasets.replace(" ", "").split(","):
        name, split = val_ds.rsplit("_", 1)
        dataset = RefCocoVal(data_root, name, split=split)
        dataset.cfg = predictor.cfg
        out_dir = os.path.join(out_root, name, split)
        print(f"evaluating {val_ds}: {len(dataset)} refs")
        results[val_ds] = evaluate_segmentation(
            predictor, dataset, tokenizer, out_dir=out_dir, limit=limit,
            timings=timings)
        print(f"{val_ds} ciou: {results[val_ds]['ciou']:.4f} "
              f"giou: {results[val_ds]['giou']:.4f}")
    return results
