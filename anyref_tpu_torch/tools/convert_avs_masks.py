"""AVSBench ground-truth mask refinement by SAM box prompting (port of
tools/convert_avs_masks.py): prompt SAM with each ground-truth mask's box
and keep SAM's best mask where its IoU with the ground truth is at least
``--iou_threshold``, written under ``s4_data/gt_masks_sam/<split>``.

  python -m anyref_tpu_torch.tools.convert_avs_masks \
      --sam_ckpt SAM/sam_vit_h_4b8939.pth --avs_root /data/AVSBench

Beyond the JAX CLI's arguments: ``--device``, ``--encoder_path`` and
``--preset vit_h|tiny`` (the JAX CLI hard-codes ViT-H; tiny is
anyref_tiny's SAM).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import ENCODER_PATHS


def jaccard(a, b):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return inter / union if union else 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sam_ckpt", default="SAM/sam_vit_h_4b8939.pth")
    p.add_argument("--avs_root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--iou_threshold", type=float, default=0.75)
    p.add_argument("--preset", default="vit_h", choices=["vit_h", "tiny"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--encoder_path", default="fused", choices=ENCODER_PATHS)
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from .. import checkpoint, convert
    from ..config import SamConfig, anyref_tiny
    from ..data.base import load_image_rgb, mask_to_xyxy
    from ..models.sam.predictor import SamPredictor
    from ..params import resolve_device

    cfg = SamConfig.vit_h() if args.preset == "vit_h" else anyref_tiny().sam
    dev = resolve_device(args.device)
    sd = checkpoint._load_torch_state_dict(args.sam_ckpt)
    params = convert.convert_sam(sd, cfg, dtype=torch.bfloat16, device=dev)
    predictor = SamPredictor(params, cfg, encoder_path=args.encoder_path,
                             device=dev)

    s4 = os.path.join(args.avs_root, "s4_data")
    mask_root = os.path.join(s4, "gt_masks", args.split)
    img_root = os.path.join(s4, "visual_frames_original_resolution",
                            args.split)
    out_root = os.path.join(s4, "gt_masks_sam", args.split)
    n_kept = n_total = 0
    for cat in sorted(os.listdir(mask_root)):
        for vid in sorted(os.listdir(os.path.join(mask_root, cat))):
            for frame in sorted(os.listdir(os.path.join(mask_root, cat, vid))):
                gt_path = os.path.join(mask_root, cat, vid, frame)
                # frames and masks share their names ({video}_{i}.png)
                img_path = os.path.join(img_root, cat, vid, frame)
                if not os.path.exists(img_path):
                    print(f"WARNING: no frame for mask {gt_path}, skipped")
                    continue
                with Image.open(gt_path) as im:
                    gt = np.asarray(im.convert("1")) > 0
                if gt.sum() == 0:
                    continue
                predictor.set_image(load_image_rgb(img_path))
                box = mask_to_xyxy(gt.astype(np.uint8))
                masks, _, _ = predictor.predict(box=box,
                                                multimask_output=True)
                best = max(range(masks.shape[0]),
                           key=lambda i: jaccard(masks[i], gt))
                n_total += 1
                if jaccard(masks[best], gt) >= args.iou_threshold:
                    n_kept += 1
                    out_path = os.path.join(out_root, cat, vid, frame)
                    os.makedirs(os.path.dirname(out_path), exist_ok=True)
                    Image.fromarray(
                        masks[best].astype(np.uint8) * 255).save(out_path)
    print(f"refined {n_kept}/{n_total} masks (IoU >= {args.iou_threshold})")
    return n_kept, n_total


if __name__ == "__main__":
    main()
