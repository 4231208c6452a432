"""SAM automatic mask generation (port of anyref_tpu/models/sam/amg.py).

Grid-prompted mask proposal: the point grid goes through the prompt
encoder and mask decoder in chunks of ``points_per_batch`` (the last chunk
zero-padded to the same shape), and the stability score runs on the
device; the IoU-prediction, stability and area filters, RLE encoding and
box NMS run on the host.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ...config import SamConfig, check_encoder_path
from ...data import rle as rle_mod
from ...ops.resize import postprocess_masks_np
from ...params import resolve_device
from . import prompt_encoder
from .predictor import decode_prompts, encode_resized


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized grid points."""
    offset = 1.0 / (2 * n_per_side)
    ticks = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(ticks, ticks)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)


def _batched_point_decode(params: dict, cfg: SamConfig, embedding, coords):
    """coords [N, 2] pixel coords in the padded frame, one positive point
    each -> (low_res [N, 3, 4g, 4g], iou [N, 3]), multimask."""
    pr = params["prompt_encoder"]
    N = coords.shape[0]
    labels = torch.ones((N, 1), dtype=torch.float32, device=coords.device)
    sparse = prompt_encoder.embed_points(pr, cfg, coords[:, None, :], labels,
                                         pad=True)
    dense = prompt_encoder.no_mask_dense(pr, cfg, N)
    return decode_prompts(params, cfg, embedding, sparse, dense, True)


def _stability_score(low_res, valid_hw, mask_threshold: float,
                     offset: float):
    """IoU of the masks thresholded at mask_threshold +- offset, counted
    over ``valid_hw`` (rows, cols), the resized image's extent on the
    low-res grid: the reference scores a mask after cropping the canvas
    pad, so the bottom/right pad must not count."""
    iy = torch.arange(low_res.shape[-2], device=low_res.device)[:, None]
    ix = torch.arange(low_res.shape[-1], device=low_res.device)[None, :]
    valid = (iy < valid_hw[0]) & (ix < valid_hw[1])
    hi = ((low_res > mask_threshold + offset) & valid).sum((-2, -1))
    lo = ((low_res > mask_threshold - offset) & valid).sum((-2, -1))
    return hi / lo.clamp_min(1)


def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_thresh: float) -> List[int]:
    """Greedy NMS over xyxy boxes, highest score first."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        x1 = np.maximum(boxes[i, 0], boxes[order, 0])
        y1 = np.maximum(boxes[i, 1], boxes[order, 1])
        x2 = np.minimum(boxes[i, 2], boxes[order, 2])
        y2 = np.minimum(boxes[i, 3], boxes[order, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_o = (boxes[order, 2] - boxes[order, 0]) * \
            (boxes[order, 3] - boxes[order, 1])
        iou = inter / np.maximum(area_i + area_o - inter, 1e-9)
        suppressed[order[iou > iou_thresh]] = True
    return keep


class SamAutomaticMaskGenerator:
    def __init__(self, params: dict, cfg: SamConfig,
                 points_per_side: int = 32, points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7,
                 min_mask_region_area: int = 0,
                 encoder_path: str = "fused", device="cuda"):
        self.device = resolve_device(device)
        self.encoder_path = check_encoder_path(encoder_path)
        self.params = params
        self.cfg = cfg
        self.grid = build_point_grid(points_per_side)
        self.ppb = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.st_thresh = stability_score_thresh
        self.st_offset = stability_score_offset
        self.nms_thresh = box_nms_thresh
        self.min_area = min_mask_region_area

    def _lap(self, timings: Optional[dict], key: str, t0: float) -> float:
        """Add the wall since t0 to timings[key] (the device synchronized
        first); -> now. A no-op without ``timings``."""
        if timings is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        timings[key] = timings.get(key, 0.0) + now - t0
        return now

    def generate(self, image_rgb_u8: np.ndarray,
                 timings: Optional[dict] = None) -> List[dict]:
        """Mask records of one image, the reference AMG's keys.
        ``timings``, a dict, gains the wall seconds of encode_s, decode_s,
        stability_s and host_s (filters, postprocess, RLE, NMS); it costs
        a device synchronization at each boundary."""
        h, w = image_rgb_u8.shape[:2]
        t = time.perf_counter()
        embedding, (nh, nw) = encode_resized(self.params, self.cfg,
                                             image_rgb_u8, self.device,
                                             self.encoder_path)
        t = self._lap(timings, "encode_s", t)
        coords = self.grid * np.asarray([nw, nh])  # padded-frame pixels
        S = self.cfg.image_size
        records = []
        for i in range(0, len(coords), self.ppb):
            chunk = coords[i:i + self.ppb]
            pad_n = self.ppb - len(chunk)
            if pad_n:
                chunk = np.pad(chunk, ((0, pad_n), (0, 0)))
            with torch.inference_mode():
                low, iou = _batched_point_decode(
                    self.params, self.cfg, embedding,
                    torch.from_numpy(chunk.astype(np.float32)).to(
                        self.device))
                t = self._lap(timings, "decode_s", t)
                # the low-res cells that cover the resized image
                lg = low.shape[-1]
                stab = _stability_score(low, (-(-nh * lg // S),
                                              -(-nw * lg // S)),
                                        0.0, self.st_offset)
                t = self._lap(timings, "stability_s", t)
                n = len(coords) - i if pad_n else self.ppb
                low = low.float().cpu().numpy()[:n]
                iou = iou.float().cpu().numpy()[:n]
                stab = stab.float().cpu().numpy()[:n]
            for j in range(low.shape[0]):
                for m in range(low.shape[1]):
                    if iou[j, m] < self.pred_iou_thresh:
                        continue
                    if stab[j, m] < self.st_thresh:
                        continue
                    full = postprocess_masks_np(low[j, m][None], (nh, nw),
                                                (h, w))[0] > 0.0
                    if full.sum() < max(self.min_area, 1):
                        continue
                    r = rle_mod.encode(full.astype(np.uint8))
                    records.append({
                        "segmentation": r,
                        "bbox": rle_mod.to_bbox(r).tolist(),
                        "area": int(full.sum()),
                        "predicted_iou": float(iou[j, m]),
                        "stability_score": float(stab[j, m]),
                        # original-image coordinates, as the reference AMG
                        "point_coords": [[float(chunk[j][0] * w / nw),
                                          float(chunk[j][1] * h / nh)]],
                    })
            t = self._lap(timings, "host_s", t)
        if not records:
            return []
        boxes = np.asarray([[r["bbox"][0], r["bbox"][1],
                             r["bbox"][0] + r["bbox"][2],
                             r["bbox"][1] + r["bbox"][3]] for r in records])
        scores = np.asarray([r["predicted_iou"] for r in records])
        keep = box_nms(boxes, scores, self.nms_thresh)
        self._lap(timings, "host_s", t)
        return [records[i] for i in keep]
