"""Interactive SAM predictor: point and box prompts on a cached image
embedding (port of anyref_tpu/models/sam/predictor.py).

set_image encodes once; predict reuses the embedding for any number of
prompts. The AVS ground-truth refinement CLI (tools/convert_avs_masks.py)
drives it with boxes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...config import SamConfig, check_encoder_path
from ...ops.resize import (get_preprocess_shape, postprocess_masks_np,
                           resize_bilinear_np)
from ...params import resolve_device
from .. import sam as sam_mod
from . import mask_decoder, prompt_encoder


def decode_prompts(params: dict, cfg: SamConfig, embedding, sparse, dense,
                   multimask: bool):
    """Mask decoder over N prompts on one image embedding [1, C, g, g]:
    sparse [N, T, C], dense [N, C, g, g] -> (low_res [N, K, 4g, 4g] fp32,
    iou [N, K]), in the embedding's dtype."""
    dt = embedding.dtype
    pe = prompt_encoder.dense_pe(params["prompt_encoder"], cfg)
    emb = embedding.expand(sparse.shape[0], *embedding.shape[1:])
    return mask_decoder.apply(params["mask_decoder"], cfg, emb, pe.to(dt),
                              sparse.to(dt), dense.to(dt), multimask)


def encode_resized(params: dict, cfg: SamConfig, image_rgb_u8: np.ndarray,
                   device, encoder_path: str):
    """Resize the longest side to image_size on the host, normalize and pad
    on ``device``, encode: -> (embedding [1, C, g, g], (nh, nw))."""
    h, w = image_rgb_u8.shape[:2]
    nh, nw = get_preprocess_shape(h, w, cfg.image_size)
    x = resize_bilinear_np(
        image_rgb_u8.astype(np.float32).transpose(2, 0, 1), nh, nw)
    with torch.inference_mode():
        x = sam_mod.preprocess(torch.from_numpy(x)[None].to(device), cfg)
        return sam_mod.encode_image(params, x, cfg, encoder_path), (nh, nw)


class SamPredictor:
    def __init__(self, params: dict, cfg: SamConfig,
                 encoder_path: str = "fused", device="cuda"):
        self.device = resolve_device(device)
        self.encoder_path = check_encoder_path(encoder_path)
        self.params = params
        self.cfg = cfg
        self._embedding = None
        self._orig_hw = None
        self._input_hw = None

    def set_image(self, image_rgb_u8: np.ndarray) -> None:
        """Resize the longest side, normalize and pad, run the image
        encoder once."""
        self._embedding, self._input_hw = encode_resized(
            self.params, self.cfg, image_rgb_u8, self.device,
            self.encoder_path)
        self._orig_hw = image_rgb_u8.shape[:2]

    def _transform_coords(self, coords: np.ndarray) -> np.ndarray:
        oh, ow = self._orig_hw
        nh, nw = self._input_hw
        out = coords.astype(np.float32).copy()
        out[..., 0] *= nw / ow
        out[..., 1] *= nh / oh
        return out

    def _tensor(self, a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                multimask_output: bool = True):
        """Points [N, 2] with labels [N] (1 positive, 0 negative) and/or a
        box [4] xyxy, in original-image pixels. Returns (masks [K, H, W]
        bool at the original size, iou_pred [K], low_res_logits [K, 4g,
        4g]), numpy; K = 3 with ``multimask_output``, else 1."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        if point_coords is None and box is None:
            raise ValueError("give point_coords and point_labels, or a box")
        cfg = self.cfg
        pr = self.params["prompt_encoder"]
        parts = []
        with torch.inference_mode():
            if point_coords is not None:
                pts = self._transform_coords(np.asarray(point_coords))[None]
                lbl = np.asarray(point_labels, np.float32)[None]
                parts.append(prompt_encoder.embed_points(
                    pr, cfg, self._tensor(pts), self._tensor(lbl),
                    pad=box is None))
            if box is not None:
                b = self._transform_coords(
                    np.asarray(box).reshape(2, 2)).reshape(1, 4)
                parts.append(prompt_encoder.embed_boxes(pr, cfg,
                                                        self._tensor(b)))
            sparse = torch.cat(parts, dim=1)
            dense = prompt_encoder.no_mask_dense(pr, cfg, 1)
            low_res, iou = decode_prompts(self.params, cfg, self._embedding,
                                          sparse, dense, multimask_output)
            low_res = low_res[0].float().cpu().numpy()
            iou = iou[0].float().cpu().numpy()
        canvas = resize_bilinear_np(low_res, cfg.image_size, cfg.image_size)
        masks = postprocess_masks_np(canvas, self._input_hw, self._orig_hw)
        return masks > 0.0, iou, low_res
