"""SAM: image encoder, prompt encoder and mask decoder (port of
anyref_tpu/models/sam/__init__.py). SAM alone, prompted by points, boxes
and masks: predictor.SamPredictor and amg.SamAutomaticMaskGenerator."""

from __future__ import annotations

import torch

from ...config import SAM_PIXEL_MEAN, SAM_PIXEL_STD, SamConfig
from ...ops.resize import postprocess_masks_fixed, sam_normalize_pad
from ...params import _Maker, _sam, resolve_device
from . import image_encoder, mask_decoder, prompt_encoder


def init(cfg: SamConfig, generator: torch.Generator, dtype=torch.float32,
         device="cuda") -> dict:
    """SAM's part of the tree alone ({"image_encoder", "prompt_encoder",
    "mask_decoder"}), random weights of the reference init's shapes made on
    ``device`` from ``generator`` (which must live there), so that a
    SAM-only caller builds no decoder."""
    return _sam(_Maker(generator, resolve_device(device)), cfg, dtype)


def preprocess(x, cfg: SamConfig):
    """Normalize and bottom/right pad already-resized pixels [..., 3, h, w]
    (0..255) to the square input frame."""
    return sam_normalize_pad(x, cfg.image_size, SAM_PIXEL_MEAN, SAM_PIXEL_STD)


def encode_image(params: dict, x, cfg: SamConfig,
                 encoder_path: str = "fused"):
    return image_encoder.apply(params["image_encoder"], x, cfg, encoder_path)


def decode_text_prompts(params: dict, cfg: SamConfig, image_embeddings,
                        text_embeds, image_index=None,
                        multimask_output: bool = False):
    """image_embeddings [B, C, g, g]; text_embeds [N, d] [SEG] projections;
    image_index [N] says which image each prompt belongs to (default
    arange). Returns (low_res_masks [N, K, 4g, 4g], iou_pred [N, K])."""
    if image_index is None:
        image_index = torch.arange(text_embeds.shape[0],
                                   device=text_embeds.device)
    sparse, dense = prompt_encoder.encode_text_prompts(
        params["prompt_encoder"], cfg, text_embeds[:, None, :])
    pe = prompt_encoder.dense_pe(params["prompt_encoder"], cfg)
    per_prompt = image_embeddings[image_index]
    dt = per_prompt.dtype
    return mask_decoder.apply(params["mask_decoder"], cfg, per_prompt,
                              pe.to(dt), sparse.to(dt), dense.to(dt),
                              multimask_output)


def upscale_masks(low_res_masks, cfg: SamConfig):
    """Low-res logits -> the full input frame (stage 1 of the SAM
    postprocess), differentiable."""
    return postprocess_masks_fixed(low_res_masks, cfg.image_size)
