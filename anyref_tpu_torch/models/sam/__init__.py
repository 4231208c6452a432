"""SAM: image encoder, prompt encoder and mask decoder (port of
anyref_tpu/models/sam/__init__.py, text-prompt path)."""

from __future__ import annotations

import torch

from ...config import SamConfig
from . import image_encoder, mask_decoder, prompt_encoder


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
