"""SAM prompt encoder, text-prompt path (port of
anyref_tpu/models/sam/prompt_encoder.py encode_text_prompts and dense_pe).

AnyRef's [SEG] projections enter as sparse embeddings, with the learned
no-mask dense embedding. Point, box and mask prompts are not part of the
port yet.
"""

from __future__ import annotations

import math

import torch

from ...config import SamConfig


def _pe_encode(gaussian, coords):
    """Random-Fourier encoding of coords in [0, 1]^2, fp32."""
    c = coords.float() * 2.0 - 1.0
    c = c @ gaussian.float()
    c = (2.0 * math.pi) * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(params: dict, cfg: SamConfig):
    """[1, embed_dim, g, g] grid positional encoding."""
    g = cfg.embedding_size
    dev = params["pe_gaussian"].device
    y = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    x = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                   # [g, g, 2] (x, y)
    pe = _pe_encode(params["pe_gaussian"], grid)
    return pe.permute(2, 0, 1)[None]


def no_mask_dense(params: dict, cfg: SamConfig, batch: int):
    """[B, embed_dim, g, g] learned no-mask dense embedding."""
    g = cfg.embedding_size
    return params["no_mask_embed"].reshape(1, -1, 1, 1).expand(
        batch, cfg.prompt_embed_dim, g, g)


def encode_text_prompts(params: dict, cfg: SamConfig, text_embeds):
    """text_embeds [N, T, d] -> (sparse [N, T, d], dense [N, d, g, g])."""
    return text_embeds, no_mask_dense(params, cfg, text_embeds.shape[0])
