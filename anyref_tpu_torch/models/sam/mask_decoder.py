"""SAM mask decoder and two-way transformer (port of
anyref_tpu/models/sam/mask_decoder.py), batched over prompts. Attention here
is plain, as in the reference."""

from __future__ import annotations

import torch

from ...config import SamConfig
from ...ops.common import (conv2d_transpose, gelu, layer_norm, layer_norm_2d,
                           linear, mha)


def _attention(p, q, k, v, num_heads: int):
    """Two-way transformer attention with channel downsampling."""
    q = linear(p["q"], q)
    k = linear(p["k"], k)
    v = linear(p["v"], v)
    B, Lq, C = q.shape
    hd = C // num_heads
    qh = q.reshape(B, Lq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, k.shape[1], num_heads, hd).transpose(1, 2)
    vh = v.reshape(B, v.shape[1], num_heads, hd).transpose(1, 2)
    out = mha(qh, kh, vh).transpose(1, 2).reshape(B, Lq, C)
    return linear(p["out"], out)


def _two_way_transformer(p, cfg: SamConfig, image_emb, image_pe, tokens):
    """image_emb [N, C, g, g]; tokens [N, T, C] -> (tokens, image tokens)."""
    nh = cfg.mask_decoder_heads
    N, C, g, _ = image_emb.shape
    keys = image_emb.reshape(N, C, g * g).transpose(1, 2)
    key_pe = image_pe.reshape(1, C, g * g).transpose(1, 2).expand(
        keys.shape).to(keys.dtype)
    queries = tokens
    for i, lp in enumerate(p["layers"]):
        q = queries if i == 0 else queries + tokens
        attn_out = _attention(lp["self_attn"], q, q, queries, nh)
        queries = queries + attn_out if i != 0 else attn_out
        queries = layer_norm(lp["norm1"], queries, eps=1e-5)

        q = queries + tokens
        k = keys + key_pe
        queries = queries + _attention(lp["cross_attn_t2i"], q, k, keys, nh)
        queries = layer_norm(lp["norm2"], queries, eps=1e-5)

        h = linear(lp["mlp"]["lin2"],
                   torch.relu(linear(lp["mlp"]["lin1"], queries)))
        queries = layer_norm(lp["norm3"], queries + h, eps=1e-5)

        q = queries + tokens
        keys = keys + _attention(lp["cross_attn_i2t"], k, q, queries, nh)
        keys = layer_norm(lp["norm4"], keys, eps=1e-5)

    q = queries + tokens
    k = keys + key_pe
    queries = queries + _attention(p["final_attn_t2i"], q, k, keys, nh)
    queries = layer_norm(p["norm_final"], queries, eps=1e-5)
    return queries, keys


def apply(params: dict, cfg: SamConfig, image_embeddings, image_pe,
          sparse_prompts, dense_prompts, multimask_output: bool = False):
    """Masks for N prompts: image_embeddings [N, C, g, g] (gathered per
    prompt), image_pe [1, C, g, g], sparse [N, T, C], dense [N, C, g, g].
    Returns (masks [N, K, 4g, 4g] fp32, iou_pred [N, K]), K = 1 or 3."""
    N = sparse_prompts.shape[0]
    nm = cfg.num_multimask_outputs + 1
    out_tokens = torch.cat([params["iou_token"], params["mask_tokens"]], dim=0)
    tokens = torch.cat(
        [out_tokens[None].expand(N, nm + 1, out_tokens.shape[-1])
         .to(sparse_prompts.dtype), sparse_prompts], dim=1)

    src = image_embeddings + dense_prompts
    hs, src = _two_way_transformer(params["transformer"], cfg, src, image_pe,
                                   tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + nm]

    g = cfg.embedding_size
    C = image_embeddings.shape[1]
    src = src.transpose(1, 2).reshape(N, C, g, g)
    up = params["upscale"]
    x = conv2d_transpose(up["deconv1"], src, stride=2)
    x = gelu(layer_norm_2d(up["ln"], x, eps=cfg.layer_norm_eps))
    x = gelu(conv2d_transpose(up["deconv2"], x, stride=2))

    # stacked hypernetwork MLPs: per mask token m, a 3-layer relu MLP
    h = mask_tokens_out
    for li, lp in enumerate(params["hyper_mlps"]):
        h = torch.einsum("nmi,mio->nmo", h, lp["w"].to(h.dtype)) \
            + lp["b"].to(h.dtype)
        if li < len(params["hyper_mlps"]) - 1:
            h = torch.relu(h)
    masks = torch.einsum("nmc,nchw->nmhw", h.float(), x.float())

    ih = iou_token_out
    for li, lp in enumerate(params["iou_head"]["layers"]):
        ih = linear(lp, ih)
        if li < len(params["iou_head"]["layers"]) - 1:
            ih = torch.relu(ih)

    if multimask_output:
        return masks[:, 1:], ih[:, 1:]
    return masks[:, :1], ih[:, :1]
