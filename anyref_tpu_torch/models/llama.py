"""LLaMA decoder (port of anyref_tpu/models/llama.py).

RMSNorm in fp32, HF rotate-half rope with fp32 tables, SiLU MLP. The forward
consumes embeddings, because AnyRef splices image features into the sequence
first. Hidden states returned are post-final-RMSNorm.

The KV cache is one stacked pair [layers, B, kv_heads, max_len, head_dim];
each layer writes its fresh k/v into it IN PLACE at ``write_pos`` (the
reference returns an updated copy; in place saves the copy). Prefill runs
the causal CUDA kernel and the fused RMSNorm kernel; decode steps and
speculative verify chunks run plain attention and plain norms, as the
reference does. ``forward`` (training) writes no cache and runs the
differentiable causal kernel with plain norms (the reference's fused
RMSNorm has no gradient); with ``remat`` each layer is checkpointed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..ops.attention import causal_attention
from ..ops.common import linear, rms_norm, silu


class KVCache(NamedTuple):
    k: torch.Tensor  # [layers, B, kv_heads, max_len, head_dim]
    v: torch.Tensor


def embed(params: dict, input_ids, dtype=torch.bfloat16):
    return params["embed_tokens"][input_ids].to(dtype)


def _rope_tables(positions, hd: int, theta: float):
    """cos/sin [B, 1, L, hd/2] in fp32, shared by all layers."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    if positions.dim() == 1:
        positions = positions[None]
    ang = positions.float()[:, None, :, None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _rope(x, tables):
    """x [B, heads, L, hd] rotated with rotate-half over the dim halves."""
    cos, sin = tables
    hd = x.shape[-1]
    x1, x2 = x[..., :hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _split_heads(x, n: int, hd: int):
    B, L, _ = x.shape
    return x.reshape(B, L, n, hd).transpose(1, 2)


def _merge_heads(x):
    B, n, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, n * hd)


def _layer(p, cfg: LlamaConfig, x, mode: str, cache, write_pos: int,
           layer_idx: int, rope_tables, kv_start=None, kv_len=None,
           fused_norms: bool = False):
    """mode "prefill" attends over the fresh prompt keys (causal kernel);
    "decode" attends over the whole cache after writing the new keys;
    "full" (training) writes no cache and takes the differentiable causal
    kernel (``cache`` is None there)."""
    h = rms_norm(p["input_norm"], x, eps=cfg.rms_norm_eps, fused=fused_norms)
    q = _split_heads(linear(p["attn"]["q"], h), cfg.num_heads, cfg.head_dim)
    k = _split_heads(linear(p["attn"]["k"], h), cfg.num_kv_heads,
                     cfg.head_dim)
    v = _split_heads(linear(p["attn"]["v"], h), cfg.num_kv_heads,
                     cfg.head_dim)
    q = _rope(q, rope_tables)
    k = _rope(k, rope_tables)

    if mode != "full":
        L = k.shape[2]
        cache.k[layer_idx, :, :, write_pos:write_pos + L] = k
        cache.v[layer_idx, :, :, write_pos:write_pos + L] = v
    if mode == "decode":
        k, v = cache.k[layer_idx], cache.v[layer_idx]
    rep = cfg.num_heads // cfg.num_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    attn = causal_attention(q, k, v,
                            q_offset=write_pos if mode == "decode" else 0,
                            kv_len=kv_len, kv_start=kv_start,
                            differentiable=mode == "full")
    x = x + linear(p["attn"]["o"], _merge_heads(attn))
    h = rms_norm(p["post_attn_norm"], x, eps=cfg.rms_norm_eps,
                 fused=fused_norms)
    h = linear(p["mlp"]["down"],
               silu(linear(p["mlp"]["gate"], h)) * linear(p["mlp"]["up"], h))
    return x + h


def forward(params: dict, cfg: LlamaConfig, embeds, positions=None,
            kv_len=None, return_last_input: bool = False,
            remat: bool = False):
    """Full-sequence forward (training, no cache): post-final-norm hidden
    [B, L, D]; with ``return_last_input`` also the residual stream entering
    the final layer. ``kv_len`` [B] masks trailing keys and takes plain
    attention, as in the reference. ``remat`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): only the layer inputs stay
    alive between the passes and the backward recomputes each layer, the
    attention kernel's forward included."""
    B, L, _ = embeds.shape
    if positions is None:
        positions = torch.arange(L, device=embeds.device)
    rt = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    last_in = None
    for i, p in enumerate(params["layers"]):
        if i == len(params["layers"]) - 1:
            last_in = x
        args = (p, cfg, x, "full", None, 0, i, rt, None, kv_len)
        x = (checkpoint(_layer, *args, use_reentrant=False) if remat
             else _layer(*args))
    out = rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)
    if return_last_input:
        return out, last_in
    return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _run(params, cfg, x, positions, mode, cache, write_pos, pad_len,
         fused_norms, return_last_input):
    rt = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    last = len(params["layers"]) - 1
    last_in = None
    for i, p in enumerate(params["layers"]):
        if i == last:
            last_in = x
        x = _layer(p, cfg, x, mode, cache, write_pos, i, rt,
                   kv_start=pad_len, fused_norms=fused_norms)
    out = (rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps), cache)
    return out + (last_in,) if return_last_input else out


def prefill(params: dict, cfg: LlamaConfig, embeds, cache: KVCache,
            pad_len=None, return_last_input: bool = False):
    """Run the prompt, filling cache slots [0, L). Returns (post-norm hidden
    [B, L, D], cache)[, the residual stream entering the final layer
    [B, L, D]]. ``pad_len`` [B] is each row's left pad: rope positions
    shift so the first real token sits at 0, and pad keys are masked."""
    B, L, _ = embeds.shape
    positions = torch.arange(L, device=embeds.device)
    if pad_len is not None:
        positions = (positions[None, :] - pad_len[:, None]).clamp_min(0)
    return _run(params, cfg, embeds, positions, "prefill", cache, 0, pad_len,
                True, return_last_input)


def decode_chunk(params: dict, cfg: LlamaConfig, embeds, pos: int,
                 cache: KVCache, pad_len=None,
                 return_last_input: bool = False):
    """G consecutive tokens [B, G, D] at cache slots pos .. pos+G-1 (a
    speculative verify chunk; G = 1 is a decode step); outputs as
    ``prefill``'s. Rejected draft entries left in the cache are rewritten
    before any query attends them."""
    B, G, _ = embeds.shape
    positions = pos + torch.arange(G, device=embeds.device)[None, :]
    if pad_len is not None:
        positions = positions - pad_len[:, None]
    return _run(params, cfg, embeds, positions, "decode", cache, pos, pad_len,
                False, return_last_input)


def decode_step(params: dict, cfg: LlamaConfig, embeds, pos: int,
                cache: KVCache, pad_len=None,
                return_last_input: bool = False):
    """One decode step, embeds [B, 1, D] at cache slot ``pos``."""
    return decode_chunk(params, cfg, embeds, pos, cache, pad_len,
                        return_last_input)


def logits(params: dict, hidden):
    """lm_head in fp32; on an int8 tree (ops/quant.py) the int8 lm_head in
    hidden's dtype (bf16 in generate), only then cast to fp32, as the
    reference rounds it."""
    if params.get("lm_head_q") is not None:
        return linear(params["lm_head_q"], hidden).float()
    return torch.matmul(hidden.float(), params["lm_head"].float())
