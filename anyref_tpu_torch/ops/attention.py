"""Attention entry points (port of anyref_tpu/ops/attention.py).

The call sites choose between the CUDA kernels of ops/flash.py and plain
attention exactly where the reference chooses between its Pallas kernels and
XLA: SAM rel-pos attention and causal prefill go through the kernels; decode
steps and speculative verify chunks (``q_offset``/``kv_len`` given, or
Lq != Lk) run plain; CLIP attention takes the QKV-direct kernel on the fused
encoder path and runs plain on the unfused one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash
from .common import mha


def attention_with_decomposed_relpos(q, k, v, rel_h_table, rel_w_table,
                                     size_hw: tuple[int, int]):
    """SAM ViTDet attention with decomposed relative position bias.

    q, k, v: [B, heads, H*W, head_dim]; rel_*_table: [S, S, head_dim]
    gathered tables; bias[q, k] = q . rel_h[qh, kh] + q . rel_w[qw, kw]."""
    return flash.flash_relpos_attention(q, k, v, rel_h_table, rel_w_table,
                                        size_hw)


def causal_attention(q, k, v, q_offset=0, kv_len=None, kv_start=None):
    """Causal (prefill or decode) attention.

    q: [B, heads, Lq, hd]; k/v: [B, heads, Lk, hd]. Query i attends to keys
    <= i + q_offset; ``kv_len`` [B] masks trailing keys, ``kv_start`` [B]
    leading (left-padded) keys."""
    B, nh, Lq, hd = q.shape
    Lk = k.shape[2]
    if (kv_len is None and Lq == Lk and isinstance(q_offset, int)
            and q_offset == 0):
        # prefill: right-pad to a multiple of 128 as the reference does
        # before its kernel. Pad keys sit after every real query, so
        # causality drops them; a fully masked (left-pad) row then averages
        # V over the same Lp keys in both packages.
        Lp = -(-Lq // 128) * 128
        if Lp != Lq:
            q, k, v = (F.pad(t, (0, 0, 0, Lp - Lq)) for t in (q, k, v))
        return flash.flash_causal_attention(q, k, v, kv_start)[:, :, :Lq]

    logits = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(Lq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = (kpos <= qpos)[None]                          # [1, Lq, Lk]
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len[:, None, None])
    if kv_start is not None:
        mask = mask & (kpos[None] >= kv_start[:, None, None])
    logits = torch.where(mask.expand(B, Lq, Lk)[:, None], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", probs.float(),
                        v.float()).to(v.dtype)


def mha_qkv(qkv, num_heads: int, kernel: bool):
    """Self-attention from a fused [B, L, 3C] QKV tensor -> [B, L, C]: with
    ``kernel`` the QKV-direct kernel (ops/flash.py flash_attention_qkv, the
    reference's ANYREF_QKV_MHA_KERNEL=1), else split into heads and run
    plain (its ANYREF_QKV_MHA_KERNEL=0 path)."""
    if kernel:
        return flash.flash_attention_qkv(qkv, num_heads)
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    q, k, v = (qkv[..., i * C:(i + 1) * C]
               .reshape(B, L, num_heads, hd).transpose(1, 2)
               for i in range(3))
    o = mha(q, k, v)
    return o.transpose(1, 2).reshape(B, L, C)
