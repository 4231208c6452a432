"""LLaMA decoder (port of anyref_tpu/models/llama.py).

RMSNorm in fp32, HF rotate-half rope with fp32 tables, SiLU MLP. The forward
consumes embeddings, because AnyRef splices image features into the sequence
first. Hidden states returned are post-final-RMSNorm.

Serving layout (the reference's, for speculative serving):
``transpose_for_serving`` stores every decoder matrix as ``w_t`` [out, in]
and ``fuse_for_serving`` concatenates q/k/v into ``attn["qkv"]`` and
gate/up into ``mlp["gate_up"]``, 7 products a layer becoming 4; ``_layer``
reads either layout, and ``attn_proj`` gives one attention projection of
either.

The KV cache is a pair of lists of per-layer [B, kv_heads, max_len,
head_dim] tensors (the reference stacks them [layers, ...]); each layer
writes its fresh k/v into its own tensor IN PLACE at ``write_pos`` (the
reference returns an updated copy; in place saves the copy, and a traced
program whose writes are made functional copies one layer's cache a write,
not all of them). A decode step's or verify chunk's slot ``pos`` is a 0-d
int tensor on the batch's device, as the reference's traced ``Lp + i``:
the write goes by index (``index_copy_``, the counterpart of its
``dynamic_update_slice``) and the rope positions and the causal bound are
computed from it, so the decode loop reads nothing back from the device
(models/anyref.py). Prefill runs
the causal CUDA kernel and the fused RMSNorm kernel; decode steps and
speculative verify chunks run plain attention and plain norms, as the
reference does. ``forward`` (training) writes no cache and runs the
differentiable causal kernel with plain norms (the reference's fused
RMSNorm has no gradient); with ``remat`` each layer is checkpointed.

Tensor parallel (parallel/partition.py ``shard_params``, ``group`` the
mesh's "model" process group): a layer reads its local head counts from its
weights' widths, and the row-parallel o and down products sum their fp32
partials over the group (one all-reduce each, where the reference's
compiler inserts them) before the one rounding to the activations' dtype;
``embed`` looks up the rank's vocabulary rows and ``logits`` writes the
rank's columns into the full row, each summed over the group (exact: the
other ranks add zeros). An int8 decoder is replicated (the reference's
specs): its layers and lm_head_q run whole on every rank. Under autograd
(``forward``, training) those sums pass the gradient through unchanged
and the inputs of the column-parallel q/k/v, gate/up and lm_head sum their
gradient over the group (parallel/collectives.py), so the residual
stream's gradient is the whole one on every rank; serving sums in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..ops.attention import causal_attention
from ..ops.common import linear, rms_norm, silu
from ..parallel.collectives import copy_to_group, reduce_from_group


class KVCache(NamedTuple):
    k: list  # layers x [B, kv_heads, max_len, head_dim]
    v: list


def embed(params: dict, input_ids, dtype=torch.bfloat16, group=None):
    """Token embeddings in ``dtype``; with a "model" ``group``, the rank's
    block of vocabulary rows looked up (zeros elsewhere) and summed over
    the group."""
    table = params["embed_tokens"]
    if group is None:
        return table[input_ids].to(dtype)
    n = table.shape[0]
    local = input_ids - dist.get_rank(group) * n
    mine = (local >= 0) & (local < n)
    out = torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0)
    return reduce_from_group(out, group).to(dtype)


@torch.no_grad()
def transpose_for_serving(params: dict) -> dict:
    """Store each decoder matrix transposed, ``{"w_t": [out, in]}``
    (ops.common.linear's "w_t" path), IN PLACE, weight by weight: the
    contiguous [out, in] copy of one projection is made, then its [in, out]
    weight dropped, so peak memory stays within one extra projection. The
    caller's tree is consumed. Leaves without "w" (an int8 leaf, one
    already transposed) are left as they are."""
    for layer in params["layers"]:
        for grp in ("attn", "mlp"):
            for name in list(layer[grp]):
                p = layer[grp][name]
                if "w" in p:
                    new = {"w_t": p["w"].T.contiguous()}
                    if "b" in p:
                        new["b"] = p["b"]
                    layer[grp][name] = new
    return params


@torch.no_grad()
def fuse_for_serving(params: dict) -> dict:
    """Concatenate each layer's q/k/v weights into ``attn["qkv"]`` and its
    gate/up weights into ``mlp["gate_up"]``, ``{"w_t": [out, in]}`` (rows
    in that order), IN PLACE, layer by layer, so peak memory stays within
    one extra fused projection. Each output element is the same dot product
    as before; only the number of products drops (7 -> 4 a layer). Takes the
    transposed layout of transpose_for_serving, or plain [in, out] weights,
    transposed on the fly; idempotent."""
    def take(p):
        return p["w_t"] if "w_t" in p else p["w"].T

    for layer in params["layers"]:
        attn, mlp = layer["attn"], layer["mlp"]
        if "qkv" not in attn:
            attn["qkv"] = {"w_t": torch.cat(
                [take(attn.pop(k)) for k in ("q", "k", "v")], 0)}
        if "gate_up" not in mlp:
            mlp["gate_up"] = {"w_t": torch.cat(
                [take(mlp.pop(k)) for k in ("gate", "up")], 0)}
    return params


def attn_proj(attn: dict, name: str, cfg: LlamaConfig) -> dict:
    """The linear leaf of one attention projection ("q", "k" or "v") in
    either layout: after fuse_for_serving, a row-block view of the fused
    ``qkv["w_t"]`` (the rephrase pooling projects q and k alone)."""
    if name in attn:
        return attn[name]
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    lo, hi = {"q": (0, nq), "k": (nq, nq + nkv),
              "v": (nq + nkv, nq + 2 * nkv)}[name]
    return {"w_t": attn["qkv"]["w_t"][lo:hi]}


def _width(p: dict) -> int:
    """Output features of a linear leaf in any storage ("w" [in, out],
    "w_t" [out, in], int8 "w_q" [in, out])."""
    return p["w_t"].shape[0] if "w_t" in p else (p.get("w", p.get("w_q"))
                                                 .shape[1])


def local_kv_heads(params: dict, cfg: LlamaConfig) -> int:
    """The kv heads this rank's decoder holds (cfg's, unless "k" is a
    block of them)."""
    attn = params["layers"][0]["attn"]
    return _width(attn["k"]) // cfg.head_dim if "k" in attn \
        else cfg.num_kv_heads


class _PartialProduct(torch.autograd.Function):
    """x [N, K] @ w [K, M] in x's dtype, accumulated and returned in fp32
    (``torch.mm(out_dtype=torch.float32)``, which autograd does not
    differentiate); the backward's products in x's dtype, as the unsharded
    product's backward computes them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        return (grad @ w.T if ctx.needs_input_grad[0] else None,
                x.T @ grad if ctx.needs_input_grad[1] else None)


def _row_parallel(p: dict, x, group):
    """A row-parallel product (the rank's block of input features): the
    fp32 partial summed over ``group``, then rounded to x's dtype once, as
    the unsharded product rounds its fp32 accumulator."""
    w = (p["w_t"].T if "w_t" in p else p["w"]).to(x.dtype)
    if x.is_cuda:
        y = _PartialProduct.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], -1)
    else:
        y = torch.matmul(x.float(), w.float())
    y = reduce_from_group(y, group).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


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


def _layer(p, cfg: LlamaConfig, x, mode: str, cache, write_pos,
           layer_idx: int, rope_tables, kv_start=None, kv_len=None,
           fused_norms: bool = False, group=None):
    """mode "prefill" attends over the fresh prompt keys (causal kernel),
    written at slot 0; "decode" attends over the whole cache after writing
    the new keys at ``write_pos`` (a 0-d int tensor);
    "full" (training) writes no cache and takes the differentiable causal
    kernel (``cache`` is None there). With a "model" ``group``, the
    attention and the MLP whose weights are blocks sum over it."""
    tp = group is not None and "q" in p["attn"] and (
        _width(p["attn"]["q"]) < cfg.num_heads * cfg.head_dim)
    h = rms_norm(p["input_norm"], x, eps=cfg.rms_norm_eps, fused=fused_norms)
    if tp:
        h = copy_to_group(h, group)
    if "qkv" in p["attn"]:       # the fused serving layout
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        qkv = linear(p["attn"]["qkv"], h)
        q_p, k_p, v_p = (qkv[..., :nq], qkv[..., nq:nq + nkv],
                         qkv[..., nq + nkv:])
    else:
        q_p, k_p, v_p = (linear(p["attn"][n], h) for n in ("q", "k", "v"))
    hd = cfg.head_dim
    q = _split_heads(q_p, q_p.shape[-1] // hd, hd)
    k = _split_heads(k_p, k_p.shape[-1] // hd, hd)
    v = _split_heads(v_p, v_p.shape[-1] // hd, hd)
    q = _rope(q, rope_tables)
    k = _rope(k, rope_tables)

    if mode == "prefill":
        L = k.shape[2]
        cache.k[layer_idx][:, :, :L] = k
        cache.v[layer_idx][:, :, :L] = v
    elif mode == "decode":
        slots = write_pos + torch.arange(k.shape[2], device=k.device)
        cache.k[layer_idx].index_copy_(2, slots, k)
        cache.v[layer_idx].index_copy_(2, slots, v)
        k, v = cache.k[layer_idx], cache.v[layer_idx]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    attn = causal_attention(q, k, v,
                            q_offset=write_pos if mode == "decode" else 0,
                            kv_len=kv_len, kv_start=kv_start,
                            differentiable=mode == "full")
    if tp:
        x = x + _row_parallel(p["attn"]["o"], _merge_heads(attn), group)
    else:
        x = x + linear(p["attn"]["o"], _merge_heads(attn))
    h = rms_norm(p["post_attn_norm"], x, eps=cfg.rms_norm_eps,
                 fused=fused_norms)
    if tp:
        h = copy_to_group(h, group)
    if "gate_up" in p["mlp"]:    # the fused serving layout
        gu = linear(p["mlp"]["gate_up"], h)
        inter = cfg.intermediate_size
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate, up = (linear(p["mlp"][n], h) for n in ("gate", "up"))
    if tp:
        return x + _row_parallel(p["mlp"]["down"], silu(gate) * up, group)
    return x + linear(p["mlp"]["down"], silu(gate) * up)


def forward(params: dict, cfg: LlamaConfig, embeds, positions=None,
            kv_len=None, return_last_input: bool = False,
            remat: bool = False, group=None):
    """Full-sequence forward (training, no cache): post-final-norm hidden
    [B, L, D]; with ``return_last_input`` also the residual stream entering
    the final layer. ``kv_len`` [B] masks trailing keys and takes plain
    attention, as in the reference. ``remat`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): only the layer inputs stay
    alive between the passes and the backward recomputes each layer, the
    attention kernel's forward and the layer's collectives included (every
    rank recomputes in the same order). A layer draws no random numbers, so
    the checkpoint saves no generator state, a read of the CUDA
    generator that a CUDA graph capture may refuse (train/trainer.py).
    ``group``: the "model" group of a tree from ``shard_params`` (the
    attention then runs on the rank's heads)."""
    B, L, _ = embeds.shape
    if positions is None:
        positions = torch.arange(L, device=embeds.device)
    rt = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    last_in = None
    for i, p in enumerate(params["layers"]):
        if i == len(params["layers"]) - 1:
            last_in = x
        args = (p, cfg, x, "full", None, 0, i, rt, None, kv_len, False,
                group)
        x = (checkpoint(_layer, *args, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _layer(*args))
    out = rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)
    if return_last_input:
        return out, last_in
    return out


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               kv_heads=None) -> KVCache:
    """Zeros [B, kv_heads, max_len, head_dim], one tensor a layer, for k
    and for v; ``kv_heads`` defaults to cfg's (a tensor-parallel rank holds
    ``local_kv_heads``)."""
    shape = (batch, kv_heads or cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(*([torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(cfg.num_layers)] for _ in range(2)))


def _run(params, cfg, x, positions, mode, cache, write_pos, pad_len,
         fused_norms, return_last_input, group):
    rt = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    last = len(params["layers"]) - 1
    last_in = None
    for i, p in enumerate(params["layers"]):
        if i == last:
            last_in = x
        x = _layer(p, cfg, x, mode, cache, write_pos, i, rt,
                   kv_start=pad_len, fused_norms=fused_norms, group=group)
    out = (rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps), cache)
    return out + (last_in,) if return_last_input else out


def prefill(params: dict, cfg: LlamaConfig, embeds, cache: KVCache,
            pad_len=None, return_last_input: bool = False, group=None):
    """Run the prompt, filling cache slots [0, L). Returns (post-norm hidden
    [B, L, D], cache)[, the residual stream entering the final layer
    [B, L, D]]. ``pad_len`` [B] is each row's left pad: rope positions
    shift so the first real token sits at 0, and pad keys are masked."""
    B, L, _ = embeds.shape
    positions = torch.arange(L, device=embeds.device)
    if pad_len is not None:
        positions = (positions[None, :] - pad_len[:, None]).clamp_min(0)
    return _run(params, cfg, embeds, positions, "prefill", cache, 0, pad_len,
                True, return_last_input, group)


def decode_chunk(params: dict, cfg: LlamaConfig, embeds, pos,
                 cache: KVCache, pad_len=None,
                 return_last_input: bool = False, group=None):
    """G consecutive tokens [B, G, D] at cache slots pos .. pos+G-1 (a
    speculative verify chunk; G = 1 is a decode step), ``pos`` a 0-d int
    tensor on the batch's device; outputs as ``prefill``'s. Rejected draft
    entries left in the cache are rewritten before any query attends
    them."""
    B, G, _ = embeds.shape
    positions = pos + torch.arange(G, device=embeds.device)[None, :]
    if pad_len is not None:
        positions = positions - pad_len[:, None]
    return _run(params, cfg, embeds, positions, "decode", cache, pos, pad_len,
                False, return_last_input, group)


def decode_step(params: dict, cfg: LlamaConfig, embeds, pos,
                cache: KVCache, pad_len=None,
                return_last_input: bool = False, group=None):
    """One decode step, embeds [B, 1, D] at cache slot ``pos`` (a 0-d int
    tensor)."""
    return decode_chunk(params, cfg, embeds, pos, cache, pad_len,
                        return_last_input, group)


def logits(params: dict, hidden, group=None):
    """lm_head in fp32; on an int8 tree (ops/quant.py) the int8 lm_head in
    hidden's dtype (bf16 in generate), only then cast to fp32, as the
    reference rounds it. With a "model" ``group``, the rank's block of
    columns written into the full row and summed over the group."""
    if params.get("lm_head_q") is not None:
        return linear(params["lm_head_q"], hidden).float()
    hidden = copy_to_group(hidden, group)
    out = torch.matmul(hidden.float(), params["lm_head"].float())
    if group is None:
        return out
    n = out.shape[-1]
    lo = dist.get_rank(group) * n
    width = n * dist.get_world_size(group)
    full = torch.nn.functional.pad(out, (lo, width - lo - n))
    return reduce_from_group(full, group)
