"""Functional LoRA for the LLaMA decoder (port of anyref_tpu/train/lora.py).

Rank 8, alpha 16, adapters on q_proj/v_proj of every decoder layer, with a
``modules_to_save`` set trained densely. Adapters are a separate param tree;
``apply`` folds W' = W + (alpha/r) A@B before the forward, rounded to W's
dtype (bf16 at 7B; the gradient flows through that cast), so the decoder
never sees LoRA. ``merge`` materialises the fold for deployment.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.quant import plain_layout


@dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: float = 16.0
    targets: tuple = ("q", "v")   # q_proj / v_proj


def init(generator: torch.Generator, llama_params: dict,
         cfg: LoraConfig) -> dict:
    """One fp32 (A, B) pair per targeted projection per layer:
    A ~ N(0, 1) / r drawn from ``generator`` on its device, B = 0 (training
    starts at the base model); both on the weight's device. A decoder in
    the serving layout raises a ValueError."""
    plain_layout(llama_params["layers"], {"attn": cfg.targets}, "lora.init")
    adapters = []
    for layer in llama_params["layers"]:
        entry = {}
        for t in cfg.targets:
            w = layer["attn"][t]["w"]
            d_in, d_out = w.shape
            a = torch.randn((d_in, cfg.r), generator=generator,
                            device=generator.device) / cfg.r
            entry[t] = {"a": a.to(w.device),
                        "b": torch.zeros((cfg.r, d_out), device=w.device)}
        adapters.append(entry)
    return {"layers": adapters}


def apply(llama_params: dict, lora_params: dict, cfg: LoraConfig) -> dict:
    """llama params with the adapted weights W + (alpha/r) A@B; a decoder in
    the serving layout raises a ValueError."""
    plain_layout(llama_params["layers"], {"attn": cfg.targets}, "lora.apply")
    scale = cfg.alpha / cfg.r
    out_layers = []
    for layer, ad in zip(llama_params["layers"], lora_params["layers"]):
        new_attn = dict(layer["attn"])
        for t, p in ad.items():
            w = layer["attn"][t]["w"]
            delta = (p["a"] @ p["b"]) * scale
            new_attn[t] = {**layer["attn"][t], "w": w + delta.to(w.dtype)}
        out_layers.append({**layer, "attn": new_attn})
    return {**llama_params, "layers": out_layers}


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fresh(v) for v in tree]
    return tree


@torch.no_grad()
def merge(llama_params: dict, lora_params: dict, cfg: LoraConfig) -> dict:
    """Merged weights for deployment, in fresh containers (the adapted
    weights are new tensors, the others shared with the input)."""
    return _fresh(apply(llama_params, lora_params, cfg))


# ---------------------------------------------------------------------------
# trainable / frozen split (the reference's modules_to_save)
# ---------------------------------------------------------------------------
TRAINABLE_DENSE = (
    ("llama", "embed_tokens"),
    ("llama", "lm_head"),
    ("text_hidden_fcs",),
    ("sam", "mask_decoder", "mask_tokens"),
    ("sam", "mask_decoder", "upscale"),
    ("sam", "mask_decoder", "hyper_mlps"),
)
TRAINABLE_OPTIONAL = (
    ("audio_projector",),
    ("loc_embeddings",),
    ("roi_embed",),
)


def split_trainable(params: dict) -> tuple[dict, dict]:
    """(trainable_dense, frozen): both keep the full structure, with None
    at the other's positions (so merging is a tree walk)."""
    paths = list(TRAINABLE_DENSE) + [p for p in TRAINABLE_OPTIONAL
                                     if _get(params, p) is not None]

    def build(tree, paths_, keep):
        out = {}
        for k, v in tree.items():
            sub = [p[1:] for p in paths_ if p and p[0] == k]
            if any(len(p) == 0 for p in sub):
                out[k] = v if keep else None
            elif sub and isinstance(v, dict):
                out[k] = build(v, sub, keep)
            else:
                out[k] = None if keep else v
        return out

    return build(params, paths, True), build(params, paths, False)


def merge_params(trainable: dict, frozen: dict) -> dict:
    """Inverse of split_trainable."""
    def m(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            return {k: m(a.get(k), b.get(k)) for k in {**b, **a}}
        return a if b is None else b if a is None else a
    return m(trainable, frozen)


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree
