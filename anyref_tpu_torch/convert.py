"""Checkpoint conversion: torch/HF state dicts -> the port's param tree (port
of anyref_tpu/convert.py).

Inputs are ``{name: torch.Tensor | np.ndarray}`` in the reference's layouts
(checkpoint._load_torch_state_dict reads .pth / .bin / .safetensors files);
bf16 tensors are read as they are. Each function returns the tree that
params.init makes for that part: torch tensors on an explicit ``device`` in
an explicit ``dtype`` (``text_hidden_fcs``, ``loc_embeddings``, SAM's
``pe_gaussian`` and LLaMA's ``embed_tokens`` / ``lm_head`` stay fp32), linear
``w`` as [in, out], conv weights OIHW.

Covers SAM (SAM/sam_vit_h_4b8939.pth), the CLIP ViT-L vision tower (HF
``CLIPVisionModel``), LLaMA (HF ``LlamaForCausalLM``), LLaVA's mm_projector,
the ImageBind audio branch and the AnyRef heads (text_hidden_fcs /
audio_projector / loc_embeddings). ``merge_lora_into`` folds a LoRA adapter
into a base weight (reference merge_lora.py:58-62).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (ClipVisionConfig, ImageBindAudioConfig, LlamaConfig,
                     SamConfig)
from .params import resolve_device


class _Reader:
    """Leaves of one state dict, each moved to the device first and then
    cast (an exact widening or a round to nearest even, the same on every
    device), transposed there."""

    def __init__(self, sd: dict, dtype: torch.dtype, device):
        self.sd = sd
        self.dtype = dtype
        self.dev = resolve_device(device)

    def has(self, name: str) -> bool:
        return name in self.sd

    def raw(self, name: str) -> torch.Tensor:
        x = self.sd[name]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.dev)

    def t(self, name: str, dtype=None) -> torch.Tensor:
        return self.raw(name).to(dtype or self.dtype).contiguous()

    def lin(self, prefix: str, dtype=None) -> dict:
        """torch Linear [out, in] -> {"w": [in, out], "b"?}."""
        p = {"w": self.raw(prefix + ".weight").to(dtype or self.dtype)
             .t().contiguous()}
        if self.has(prefix + ".bias"):
            p["b"] = self.t(prefix + ".bias", dtype)
        return p

    def ln(self, prefix: str) -> dict:
        return {"scale": self.t(prefix + ".weight"),
                "bias": self.t(prefix + ".bias")}

    def conv(self, prefix: str) -> dict:
        p = {"w": self.t(prefix + ".weight")}
        if self.has(prefix + ".bias"):
            p["b"] = self.t(prefix + ".bias")
        return p

    def patch(self, name: str) -> torch.Tensor:
        """Conv patch embedding [D, C, ps, ps] -> [C * ps * ps, D]."""
        w = self.raw(name).to(self.dtype)
        return w.reshape(w.shape[0], -1).t().contiguous()


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------
def convert_sam(sd: dict, cfg: SamConfig, dtype=torch.float32, *,
                device) -> dict:
    """torch SAM state dict (``image_encoder.blocks.0.attn.qkv.weight``, ...)
    -> params for models/sam."""
    r = _Reader(sd, dtype, device)
    ie = "image_encoder."
    enc = {
        "patch_embed": {"w": r.patch(ie + "patch_embed.proj.weight"),
                        "b": r.t(ie + "patch_embed.proj.bias")},
        "pos_embed": r.t(ie + "pos_embed"),
        "blocks": [],
        "neck": {"conv1": r.conv(ie + "neck.0"), "ln1": r.ln(ie + "neck.1"),
                 "conv2": r.conv(ie + "neck.2"), "ln2": r.ln(ie + "neck.3")},
    }
    for i in range(cfg.encoder_depth):
        b = f"{ie}blocks.{i}."
        enc["blocks"].append({
            "norm1": r.ln(b + "norm1"),
            "attn": {"qkv": r.lin(b + "attn.qkv"),
                     "proj": r.lin(b + "attn.proj"),
                     "rel_pos_h": r.t(b + "attn.rel_pos_h"),
                     "rel_pos_w": r.t(b + "attn.rel_pos_w")},
            "norm2": r.ln(b + "norm2"),
            "mlp": {"lin1": r.lin(b + "mlp.lin1"),
                    "lin2": r.lin(b + "mlp.lin2")},
        })

    pe = "prompt_encoder."
    pr = {
        "pe_gaussian": r.t(pe + "pe_layer.positional_encoding_gaussian_matrix",
                           torch.float32),
        "point_embeddings": [r.t(f"{pe}point_embeddings.{i}.weight")
                             for i in range(4)],
        "not_a_point_embed": r.t(pe + "not_a_point_embed.weight"),
        "no_mask_embed": r.t(pe + "no_mask_embed.weight"),
        "mask_downscaling": {
            "conv1": r.conv(pe + "mask_downscaling.0"),
            "ln1": r.ln(pe + "mask_downscaling.1"),
            "conv2": r.conv(pe + "mask_downscaling.3"),
            "ln2": r.ln(pe + "mask_downscaling.4"),
            "conv3": r.conv(pe + "mask_downscaling.6"),
        },
    }

    def attn(prefix):
        return {"q": r.lin(prefix + ".q_proj"), "k": r.lin(prefix + ".k_proj"),
                "v": r.lin(prefix + ".v_proj"),
                "out": r.lin(prefix + ".out_proj")}

    md = "mask_decoder."
    layers = []
    for i in range(cfg.mask_decoder_depth):
        t = f"{md}transformer.layers.{i}."
        layers.append({
            "self_attn": attn(t + "self_attn"),
            "norm1": r.ln(t + "norm1"),
            "cross_attn_t2i": attn(t + "cross_attn_token_to_image"),
            "norm2": r.ln(t + "norm2"),
            "mlp": {"lin1": r.lin(t + "mlp.lin1"),
                    "lin2": r.lin(t + "mlp.lin2")},
            "norm3": r.ln(t + "norm3"),
            "cross_attn_i2t": attn(t + "cross_attn_image_to_token"),
            "norm4": r.ln(t + "norm4"),
        })
    nm = cfg.num_multimask_outputs + 1
    hyper = []
    for li in range(3):
        ps = [r.lin(f"{md}output_hypernetworks_mlps.{m}.layers.{li}")
              for m in range(nm)]
        hyper.append({"w": torch.stack([p["w"] for p in ps]),
                      "b": torch.stack([p["b"] for p in ps])})
    dec = {
        "iou_token": r.t(md + "iou_token.weight"),
        "mask_tokens": r.t(md + "mask_tokens.weight"),
        "transformer": {
            "layers": layers,
            "final_attn_t2i": attn(md + "transformer.final_attn_token_to_image"),
            "norm_final": r.ln(md + "transformer.norm_final_attn"),
        },
        "upscale": {"deconv1": r.conv(md + "output_upscaling.0"),
                    "ln": r.ln(md + "output_upscaling.1"),
                    "deconv2": r.conv(md + "output_upscaling.3")},
        "hyper_mlps": hyper,
        "iou_head": {"layers": [
            r.lin(f"{md}iou_prediction_head.layers.{i}")
            for i in range(cfg.iou_head_depth)]},
    }
    return {"image_encoder": enc, "prompt_encoder": pr, "mask_decoder": dec}


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel state dict, "vision_model." prefix)
# ---------------------------------------------------------------------------
def convert_clip_vision(sd: dict, cfg: ClipVisionConfig,
                        dtype=torch.float32, *, device) -> dict:
    r = _Reader(sd, dtype, device)
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) \
        else ""
    emb = pre + "embeddings."
    layers = []
    for i in range(cfg.num_layers):
        b = f"{pre}encoder.layers.{i}."
        layers.append({
            "ln1": r.ln(b + "layer_norm1"),
            "attn": {k: r.lin(f"{b}self_attn.{k}_proj")
                     for k in ("q", "k", "v", "out")},
            "ln2": r.ln(b + "layer_norm2"),
            "mlp": {"fc1": r.lin(b + "mlp.fc1"), "fc2": r.lin(b + "mlp.fc2")},
        })
    # HF spells it pre_layrnorm; post_layernorm is unused (select_layer -2)
    pre_ln = pre + "pre_layrnorm"
    if not r.has(pre_ln + ".weight"):
        pre_ln = pre + "pre_layernorm"
    return {
        "class_embedding": r.t(emb + "class_embedding"),
        "patch_embed": {"w": r.patch(emb + "patch_embedding.weight")},
        "position_embedding": r.t(emb + "position_embedding.weight"),
        "pre_layernorm": r.ln(pre_ln),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# LLaMA (HF LlamaForCausalLM state dict, "model." prefix)
# ---------------------------------------------------------------------------
def convert_llama(sd: dict, cfg: LlamaConfig, dtype=torch.bfloat16, *,
                  device) -> dict:
    r = _Reader(sd, dtype, device)

    def vocab(name):
        """[vocab, D] zero-padded to padded_vocab_size rows, in fp32 (the
        reference's fp32 islands, train.py:415-416)."""
        x = r.t(name, torch.float32)
        pad = cfg.padded_vocab_size - x.shape[0]
        if pad > 0:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        return x

    layers = []
    for i in range(cfg.num_layers):
        b = f"model.layers.{i}."
        layers.append({
            "input_norm": {"scale": r.t(b + "input_layernorm.weight")},
            "attn": {k: r.lin(f"{b}self_attn.{k}_proj")
                     for k in ("q", "k", "v", "o")},
            "post_attn_norm": {
                "scale": r.t(b + "post_attention_layernorm.weight")},
            "mlp": {k: r.lin(f"{b}mlp.{k}_proj")
                    for k in ("gate", "up", "down")},
        })
    return {
        "embed_tokens": vocab("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": {"scale": r.t("model.norm.weight")},
        "lm_head": vocab("lm_head.weight").t().contiguous(),
    }


def convert_mm_projector(sd: dict, dtype=torch.float32, *, device) -> dict:
    """LLaVA v1.1 mm_projector: one Linear(1024 -> 4096)."""
    r = _Reader(sd, dtype, device)
    for key in ("model.mm_projector", "mm_projector"):
        if r.has(key + ".weight"):
            return r.lin(key)
    raise KeyError("mm_projector weights not found")


def convert_anyref_heads(sd: dict, dtype=torch.float32, *, device) -> dict:
    """AnyRef's heads from a merged reference checkpoint (merge_lora.py
    saves the whole model): text_hidden_fcs (Sequential Linear / ReLU /
    Linear / Dropout, reference anyref.py:115-127) and loc_embeddings in
    fp32, audio_projector in ``dtype``. Returns only the heads found."""
    r = _Reader(sd, dtype, device)
    out = {}
    for pre in ("model.text_hidden_fcs.0.", "text_hidden_fcs.0."):
        if r.has(pre + "0.weight"):
            out["text_hidden_fcs"] = {"lin1": r.lin(pre + "0", torch.float32),
                                      "lin2": r.lin(pre + "2", torch.float32)}
            break
    for pre in ("model.audio_projector", "audio_projector"):
        if r.has(pre + ".weight"):
            out["audio_projector"] = r.lin(pre)
            break
    for pre in ("model.loc_embeddings", "loc_embeddings"):
        if r.has(pre + ".weight"):
            out["loc_embeddings"] = r.t(pre + ".weight", torch.float32)
            break
    return out


# ---------------------------------------------------------------------------
# ImageBind audio branch (imagebind_huge.pth layout, audio modality only:
# AnyRef deletes the others, reference anyref.py:142-147)
# ---------------------------------------------------------------------------
def convert_imagebind_audio(sd: dict, cfg: ImageBindAudioConfig,
                            dtype=torch.float32, *, device) -> dict:
    r = _Reader(sd, dtype, device)
    pre = "modality_preprocessors.audio."
    tr = "modality_trunks.audio."
    hd = "modality_heads.audio."
    blocks = []
    i = 0
    while r.has(f"{tr}blocks.{i}.attn.in_proj_weight"):
        b = f"{tr}blocks.{i}."
        blocks.append({
            "norm1": r.ln(b + "norm_1"),
            "attn": {
                "qkv": {"w": r.raw(b + "attn.in_proj_weight").to(dtype)
                        .t().contiguous(),
                        "b": r.t(b + "attn.in_proj_bias")},
                "bias_k": r.t(b + "attn.bias_k").reshape(-1),
                "bias_v": r.t(b + "attn.bias_v").reshape(-1),
                "out": r.lin(b + "attn.out_proj"),
            },
            "norm2": r.ln(b + "norm_2"),
            "mlp": {"fc1": r.lin(b + "mlp.fc1"), "fc2": r.lin(b + "mlp.fc2")},
        })
        i += 1
    return {
        "patch_conv": {"w": r.t(pre + "rgbt_stem.proj.weight")},
        "patch_norm": r.ln(pre + "rgbt_stem.norm_layer"),
        "cls_token": r.t(pre + "cls_token"),
        "pos_embed": r.t(pre + "pos_embedding_helper.pos_embed"),
        "blocks": blocks,
        "head_norm": r.ln(hd + "0"),
        "head_proj": {"w": r.raw(hd + "2.weight").to(dtype).t().contiguous()},
    }


# ---------------------------------------------------------------------------
# LoRA merge (reference merge_lora.py:58-62)
# ---------------------------------------------------------------------------
def merge_lora_into(base_w: torch.Tensor, lora_a: torch.Tensor,
                    lora_b: torch.Tensor, alpha: float, r: int
                    ) -> torch.Tensor:
    """W' = W + (alpha / r) * B @ A in fp32, torch [out, in] layout in and
    out (the conversion transposes afterwards)."""
    return base_w.float() + (alpha / r) * (lora_b.float() @ lora_a.float())
