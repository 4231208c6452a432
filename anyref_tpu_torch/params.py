"""Parameter trees: the JAX tree bridged to tensors, or made from a seed.

The tree is the reference's nested dict (and list) of arrays, key for key:
linear ``w`` is [in, out], conv weights are OIHW, ``text_hidden_fcs`` and the
LLaMA ``embed_tokens``/``lm_head`` are fp32 whatever the model dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import IMG_REF_NUM, AnyRefConfig


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    another; asking for CUDA where there is none raises (the port never
    carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "anyref_tpu_torch runs on a CUDA device unless told otherwise, "
            "and no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device="cuda"):
    """Map a param tree of numpy arrays (e.g. ``jax.device_get`` of the JAX
    tree) one-for-one onto tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, dev) for v in tree]
    return _to_tensor(tree, dev)


class _Maker:
    """Tensors of the reference init's shapes and dtypes from one
    generator, made directly on the device."""

    def __init__(self, generator: torch.Generator, device: torch.device):
        self.g = generator
        self.dev = device

    def normal(self, shape, std: float, dtype):
        return torch.randn(shape, generator=self.g, device=self.dev,
                           dtype=dtype).mul_(std)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, device=self.dev, dtype=dtype)

    def ones(self, shape, dtype):
        return torch.ones(shape, device=self.dev, dtype=dtype)

    def lin(self, i, o, dtype, bias=True, std=None):
        p = {"w": self.normal((i, o), i ** -0.5 if std is None else std,
                              dtype)}
        if bias:
            p["b"] = self.zeros((o,), dtype)
        return p

    def ln(self, d, dtype):
        return {"scale": self.ones((d,), dtype),
                "bias": self.zeros((d,), dtype)}


def _llama(m: _Maker, c, dt):
    d = c.hidden_size
    layers = [{
        "input_norm": {"scale": m.ones((d,), dt)},
        "attn": {"q": m.lin(d, c.num_heads * c.head_dim, dt, bias=False),
                 "k": m.lin(d, c.num_kv_heads * c.head_dim, dt, bias=False),
                 "v": m.lin(d, c.num_kv_heads * c.head_dim, dt, bias=False),
                 "o": m.lin(c.num_heads * c.head_dim, d, dt, bias=False)},
        "post_attn_norm": {"scale": m.ones((d,), dt)},
        "mlp": {"gate": m.lin(d, c.intermediate_size, dt, bias=False),
                "up": m.lin(d, c.intermediate_size, dt, bias=False),
                "down": m.lin(c.intermediate_size, d, dt, bias=False)},
    } for _ in range(c.num_layers)]
    return {
        "embed_tokens": m.normal((c.padded_vocab_size, d), 0.02,
                                 torch.float32),
        "layers": layers,
        "final_norm": {"scale": m.ones((d,), dt)},
        "lm_head": m.normal((d, c.padded_vocab_size), 0.02, torch.float32),
    }


def _clip(m: _Maker, c, dt):
    d = c.hidden_size
    grid = c.image_size // c.patch_size
    layers = [{
        "ln1": m.ln(d, dt),
        "attn": {k: m.lin(d, d, dt) for k in ("q", "k", "v", "out")},
        "ln2": m.ln(d, dt),
        "mlp": {"fc1": m.lin(d, c.intermediate_size, dt),
                "fc2": m.lin(c.intermediate_size, d, dt)},
    } for _ in range(c.num_layers)]
    return {
        "class_embedding": m.normal((d,), 0.02, dt),
        "patch_embed": {"w": m.normal((3 * c.patch_size ** 2, d), 0.02, dt)},
        "position_embedding": m.normal((grid * grid + 1, d), 0.02, dt),
        "pre_layernorm": m.ln(d, dt),
        "layers": layers,
    }


def _sam(m: _Maker, c, dt):
    d = c.encoder_embed_dim
    g = c.embedding_size
    hd = d // c.encoder_num_heads
    mlp = int(d * c.mlp_ratio)
    P = c.prompt_embed_dim
    blocks = []
    for i in range(c.encoder_depth):
        size = g if i in c.encoder_global_attn_indexes else c.window_size
        blocks.append({
            "norm1": m.ln(d, dt),
            "attn": {"qkv": m.lin(d, 3 * d, dt), "proj": m.lin(d, d, dt),
                     "rel_pos_h": m.zeros((2 * size - 1, hd), dt),
                     "rel_pos_w": m.zeros((2 * size - 1, hd), dt)},
            "norm2": m.ln(d, dt),
            "mlp": {"lin1": m.lin(d, mlp, dt), "lin2": m.lin(mlp, d, dt)},
        })
    image_encoder = {
        "patch_embed": m.lin(3 * c.patch_size ** 2, d, dt),
        "pos_embed": m.zeros((1, g, g, d), dt),
        "blocks": blocks,
        "neck": {"conv1": {"w": m.normal((P, d, 1, 1), d ** -0.5, dt)},
                 "ln1": m.ln(P, dt),
                 "conv2": {"w": m.normal((P, P, 3, 3), (P * 9) ** -0.5, dt)},
                 "ln2": m.ln(P, dt)},
    }
    mc = 16  # mask-downscaling channels
    prompt_encoder = {
        "pe_gaussian": m.normal((2, P // 2), 1.0, torch.float32),
        "point_embeddings": [m.normal((1, P), 1.0, dt) for _ in range(4)],
        "not_a_point_embed": m.normal((1, P), 1.0, dt),
        "no_mask_embed": m.normal((1, P), 1.0, dt),
        "mask_downscaling": {
            "conv1": {"w": m.normal((mc // 4, 1, 2, 2), 0.25, dt),
                      "b": m.zeros((mc // 4,), dt)},
            "ln1": m.ln(mc // 4, dt),
            "conv2": {"w": m.normal((mc, mc // 4, 2, 2), 0.25, dt),
                      "b": m.zeros((mc,), dt)},
            "ln2": m.ln(mc, dt),
            "conv3": {"w": m.normal((P, mc, 1, 1), 0.25, dt),
                      "b": m.zeros((P,), dt)},
        },
    }
    nm = c.num_multimask_outputs + 1

    def attn(ds=1):
        di = P // ds
        return {"q": m.lin(P, di, dt), "k": m.lin(P, di, dt),
                "v": m.lin(P, di, dt), "out": m.lin(di, P, dt)}

    mask_decoder = {
        "iou_token": m.normal((1, P), 1.0, dt),
        "mask_tokens": m.normal((nm, P), 1.0, dt),
        "transformer": {
            "layers": [{
                "self_attn": attn(), "norm1": m.ln(P, dt),
                "cross_attn_t2i": attn(2), "norm2": m.ln(P, dt),
                "mlp": {"lin1": m.lin(P, c.mask_decoder_mlp_dim, dt),
                        "lin2": m.lin(c.mask_decoder_mlp_dim, P, dt)},
                "norm3": m.ln(P, dt),
                "cross_attn_i2t": attn(2), "norm4": m.ln(P, dt),
            } for _ in range(c.mask_decoder_depth)],
            "final_attn_t2i": attn(2),
            "norm_final": m.ln(P, dt),
        },
        "upscale": {
            "deconv1": {"w": m.normal((P, P // 4, 2, 2), 0.1, dt),
                        "b": m.zeros((P // 4,), dt)},
            "ln": m.ln(P // 4, dt),
            "deconv2": {"w": m.normal((P // 4, P // 8, 2, 2), 0.1, dt),
                        "b": m.zeros((P // 8,), dt)},
        },
        "hyper_mlps": [{"w": m.normal((nm, i, o), i ** -0.5, dt),
                        "b": m.zeros((nm, o), dt)}
                       for (i, o) in [(P, P), (P, P), (P, P // 8)]],
        "iou_head": {"layers": [m.lin(P, c.iou_head_hidden_dim, dt),
                                m.lin(c.iou_head_hidden_dim,
                                      c.iou_head_hidden_dim, dt),
                                m.lin(c.iou_head_hidden_dim, nm, dt)]},
    }
    return {"image_encoder": image_encoder, "prompt_encoder": prompt_encoder,
            "mask_decoder": mask_decoder}


def _audio(m: _Maker, c, dt):
    d = c.embed_dim
    gh = (c.mel_bins - c.kernel_size) // c.stride + 1
    gw = (c.target_len - c.kernel_size) // c.stride + 1
    blocks = [{
        "norm1": m.ln(d, dt),
        "attn": {"qkv": m.lin(d, 3 * d, dt), "bias_k": m.zeros((d,), dt),
                 "bias_v": m.zeros((d,), dt), "out": m.lin(d, d, dt)},
        "norm2": m.ln(d, dt),
        "mlp": {"fc1": m.lin(d, 4 * d, dt), "fc2": m.lin(4 * d, d, dt)},
    } for _ in range(c.num_blocks)]
    return {
        "patch_conv": {"w": m.normal((d, 1, c.kernel_size, c.kernel_size),
                                     0.02, dt)},
        "patch_norm": m.ln(d, dt),
        "cls_token": m.zeros((1, 1, d), dt),
        "pos_embed": m.normal((1, gh * gw + 1, d), d ** -0.5, dt),
        "blocks": blocks,
        "head_norm": m.ln(d, dt),
        "head_proj": m.lin(d, c.out_embed_dim, dt, bias=False),
    }


def init(cfg: AnyRefConfig, generator: torch.Generator,
         dtype=torch.bfloat16, device="cuda") -> dict:
    """Random weights with the reference init's tree, shapes, dtypes and
    scales (not its numbers: a torch generator is not a JAX key), made
    directly on ``device`` from ``generator`` (which must live there)."""
    dev = resolve_device(device)
    m = _Maker(generator, dev)
    d = cfg.llama.hidden_size
    f32 = torch.float32
    params = {
        "llama": _llama(m, cfg.llama, dtype),
        "clip": _clip(m, cfg.clip, dtype),
        "sam": _sam(m, cfg.sam, dtype),
        "mm_projector": m.lin(cfg.clip.hidden_size, d, dtype, std=0.02),
        "text_hidden_fcs": {"lin1": m.lin(d, d, f32),
                            "lin2": m.lin(d, cfg.out_dim, f32)},
    }
    if cfg.audio is not None:
        params["audio_encoder"] = _audio(m, cfg.audio, dtype)
        params["audio_projector"] = m.lin(cfg.audio.out_embed_dim, d, dtype,
                                          std=0.02)
    if cfg.use_loc_tokens:
        params["loc_embeddings"] = m.normal(
            (cfg.tokens.num_loc, cfg.out_dim), 0.02, f32)
    params["roi_embed"] = m.normal((IMG_REF_NUM, 101, d), 0.02, dtype)
    return params
