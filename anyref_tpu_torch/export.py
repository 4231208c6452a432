"""Ahead-of-time export with torch.export (port of anyref_tpu/export.py,
whose artifacts are jax.export's StableHLO): the SAM mask decoder, and the
whole generate step.

The decoder is exported as a ``.pt2`` program that ``torch.export.load``
runs without the model code, with the prompt interface of the reference's
ONNX wrapper (segment_anything/utils/onnx.py SamOnnxModel):

  (image_embedding [1, C, g, g], point_coords [1, N, 2] fp32,
   point_labels [1, N] fp32) -> (low_res_masks [1, K, 4g, 4g],
                                 iou_predictions [1, K])

point_labels: -1 padding point, 0 negative, 1 positive, 2 / 3 the top-left
/ bottom-right box corner. ``num_points`` and ``multimask`` are fixed at
export. The prompt-encoder and mask-decoder weights are buffers of the
exported module, so the artifact carries them.

``export_generate`` exports greedy generate at batch 1:

  (input_ids [1, prompt_len] int32 (left-padded, one <image>),
   clip_images [1, 3, 224, 224] fp32, sam_images [1, 3, S, S] fp32)
      -> (output_ids [1, max_new_tokens], low_res_masks [1, n_seg, 4g, 4g],
          seg_valid [1, n_seg])

with the whole param tree as buffers. The decode runs all
``max_new_tokens`` steps (anyref.generate's ``fixed_steps``: the same ids
as the early exit, whose branch on the data a program cannot hold), and
every kernel is a call of its registered op (ops/flash.py), which a
loading interpreter gets by importing this module.
"""

from __future__ import annotations

import torch

from .config import AnyRefConfig, SamConfig
from .models import anyref
from .models.sam import prompt_encoder
from .ops import flash  # noqa: F401  (registers the anyref:: ops)
from .models.sam.predictor import decode_prompts
from .params import resolve_device


def sam_decoder_fn(params: dict, cfg: SamConfig, multimask: bool = True):
    """The exportable decoder as a function of (embedding, point_coords,
    point_labels) on SAM's tree ``params``."""

    def fn(embedding, point_coords, point_labels):
        pr = params["prompt_encoder"]
        pe = prompt_encoder._pe_encode(
            pr["pe_gaussian"], (point_coords + 0.5) / cfg.image_size)
        pe = prompt_encoder._label_embeds(pr, pe, point_labels)
        lab = point_labels[..., None]
        pe = pe + torch.where(lab == 2, pr["point_embeddings"][2][0], 0.0)
        pe = pe + torch.where(lab == 3, pr["point_embeddings"][3][0], 0.0)
        dense = prompt_encoder.no_mask_dense(pr, cfg, 1)
        return decode_prompts(params, cfg, embedding, pe, dense, multimask)

    return fn


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None


def _fill(skel, get, path=()):
    if isinstance(skel, dict):
        return {k: _fill(v, get, path + (str(k),)) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_fill(v, get, path + (str(i),)) for i, v in enumerate(skel)]
    return get("__".join(path))


class SamDecoder(torch.nn.Module):
    """sam_decoder_fn as a module whose buffers are the prompt-encoder and
    mask-decoder weights (named by their tree paths joined with "__")."""

    def __init__(self, params: dict, cfg: SamConfig, multimask: bool = True):
        super().__init__()
        tree = {"prompt_encoder": params["prompt_encoder"],
                "mask_decoder": params["mask_decoder"]}
        self.cfg = cfg
        self.multimask = multimask
        self._skel = _skeleton(tree)
        for path, leaf in _leaves(tree):
            self.register_buffer("__".join(path), leaf)

    def forward(self, embedding, point_coords, point_labels):
        tree = _fill(self._skel, lambda name: getattr(self, name))
        return sam_decoder_fn(tree, self.cfg, self.multimask)(
            embedding, point_coords, point_labels)


def export_sam_decoder(params: dict, cfg: SamConfig, path: str,
                       num_points: int = 5, multimask: bool = True,
                       device="cuda") -> None:
    """Export the decoder on ``device`` (its weights moved there, in their
    dtype; the embedding in the mask decoder's dtype) to ``path``
    (torch.export.save, a .pt2 file)."""
    dev = resolve_device(device)
    module = SamDecoder(params, cfg, multimask).to(dev)
    g = cfg.embedding_size
    dt = next(_leaves(params["mask_decoder"]))[1].dtype
    args = (torch.zeros(1, cfg.prompt_embed_dim, g, g, dtype=dt, device=dev),
            torch.zeros(1, num_points, 2, dtype=torch.float32, device=dev),
            torch.zeros(1, num_points, dtype=torch.float32, device=dev))
    program = torch.export.export(module, args, strict=False)
    torch.export.save(program, path)


class GenerateProgram(torch.nn.Module):
    """Greedy generate at fixed steps as a module whose buffers are the
    whole param tree (named as SamDecoder names them)."""

    def __init__(self, params: dict, cfg: AnyRefConfig, max_new_tokens: int,
                 encoder_path: str):
        super().__init__()
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.encoder_path = encoder_path
        self._skel = _skeleton(params)
        for path, leaf in _leaves(params):
            self.register_buffer("__".join(path), leaf)

    def forward(self, input_ids, clip_images, sam_images):
        tree = _fill(self._skel, lambda name: getattr(self, name))
        out = anyref.generate(
            tree, self.cfg, {"input_ids": input_ids,
                             "clip_images": clip_images,
                             "sam_images": sam_images},
            max_new_tokens=self.max_new_tokens, device=input_ids.device,
            encoder_path=self.encoder_path, fixed_steps=True)
        return out.output_ids, out.low_res_masks, out.seg_valid


def export_generate(params: dict, cfg: AnyRefConfig, path: str,
                    prompt_len: int = 129, max_new_tokens: int = 32,
                    device="cuda", encoder_path: str = "fused") -> None:
    """Export greedy generate at batch 1 on ``device``, where the params
    must live, on ``encoder_path``, to ``path`` (torch.export.save, a .pt2
    file). The decoder runs in whichever layout the tree has."""
    dev = resolve_device(device)
    p_dev = params["llama"]["embed_tokens"].device
    if p_dev.type != dev.type:
        raise ValueError(f"params live on {p_dev}, the export was asked for "
                         f"{dev}")
    module = GenerateProgram(params, cfg, max_new_tokens, encoder_path)
    ids = torch.full((1, prompt_len), 1, dtype=torch.int32, device=dev)
    ids[0, 1] = cfg.tokens.image
    args = (ids,
            torch.zeros(1, 3, cfg.clip.image_size, cfg.clip.image_size,
                        device=dev),
            torch.zeros(1, 3, cfg.sam.image_size, cfg.sam.image_size,
                        device=dev))
    program = torch.export.export(module, args, strict=False)
    torch.export.save(program, path)


def load_exported(path: str):
    """An exported artifact (either) as a callable module."""
    return torch.export.load(path).module()
