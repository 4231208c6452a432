"""Ahead-of-time export of the SAM mask decoder with torch.export (port of
anyref_tpu/export.py, whose artifact is jax.export's StableHLO).

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

The JAX module's ``export_generate`` (the whole generate step) has no port
yet: generate's host loop branches on data and its kernels launch through
ctypes, which torch.export cannot trace; it needs each kernel wrapper as a
torch.library custom op with a fake implementation and generate split into
a prefill and a decode step.
"""

from __future__ import annotations

import torch

from .config import SamConfig
from .models.sam import prompt_encoder
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


def load_exported(path: str):
    """An exported artifact as a callable module."""
    return torch.export.load(path).module()
