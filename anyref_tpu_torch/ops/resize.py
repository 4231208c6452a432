"""Bilinear resize and SAM mask postprocess (the port's own copy of
anyref_tpu/ops/resize.py).

Semantics match torch.nn.functional.interpolate(mode="bilinear",
align_corners=False). On the host (numpy) it is a 2-tap gather + lerp per
axis; on tensors (the training loss canvas) two fp32 products with dense
[out, in] weight matrices, which autograd differentiates.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _bilinear_weight_matrix(in_size: int, out_size: int,
                            device) -> torch.Tensor:
    """[out, in] fp32 on ``device``, at most two nonzeros per row:
    pytorch's area_pixel_compute_source_index with align_corners=False,
    src = max(0, scale * (dst + 0.5) - 0.5), in fp32 coordinates, the two
    weights summed in fp64 and rounded once (an edge row's taps coincide).
    Built on the device from its shape alone: no host data, so a CUDA graph
    capture of the training step holds it."""
    if in_size == out_size:
        return torch.eye(in_size, dtype=torch.float32, device=device)
    scale = float(np.float32(in_size) / np.float32(out_size))
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.clamp_min((dst + 0.5) * scale - 0.5, 0.0)
    x0 = torch.floor(src).long().clamp_max(in_size - 1)
    x1 = (x0 + 1).clamp_max(in_size - 1)
    lam = (src - x0.float()).double()
    w = torch.zeros((out_size, in_size), dtype=torch.float64, device=device)
    w.scatter_add_(1, x0[:, None], (1.0 - lam)[:, None])
    w.scatter_add_(1, x1[:, None], lam[:, None])
    return w.float()


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two dims of ``x`` [..., H, W] in fp32 (full fp32
    products, as the reference's HIGHEST precision), back in x's dtype."""
    h, w = x.shape[-2], x.shape[-1]
    wh = _bilinear_weight_matrix(h, out_h, x.device)
    ww = _bilinear_weight_matrix(w, out_w, x.device)
    y = torch.einsum("...hw,vw->...hv", x.float(), ww)
    y = torch.einsum("...hv,uh->...uv", y, wh)
    return y.to(x.dtype)


def postprocess_masks_fixed(masks: torch.Tensor,
                            image_size: int) -> torch.Tensor:
    """Stage 1 of the SAM postprocess: low-res logits -> image_size^2
    canvas (the crop and original-size resize are host-side)."""
    return resize_bilinear(masks, image_size, image_size)


@functools.lru_cache(maxsize=512)
def _bilinear_taps(in_size: int, out_size: int):
    """Per-output-pixel taps (x0, x1) and weight lam, with fp32 coordinate
    arithmetic (src = max(0, scale * (dst + 0.5) - 0.5)); lam is 0 where the
    taps coincide (edges) so x0 carries weight exactly 1."""
    scale = np.float32(in_size) / np.float32(out_size)
    dst = np.arange(out_size, dtype=np.float32)
    src = np.maximum(scale * (dst + np.float32(0.5)) - np.float32(0.5),
                     np.float32(0.0))
    x0 = np.floor(src).astype(np.int64)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    lam = (src - x0.astype(np.float32)).astype(np.float32)
    lam[x0 == x1] = 0.0
    return x0, x1, lam


def resize_bilinear_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize the last two dims of ``x`` to (out_h, out_w), in fp32."""
    x = x.astype(np.float32)
    x0, x1, lam = _bilinear_taps(x.shape[-1], out_w)
    x = x[..., x0] * (1.0 - lam) + x[..., x1] * lam
    y0, y1, mu = _bilinear_taps(x.shape[-2], out_h)
    mu = mu[:, None]
    x = x[..., y0, :] * (1.0 - mu) + x[..., y1, :] * mu
    return x


def get_preprocess_shape(old_h: int, old_w: int,
                         long_side: int) -> tuple[int, int]:
    """Longest-side target shape."""
    scale = long_side / max(old_h, old_w)
    new_h, new_w = old_h * scale, old_w * scale
    return int(new_h + 0.5), int(new_w + 0.5)


def sam_normalize_pad(x: torch.Tensor, image_size: int, pixel_mean,
                      pixel_std) -> torch.Tensor:
    """Normalize float RGB pixels (0..255) ``x`` [..., 3, H, W] and zero-pad
    them at the bottom and right to ``image_size`` square (the dataset-side
    sam_preprocess)."""
    mean = torch.tensor(pixel_mean, dtype=x.dtype,
                        device=x.device).reshape(-1, 1, 1)
    std = torch.tensor(pixel_std, dtype=x.dtype,
                       device=x.device).reshape(-1, 1, 1)
    x = (x - mean) / std
    h, w = x.shape[-2], x.shape[-1]
    return torch.nn.functional.pad(x, (0, image_size - w, 0, image_size - h))


def postprocess_masks_np(low_or_canvas: np.ndarray,
                         input_size: tuple[int, int],
                         original_size: tuple[int, int]) -> np.ndarray:
    """Crop the padded region and resize to the original size."""
    m = low_or_canvas[..., : input_size[0], : input_size[1]]
    return resize_bilinear_np(m, original_size[0], original_size[1])


def postprocess_low_res_np(low_res: np.ndarray, image_size: int,
                           input_size: tuple[int, int],
                           original_size: tuple[int, int]) -> np.ndarray:
    """Full SAM postprocess from 4g^2 low-res logits: resize to
    image_size^2, crop input_size, resize to original_size."""
    canvas = resize_bilinear_np(low_res.astype(np.float32), image_size,
                                image_size)
    return postprocess_masks_np(canvas, input_size, original_size)
