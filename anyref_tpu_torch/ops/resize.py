"""Host-side bilinear resize and SAM mask postprocess in numpy (the port's
own copy of the numpy half of anyref_tpu/ops/resize.py).

Semantics match torch.nn.functional.interpolate(mode="bilinear",
align_corners=False), evaluated as a 2-tap gather + lerp per axis.
"""

from __future__ import annotations

import functools

import numpy as np


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
