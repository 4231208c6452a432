"""Host image preprocessing in numpy (port of anyref_tpu/data/preprocess.py,
image half, the ground-truth mask canvas and the reference crop).

Per image: a CLIP image [3, 224, 224] (CLIP-normalized, force-resized), a
SAM image [3, S, S] (longest side S, bottom/right zero pad, SAM-normalized)
and the valid extent (h', w') on the SAM canvas. The uint8 variants keep
pixels and leave normalization to the device (eval/runner.py).

CLIP's shortest-edge resize is PIL bicubic, as in the reference pipeline;
PIL is imported only when an image needs that resize (an image whose
shortest edge is already 224 does not).
"""

from __future__ import annotations

import numpy as np

from ..config import SAM_PIXEL_MEAN, SAM_PIXEL_STD
from ..models.clip_vit import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from ..ops.resize import get_preprocess_shape, resize_bilinear_np


def _shortest_edge_size(h: int, w: int, short: int) -> tuple[int, int]:
    """Shortest edge -> ``short``, the other side scaled with int
    truncation (transformers get_resize_output_image_size)."""
    s, l = (h, w) if h <= w else (w, h)
    new_l = int(short * l / s)
    return (short, new_l) if h <= w else (new_l, short)


def _clip_shortest_edge_u8(image_rgb_u8: np.ndarray, size: int) -> np.ndarray:
    h, w = image_rgb_u8.shape[:2]
    nh, nw = _shortest_edge_size(h, w, size)
    if (nh, nw) != (h, w):
        from PIL import Image
        im = Image.fromarray(image_rgb_u8).resize((nw, nh), Image.BICUBIC)
        image_rgb_u8 = np.asarray(im)
    return image_rgb_u8


def preprocess_clip_np(image_rgb_u8: np.ndarray, size: int = 224) -> np.ndarray:
    """[H, W, 3] uint8 -> [3, size, size] CLIP-normalized float32."""
    img = _clip_shortest_edge_u8(image_rgb_u8, size)
    x = img.astype(np.float32).transpose(2, 0, 1)
    mean = np.asarray(CLIP_PIXEL_MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(CLIP_PIXEL_STD, np.float32).reshape(3, 1, 1)
    x = ((x / 255.0) - mean) / std
    if x.shape[1:] != (size, size):
        x = resize_bilinear_np(x, size, size)
    return x


def preprocess_sam_np(image_rgb_u8: np.ndarray, image_size: int = 1024
                      ) -> tuple[np.ndarray, tuple[int, int]]:
    """[H, W, 3] uint8 -> ([3, S, S] normalized + padded float32, (h', w'))."""
    h, w = image_rgb_u8.shape[:2]
    nh, nw = get_preprocess_shape(h, w, image_size)
    x = resize_bilinear_np(image_rgb_u8.astype(np.float32).transpose(2, 0, 1),
                           nh, nw)
    mean = np.asarray(SAM_PIXEL_MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(SAM_PIXEL_STD, np.float32).reshape(3, 1, 1)
    out = np.zeros((3, image_size, image_size), np.float32)
    out[:, :nh, :nw] = (x - mean) / std
    return out, (nh, nw)


def preprocess_clip_u8_np(image_rgb_u8: np.ndarray,
                          size: int = 224) -> np.ndarray:
    """[H, W, 3] uint8 -> [3, size, size] uint8 pixels (normalized on the
    device by clip_vit.normalize_pixels)."""
    x = _clip_shortest_edge_u8(image_rgb_u8, size).transpose(2, 0, 1)
    if x.shape[1:] != (size, size):
        xf = resize_bilinear_np(x.astype(np.float32), size, size)
        x = np.clip(np.rint(xf), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(x)


def preprocess_sam_u8_np(image_rgb_u8: np.ndarray, image_size: int = 1024
                         ) -> tuple[np.ndarray, tuple[int, int]]:
    """[H, W, 3] uint8 -> ([3, S, S] uint8 pixel canvas, (h', w'));
    normalization and pad re-zeroing run on the device."""
    h, w = image_rgb_u8.shape[:2]
    nh, nw = get_preprocess_shape(h, w, image_size)
    x = resize_bilinear_np(
        image_rgb_u8.astype(np.float32).transpose(2, 0, 1), nh, nw)
    out = np.zeros((3, image_size, image_size), np.uint8)
    out[:, :nh, :nw] = np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return out, (nh, nw)


def mask_to_canvas_np(mask: np.ndarray, resized_hw: tuple[int, int],
                      image_size: int = 1024) -> np.ndarray:
    """GT mask [H, W] {0,1} -> float32 [S, S] canvas aligned with the SAM
    frame (nearest resize to the resized extent, zero pad). The losses run
    on this canvas with the padded region masked out."""
    nh, nw = resized_hw
    H, W = mask.shape
    ys = np.minimum((np.arange(nh) + 0.5) * H / nh, H - 1).astype(np.int64)
    xs = np.minimum((np.arange(nw) + 0.5) * W / nw, W - 1).astype(np.int64)
    out = np.zeros((image_size, image_size), np.float32)
    out[:nh, :nw] = mask[ys][:, xs].astype(np.float32)
    return out


def crop_box_np(image_rgb_u8: np.ndarray, xyxy: np.ndarray,
                mask: np.ndarray | None = None) -> np.ndarray:
    """The reference crop of the image-reference pathway: the box's pixels,
    optionally multiplied by a mask. Corners round to whole pixels; the
    top-left is clamped inside the image, so a 1-pixel box inset at the
    right or bottom edge still crops one pixel (not zero, which would break
    CLIP's shortest-edge resize)."""
    x1, y1, x2, y2 = [int(round(float(v))) for v in xyxy]
    h, w = image_rgb_u8.shape[:2]
    x1, y1 = min(max(x1, 0), w - 1), min(max(y1, 0), h - 1)
    x2 = min(max(x2, x1 + 1), w)
    y2 = min(max(y2, y1 + 1), h)
    crop = image_rgb_u8[y1:y2, x1:x2]
    if mask is not None:
        crop = crop * mask[y1:y2, x1:x2, None].astype(crop.dtype)
    return crop
