"""COCO RLE mask codec (port of anyref_tpu/data/rle.py): ctypes bindings
over csrc/rle.cpp, the COCO string (de)compression layer, and the numpy
versions of the codec.

The native library is built with g++ (host code, no nvcc) into
``anyref_tpu_torch/build/`` on first use, named by a hash of its source;
processes that start together build it once (``build_library`` holds a
file lock: the others wait, then load the finished library).
A failed build raises with the compiler's output: there is no silent
fallback, because the numpy polygon fill (PIL's) is not the native
pycocotools fill, and ground-truth masks drawn by another fill change cIoU.
``native()`` names the library that ran. The numpy versions (``_*_np``)
stay as the plain reference the tests hold the native codec against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..utils.locks import file_lock

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rle.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_load_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librle-{tag}.so"


def compile_library(src: Path, so: Path) -> Path:
    """g++ ``src`` into ``so`` through a unique temporary name and an atomic
    rename, so that no process loads a half-written library; raises with
    the compiler's output when the build fails."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=so.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build_library(src: Path, so: Path) -> bool:
    """Build ``so`` from ``src`` unless it exists, under a lock on
    ``<so>.lock`` so that one of the processes racing the first use
    compiles and the rest wait for its library. True where this call
    compiled."""
    if so.exists():
        return False
    with file_lock(so.with_name(so.name + ".lock")):
        if so.exists():
            return False
        compile_library(src, so)
        return True


def _load():
    global _lib
    with _load_lock:   # the loader's worker threads race the first use
        if _lib is None:
            so = library_path()
            build_library(SOURCE, so)
            lib = ctypes.CDLL(str(so))
            u32p = ctypes.POINTER(ctypes.c_uint32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            sigs = {
                "rle_encode": (ctypes.c_int,
                               [u8p, ctypes.c_int, ctypes.c_int, u32p]),
                "rle_decode": (None, [u32p, ctypes.c_int, u8p, ctypes.c_long]),
                "rle_area": (ctypes.c_ulonglong, [u32p, ctypes.c_int]),
                "rle_merge_or": (ctypes.c_int,
                                 [u32p, ctypes.c_int, u32p, ctypes.c_int,
                                  u32p, ctypes.c_long]),
                "rle_to_bbox": (None, [u32p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_double)]),
                "rle_from_poly": (ctypes.c_int,
                                  [ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   u32p]),
                "rle_from_string": (ctypes.c_int, [u8p, ctypes.c_long, u32p]),
                "rle_to_string": (ctypes.c_long, [u32p, ctypes.c_int, u8p]),
            }
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = (lib, so)
        return _lib[0]


def native() -> str:
    """The path of the native library the codec runs (built on first use;
    raises where it cannot be built)."""
    _load()
    return str(_lib[1])


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _u32(arr):
    return np.ascontiguousarray(arr, np.uint32)


def _counts(rle: dict) -> np.ndarray:
    """An RLE dict's counts as np.uint32, decompressing the COCO string
    encoding when present."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts)
    return _u32(counts)


# ---------------------------------------------------------------------------
# core codec
# ---------------------------------------------------------------------------
def encode(mask: np.ndarray) -> dict:
    """[H, W] {0,1} -> rle dict {"size": [h, w], "counts": np.uint32[...]}"""
    h, w = mask.shape
    fmask = np.asfortranarray(mask, np.uint8).reshape(-1, order="F")
    out = np.empty(h * w + 1, np.uint32)
    m = _load().rle_encode(_ptr(fmask, ctypes.c_uint8), h, w,
                           _ptr(out, ctypes.c_uint32))
    return {"size": [h, w], "counts": out[:m].copy()}


def decode(rle: dict) -> np.ndarray:
    """rle dict -> [H, W] uint8 mask."""
    h, w = rle["size"]
    counts = _counts(rle)
    out = np.empty(h * w, np.uint8)
    _load().rle_decode(_ptr(counts, ctypes.c_uint32), len(counts),
                       _ptr(out, ctypes.c_uint8), h * w)
    return out.reshape(w, h).T  # column-major -> [H, W]


def area(rle: dict) -> int:
    return int(np.asarray(_counts(rle), np.uint64)[1::2].sum())


def to_bbox(rle: dict) -> np.ndarray:
    """rle -> [x, y, w, h]."""
    h, w = rle["size"]
    counts = _counts(rle)
    bb = np.zeros(4, np.float64)
    _load().rle_to_bbox(_ptr(counts, ctypes.c_uint32), len(counts), h, w,
                        _ptr(bb, ctypes.c_double))
    return bb


def merge(rles: Sequence[dict]) -> dict:
    """Union of RLEs (pycocotools merge(intersect=False))."""
    if not rles:
        raise ValueError("merge of no RLEs")
    h, w = rles[0]["size"]
    lib = _load()
    cur = _counts(rles[0])
    for r in rles[1:]:
        b = _counts(r)
        out = np.empty(h * w + 1, np.uint32)
        m = lib.rle_merge_or(_ptr(cur, ctypes.c_uint32), len(cur),
                             _ptr(b, ctypes.c_uint32), len(b),
                             _ptr(out, ctypes.c_uint32), h * w)
        cur = out[:m].copy()
    return {"size": [h, w], "counts": cur}


def from_polygons(polys: List[Sequence[float]], h: int, w: int) -> List[dict]:
    """Polygon lists ([x0, y0, x1, y1, ...]) -> RLEs (pycocotools
    frPyObjects for polygon input)."""
    lib = _load()
    out = []
    for poly in polys:
        xy = np.ascontiguousarray(poly, np.float64)
        buf = np.empty(h * w + 2, np.uint32)
        m = lib.rle_from_poly(_ptr(xy, ctypes.c_double), len(xy) // 2, h, w,
                              _ptr(buf, ctypes.c_uint32))
        out.append({"size": [h, w], "counts": buf[:m].copy()})
    return out


def annotation_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO annotation 'segmentation' (polygons | uncompressed RLE |
    compressed RLE) -> [H, W] uint8 (any() over instance parts)."""
    if isinstance(segmentation, list):
        rles = from_polygons(segmentation, h, w)
        return decode(merge(rles)) if len(rles) > 1 else decode(rles[0])
    counts = segmentation["counts"]
    if isinstance(counts, list):
        return decode({"size": segmentation["size"],
                       "counts": np.asarray(counts, np.uint32)})
    return decode(segmentation)


# ---------------------------------------------------------------------------
# COCO compressed-string layer
# ---------------------------------------------------------------------------
def string_to_counts(s) -> np.ndarray:
    """COCO LEB128-style char encoding -> counts (delta-decoded)."""
    if isinstance(s, str):
        s = s.encode()
    buf = np.ascontiguousarray(np.frombuffer(s, np.uint8))
    out = np.empty(len(s) + 1, np.uint32)   # >= one count per char
    m = _load().rle_from_string(_ptr(buf, ctypes.c_uint8), len(s),
                                _ptr(out, ctypes.c_uint32))
    if m < 0:
        raise ValueError("truncated COCO RLE string (continuation bit set "
                         "on the final character)")
    return out[:m].copy()


def counts_to_string(counts) -> bytes:
    """counts -> COCO char encoding (delta-encoded for i > 2)."""
    c32 = _u32(np.asarray(counts, np.int64))
    buf = np.empty(16 * max(len(c32), 1), np.uint8)  # >= 8 chars a count
    n = _load().rle_to_string(_ptr(c32, ctypes.c_uint32), len(c32),
                              _ptr(buf, ctypes.c_uint8))
    return bytes(buf[:n])


# ---------------------------------------------------------------------------
# the numpy versions, the plain reference of the native codec
# ---------------------------------------------------------------------------
def _encode_np(mask: np.ndarray) -> dict:
    h, w = mask.shape
    flat = np.asfortranarray(mask, np.uint8).reshape(-1, order="F")
    flat = flat.astype(np.int8)
    change = np.flatnonzero(np.diff(flat)) + 1
    idx = np.concatenate([[0], change, [h * w]])
    counts = np.diff(idx).astype(np.uint32)
    if flat[0] == 1:
        counts = np.concatenate([[np.uint32(0)], counts])
    return {"size": [h, w], "counts": counts}


def _decode_np(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = _counts_np(rle)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    out = np.repeat(vals, counts)
    out = np.pad(out, (0, h * w - len(out)))[: h * w]
    return out.reshape(w, h).T


def _to_bbox_np(rle: dict) -> np.ndarray:
    m = _decode_np(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], np.float64)


def _merge_np(rles: Sequence[dict]) -> dict:
    acc = _decode_np(rles[0])
    for r in rles[1:]:
        acc = np.maximum(acc, _decode_np(r))
    return _encode_np(acc)


def _poly_fill_np(pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's polygon fill (pixel centers): not the pycocotools fill."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in pts], outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _counts_np(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _string_to_counts_np(counts)
    return _u32(counts)


def _string_to_counts_np(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def _counts_to_string_np(counts) -> bytes:
    counts = np.asarray(counts, np.int64)
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c - counts[i - 2]) if i > 2 else int(c)
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)
