"""Hand-written CUDA kernels of the port, their plain PyTorch versions, their
launch counters and their build.

Twelve kernels, each the Hopper counterpart of a Pallas kernel of
``anyref_tpu/ops/flash.py`` or ``anyref_tpu/ops/quant.py`` (the sources
under ``anyref_tpu_torch/csrc/`` say which, what bounds each on the H100
and how its design answers that):

* ``layer_norm_fused``        <- ``layer_norm_fused`` / ``_ln_kernel``
* ``rms_norm_fused``          <- ``rms_norm_fused`` / ``_rms_kernel``
* ``flash_relpos_attention``  <- ``flash_relpos_attention`` (window and
  global kernels: ``csrc/window_attention.cu`` up to 256 tokens,
  ``csrc/relpos_global.cu`` above)
* ``flash_causal_attention``  <- ``flash_causal_attention`` (multi-head and
  per-head kernels), on the training forward's kernel without its
  log-sum-exp output
* ``fused_window_attn``       <- ``fused_window_attn``
* ``fused_mlp_stream``        <- ``fused_mlp_stream``
* ``fused_global_tail``       <- ``fused_global_tail``
* ``fused_window_block``      <- ``fused_window_block``
* ``flash_attention_qkv``     <- ``flash_attention_qkv`` / ``_mha_qkv_kernel``
* ``flash_relpos_attention_qkv`` <- ``flash_relpos_attention_qkv`` /
  ``_relpos_qkv_kernel`` (the same two kernels by the same length)
* ``flash_causal_attention_diff`` <- ``flash_causal_attention_diff``
  (forward with LSE, dq, dk/dv), a ``torch.autograd.Function``
* ``int8_matmul``             <- ``quant.py`` ``int8_matmul`` (``ops/quant``
  builds the int8 decoder on it)

The norms, the attention kernels and ``int8_matmul`` are one CUDA kernel
each (``int8_matmul`` at most 16 rows: split-K blocks in clusters that sum
their partials through distributed shared memory, on the launch plan of
``_int8_decode_plan``). The four fused layers are each a short chain of the
port's own kernels (the LayerNorm row pass of ``csrc/norms.cu`` writing
bf16 h with the window pad mask, the ``wgmma`` GEMM of ``csrc/gemm.cuh``
with a bias / GELU / residual epilogue, and the rel-pos attention kernels
on the heads of the fused QKV: ``csrc/window_attention.cu`` for the
windows, ``csrc/relpos_global.cu`` for the global layers), with no other
torch op between them than allocation, views and, in the global tail, the
fp32 bias-factor einsums the reference's wrapper also computes outside its
kernel (as both rel-pos wrappers do above 256 tokens; up to 256 the window
kernel computes the factors itself).
``flash_causal_attention_diff`` is the training attention: its forward is
the causal kernel (``csrc/causal_attention.cu``) with a log-sum-exp
output, its backward two kernels (``csrc/causal_attention_bwd.cu``: dq
over query blocks, dk/dv over key blocks) after delta = rowsum(dO * O), a
torch op here as in the reference's wrapper. The three causal kernels,
the global rel-pos kernel (``csrc/relpos_global.cu``, which with its bias
compiled out also runs ``flash_attention_qkv``), the fused layers' GEMM
and ``int8_matmul``'s prefill body are ``wgmma`` kernels fed by TMA
(``csrc/wgmma.cuh``); heads whose width is not a multiple of 8 are
zero-padded to one by the wrapper (``_causal_route``, ``_relpos_route``,
``_tma_heads``). The two norms are one kernel template
(``csrc/norms.cu``) that reads bf16 or fp32 weights as they are.

Each wrapper runs its plain version when, and only when, its input lies on
the CPU (the tests). For a CUDA tensor it launches its kernels or raises:
there is no fallback. Each wrapper carries ``.launches``, a plain int it
raises by one per call that launched its kernel (or chain), so a run can
show which kernels its path went through;
``flash_causal_attention_diff`` counts forward calls in ``.launches``
(recomputation under checkpointing included) and backward calls in
``.backward_launches``.

Build: at first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``
(one process per source, all started together) and links them into one
shared library under ``anyref_tpu_torch/build/``, named after a hash of the
sources; the library is loaded with ``ctypes`` and each C entry returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("norms.cu", "relpos_global.cu", "causal_attention.cu",
           "causal_attention_bwd.cu", "fused_layers.cu", "int8_matmul.cu",
           "window_attention.cu")
HEADERS = ("common.cuh", "gemm.cuh", "wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "compiled from anyref_tpu_torch/csrc at first use")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libanyref_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless a library of the same sources
    exists. The ptxas report of each source (registers, shared memory,
    spills) stays beside it as ``<source>-<hash>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = lib.stem.rsplit("-", 1)[1]
    jobs = []
    for name in SOURCES:
        stem = Path(name).stem
        obj = BUILD_DIR / f"{stem}-{tag}.o"
        log = BUILD_DIR / f"{stem}-{tag}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=f, stderr=subprocess.STDOUT)
        jobs.append((name, obj, log, proc))
    failed = []
    for name, _, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {name} ---\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                    *(str(j[1]) for j in jobs)], check=True)
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            sigs = {
                "anyref_layer_norm": [P, P, P, I, P, I, I, F, I, P],
                "anyref_rms_norm": [P, P, I, P, I, I, F, I, P],
                "anyref_relpos_global": [P, P, P, I, I, I, P, P, P, I, I, I,
                                         I, I, I, I, I, I, F, P],
                "anyref_attention_heads": [P, P, P, I, I, I, P, I, I, I, I,
                                           I, I, I, F, P],
                "anyref_causal_attention": [P, P, P, P, P, P, I, I, I, I, F,
                                            P],
                "anyref_causal_attention_bwd": [P] * 10 + [I, I, I, I, F, P],
                "anyref_layer_norm_rows": [P, I, P, P, I, P, I, I, F, I, I,
                                           I, I, I, I, P],
                "anyref_gemm": [P, P, P, I, P, P, I, I, I, I, I, I, P],
                "anyref_int8_matmul": [P, P, P, P, I, I, I, I, I, I, P],
                "anyref_window_relpos_attention": [P, P, P, I, I, I, P, P, P,
                                                   I, I, I, I, I, I, I, I, I,
                                                   F, I, P],
            }
            for name, args in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.anyref_error_string.argtypes = [I]
            lib.anyref_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True: run the plain version. False: the inputs are bf16 CUDA tensors
    the kernel takes. Anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                        f"{[t.dtype for t in tensors]}")
    return False


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(name: str, *args) -> None:
    lib = _library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.anyref_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# LayerNorm / RMSNorm
# ---------------------------------------------------------------------------
def layer_norm_plain(x, scale, bias, eps: float):
    """LayerNorm over the last dim, fp32 moments (ops.common.layer_norm)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm_plain(x, scale, eps: float):
    """RMSNorm over the last dim, fp32 mean square (ops.common.rms_norm)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _norm_weights(name: str, C: int, device, *ws):
    """The norm's scale (and bias) as csrc/norms.cu reads them: on x's
    device, contiguous, [C], all bf16 or all fp32 as they come (other dtypes,
    or a mix, converted to fp32)."""
    ws = [w.to(device=device) for w in ws]
    if any(w.numel() != C for w in ws):
        raise ValueError(f"{name}: weights {[tuple(w.shape) for w in ws]} "
                         f"for rows of {C}")
    if ws[0].dtype not in (torch.bfloat16, torch.float32) or \
            any(w.dtype != ws[0].dtype for w in ws):
        ws = [w.float() for w in ws]
    return [w.contiguous() for w in ws]


def layer_norm_fused(x, scale, bias, eps: float):
    """x [..., C], scale/bias [C] -> LayerNorm(x), same dtype as x. One CUDA
    kernel a call: bf16 or fp32 weights are read as they are."""
    if _on_cpu("layer_norm_fused", x):
        return layer_norm_plain(x, scale, bias, eps)
    C = x.shape[-1]
    s, b = _norm_weights("layer_norm_fused", C, x.device, scale, bias)
    xc = x.contiguous()
    N = xc.numel() // max(C, 1)
    y = torch.empty_like(xc)
    if N == 0:
        return y
    vec = int(C % 8 == 0 and _aligned(xc, y, s, b))
    with torch.cuda.device(x.device):
        _launch("anyref_layer_norm", xc.data_ptr(), s.data_ptr(),
                b.data_ptr(), int(s.dtype == torch.float32), y.data_ptr(), N,
                C, float(eps), vec, _stream(x))
    layer_norm_fused.launches += 1
    return y


def rms_norm_fused(x, scale, eps: float):
    """x [..., C], scale [C] -> RMSNorm(x), same dtype as x. One CUDA
    kernel a call: a bf16 or fp32 scale is read as it is (another dtype is
    first converted to fp32)."""
    if _on_cpu("rms_norm_fused", x):
        return rms_norm_plain(x, scale, eps)
    C = x.shape[-1]
    (s,) = _norm_weights("rms_norm_fused", C, x.device, scale)
    xc = x.contiguous()
    N = xc.numel() // max(C, 1)
    y = torch.empty_like(xc)
    if N == 0:
        return y
    vec = int(C % 8 == 0 and _aligned(xc, y, s))
    with torch.cuda.device(x.device):
        _launch("anyref_rms_norm", xc.data_ptr(), s.data_ptr(),
                int(s.dtype == torch.float32), y.data_ptr(), N, C, float(eps),
                vec, _stream(x))
    rms_norm_fused.launches += 1
    return y


layer_norm_fused.launches = 0
rms_norm_fused.launches = 0


# ---------------------------------------------------------------------------
# SAM attention with decomposed rel-pos bias
# ---------------------------------------------------------------------------
def relpos_factors(q, rel_h_table, rel_w_table, size_hw):
    """The q-dependent bias factors rh = q . Rh [B, nh, L, H] and
    rw = q . Rw [B, nh, L, W] in fp32 (anyref_tpu flash.py:203-207): two
    small products the global kernel takes from outside (grids of more than
    WINDOW_MAX_L tokens), as the reference keeps them outside its kernels;
    the window kernel computes the same sums itself."""
    H, W = size_hw
    B, nh, L, hd = q.shape
    qg = q.reshape(B, nh, H, W, hd).float()
    rh = torch.einsum("bnhwc,hkc->bnhwk", qg,
                      rel_h_table.to(q.dtype).float())
    rw = torch.einsum("bnhwc,wkc->bnhwk", qg,
                      rel_w_table.to(q.dtype).float())
    return rh.reshape(B, nh, L, H), rw.reshape(B, nh, L, W)


def _relpos_logits(q, k, rel_h_table, rel_w_table, size_hw):
    """fp32 scores q k^T * hd^-0.5 + rh[q, k // W] + rw[q, k % W] of
    q, k [B, nh, L, hd] -> [B, nh, L, L]."""
    H, W = size_hw
    B, nh, L, hd = q.shape
    rh, rw = relpos_factors(q, rel_h_table, rel_w_table, size_hw)
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * hd ** -0.5
    return (s.view(B, nh, L, H, W) + rh[..., :, None]
            + rw[..., None, :]).view(B, nh, L, L)


def relpos_attention_plain(q, k, v, rel_h_table, rel_w_table, size_hw):
    """softmax(q k^T * scale + rh[q, k // W] + rw[q, k % W]) v with fp32
    scores, p rounded to v's dtype for the product (_relpos_kernel)."""
    s = _relpos_logits(q, k, rel_h_table, rel_w_table, size_hw)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)


WINDOW_MAX_L = 256   # the most tokens csrc/window_attention.cu holds


def _relpos_route(L: int, hd: int) -> str:
    """The CUDA kernel that takes SAM rel-pos attention over L = H * W
    tokens with heads of hd: "window" (csrc/window_attention.cu, the whole
    grid in one block, the bias factors computed in the kernel) up to
    WINDOW_MAX_L tokens; above, csrc/relpos_global.cu after the factor
    einsums of relpos_factors: "global" where a row of hd bf16 is a
    multiple of 16 bytes (TMA's rule), "global_pad8" where the wrapper first
    zero-pads the heads to a multiple of 8 columns. Raises where none
    runs."""
    if L <= 0 or not 0 < hd <= 128:
        raise ValueError(f"rel-pos attention: no CUDA kernel for L {L}, "
                         f"heads of {hd} (at most 128)")
    if L <= WINDOW_MAX_L:
        return "window"
    return "global" if hd % 8 == 0 else "global_pad8"


def _head_view(t):
    """(storage offset, (sb, sh, sr)) of heads t [B, nh, L, hd] as
    csrc/relpos_global.cu reads them in place: row r of head (b, h) at
    element offset + b sb + h sh + r sr of t's storage, the row contiguous.
    None where its 4-D tensor map cannot (a row that is not contiguous, a
    width, stride or offset that is not a multiple of 8 elements, a base
    that is not 16-byte aligned: TMA's 16-byte rule)."""
    strides = tuple(t.stride()[:3])
    off = t.storage_offset()
    if (t.stride(-1) != 1 or t.shape[-1] % 8 or off % 8
            or any(x % 8 for x in strides) or not _aligned(t)):
        return None
    return off, strides


def _tma_heads(q, k, v, out):
    """q, k, v [B, nh, L, hd] and out [B, nh, L, hd] as csrc/relpos_global.cu
    takes them -> (q, k, v, their strides (sb, sh, sr), o). Views its tensor
    maps read in place (_head_view, the three sharing their strides: split
    heads, heads permuted out of a fused QKV, its column slices) are
    returned as they are; other operands are copied into one contiguous
    [3, B, nh, L, hd rounded up to 8] buffer (two torch kernels, the
    columns past hd zero). o is out where the kernel can
    write it in place, else a contiguous buffer of the padded width, to be
    copied into out."""
    hd = q.shape[-1]
    views = [_head_view(t) for t in (q, k, v)]
    if None in views or len({x[1] for x in views}) != 1:
        qkv = torch.stack((q, k, v))
        if hd % 8:
            qkv = torch.nn.functional.pad(qkv, (0, -hd % 8))
        q, k, v = qkv.unbind(0)
        views = [_head_view(t) for t in (q, k, v)]
    o = out if _head_view(out) is not None and q.shape[-1] == hd else \
        torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    return q, k, v, views[0][1], o


def _global_relpos(q, k, v, rel_h_table, rel_w_table, size_hw, out):
    """The fp32 factor einsums (relpos_factors) and one launch of
    csrc/relpos_global.cu on q, k, v [B, nh, L, hd] into out [B, nh, L, hd]
    (split heads, or a view of the head-merged [B, L, C]), the operands
    read in place or copied as _tma_heads says."""
    H, W = size_hw
    B, nh, L, hd = q.shape
    if not 0 < hd <= 128:
        raise ValueError(f"rel-pos attention: no CUDA kernel for heads of "
                         f"{hd} (at most 128)")
    rh, rw = (t.contiguous() for t in
              relpos_factors(q, rel_h_table, rel_w_table, size_hw))
    q, k, v, strides, o = _tma_heads(q, k, v, out)
    _launch("anyref_relpos_global", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *strides, rh.data_ptr(), rw.data_ptr(), o.data_ptr(),
            *o.stride()[:3], B, nh, L, q.shape[-1], H, W, hd ** -0.5,
            _stream(q))
    if o is not out:
        out.copy_(o[..., :hd])
    return out


def _window_relpos(q, k, v, rel_h_table, rel_w_table, size_hw, out):
    """One launch of csrc/window_attention.cu on the views q, k, v and out
    [B, nh, L, hd] (q, k and v copied contiguous unless they share strides
    with a contiguous last dim, as split heads or slices of a fused QKV
    do); tables [H, H, hd] and [W, W, hd]."""
    H, W = size_hw
    B, nh, L, hd = q.shape
    th, tw = (t.to(device=q.device, dtype=torch.bfloat16).contiguous()
              for t in (rel_h_table, rel_w_table))
    if th.shape != (H, H, hd) or tw.shape != (W, W, hd):
        raise ValueError(f"rel-pos attention: tables {tuple(th.shape)}, "
                         f"{tuple(tw.shape)} for grid {size_hw}, hd {hd}")
    if k.stride() != q.stride() or v.stride() != q.stride() or \
            q.stride(-1) != 1:
        q, k, v = (t.contiguous() for t in (q, k, v))
    strides = (*q.stride()[:3], *out.stride()[:3])
    vec = int(hd % 8 == 0 and all(s % 8 == 0 for s in strides)
              and _aligned(q, k, v, out))
    _launch("anyref_window_relpos_attention", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), *strides[:3], th.data_ptr(), tw.data_ptr(),
            out.data_ptr(), *strides[3:], B, nh, L, hd, H, W, hd ** -0.5,
            vec, _stream(q))
    return out


def flash_relpos_attention(q, k, v, rel_h_table, rel_w_table, size_hw):
    """q/k/v [B, nh, L, hd]; rel_*_table [S, S, hd] -> [B, nh, L, hd]. One
    launch: the window kernel up to WINDOW_MAX_L tokens, else the global
    kernel after the fp32 factor einsums; both read strided views such as
    the heads of a fused QKV in place."""
    if _on_cpu("flash_relpos_attention", q, k, v):
        return relpos_attention_plain(q, k, v, rel_h_table, rel_w_table,
                                      size_hw)
    H, W = size_hw
    B, nh, L, hd = q.shape
    if H * W != L or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_relpos_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {size_hw}")
    route = _relpos_route(L, hd)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        if route == "window":
            _window_relpos(q, k, v, rel_h_table, rel_w_table, size_hw, out)
        else:
            _global_relpos(q, k, v, rel_h_table, rel_w_table, size_hw, out)
    flash_relpos_attention.launches += 1
    return out


flash_relpos_attention.launches = 0


# ---------------------------------------------------------------------------
# causal attention with a left-pad mask: prefill, and the training forward
# ---------------------------------------------------------------------------
def _causal_keep(L: int, kv_start, device):
    """[B or 1, 1, L, L] bool: query i keeps key j <= i at or after the
    row's pad."""
    pos = torch.arange(L, device=device)
    keep = (pos[None, :] <= pos[:, None])[None]                  # [1, L, L]
    if kv_start is not None:
        keep = keep & (pos[None, None, :]
                       >= kv_start.to(device)[:, None, None])
    return keep[:, None]


def causal_attention_diff_fwd_plain(q, k, v, kv_start=None):
    """Causal attention over [B, nh, L, hd] where row b drops keys before
    kv_start[b] -> (out [B, nh, L, hd] in q's dtype, lse [B, nh, L] fp32),
    as _causal_fwd_kernel and _causal_mh_kernel: fp32 scores, float32.min
    where masked, P = exp(s - m) unnormalised and rounded to v's dtype for
    P V, the product divided by max(denom, 1e-20), so a fully masked row is
    the mean of V over all L keys; lse = m + log(max(denom, 1e-20))."""
    hd = q.shape[-1]
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * hd ** -0.5
    s = torch.where(_causal_keep(q.shape[2], kv_start, q.device), s,
                    torch.finfo(torch.float32).min)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype), (m + torch.log(denom))[..., 0]


def causal_attention_plain(q, k, v, kv_start=None):
    """The prefill attention's plain version: the output of
    causal_attention_diff_fwd_plain."""
    return causal_attention_diff_fwd_plain(q, k, v, kv_start)[0]


def _causal_route(hd: int) -> str:
    """How the causal kernels (csrc/causal_attention.cu and _bwd.cu) take
    heads of hd: "tma" where a row of hd bf16 is a multiple of 16 bytes
    (hd % 8 == 0), the row stride TMA loads need; "pad8" otherwise, where
    the wrappers zero-pad the head width to the next multiple of 8 (zero
    columns add nothing to q . k, their output and gradient columns are
    zero and sliced off). Raises where neither runs."""
    if not 0 < hd <= 128:
        raise ValueError(f"causal attention: no CUDA kernel for heads of "
                         f"{hd} (at most 128)")
    return "tma" if hd % 8 == 0 else "pad8"


def _causal_args(name: str, q, k, v, kv_start):
    """Shape check of the causal kernels -> (B, nh, L, hd, the head width
    the kernels run, kv_start as contiguous int32 on q's device or
    None)."""
    B, nh, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    hd8 = hd if _causal_route(hd) == "tma" else -(-hd // 8) * 8
    ks = (None if kv_start is None else
          kv_start.to(device=q.device, dtype=torch.int32).contiguous())
    return B, nh, L, hd, hd8, ks


def _causal_operand(t, hd8: int):
    """t [B, nh, L, hd] as the causal kernels read it: contiguous, 16-byte
    aligned, hd8 wide (zero columns appended)."""
    t = t.contiguous()
    if t.shape[-1] != hd8:
        return torch.nn.functional.pad(t, (0, hd8 - t.shape[-1]))
    return t if _aligned(t) else t.clone()


def _causal_forward(wrapper, q, k, v, kv_start, with_lse: bool):
    """Launch the causal kernel -> (out [B, nh, L, hd], lse or None)."""
    B, nh, L, hd, hd8, ks = _causal_args(wrapper.__name__, q, k, v, kv_start)
    q, k, v = (_causal_operand(t, hd8) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty(B, nh, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out[..., :hd], lse
    with torch.cuda.device(q.device):
        _launch("anyref_causal_attention", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if ks is None else ks.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                B, nh, L, hd8, hd ** -0.5, _stream(q))
    wrapper.launches += 1
    return out[..., :hd], lse


def flash_causal_attention(q, k, v, kv_start=None):
    """q/k/v [B, nh, L, hd] prefill attention; kv_start [B] int or None."""
    if _on_cpu("flash_causal_attention", q, k, v):
        return causal_attention_plain(q, k, v, kv_start)
    return _causal_forward(flash_causal_attention, q, k, v, kv_start,
                           with_lse=False)[0]


flash_causal_attention.launches = 0


# ---------------------------------------------------------------------------
# differentiable causal attention (training): forward with LSE, backward
# ---------------------------------------------------------------------------
def causal_attention_dq_plain(q, k, v, do, lse, delta, kv_start=None):
    """dq as _causal_dq_kernel: p = exp(s - lse), zero where masked;
    dp = dO V^T in fp32; ds = p (dp - delta) scale; dq = bf16(ds) K (ds in
    k's dtype). lse, delta [B, nh, L] fp32."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    keep = _causal_keep(q.shape[2], kv_start, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bnqd,bnkd->bnqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bnqk,bnkd->bnqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def causal_attention_dkv_plain(q, k, v, do, lse, delta, kv_start=None):
    """(dk, dv) as _causal_dkv_kernel, over the transposed blocks:
    p^T = exp(s^T - lse), zero where masked; dv = p^T dO with both in fp32;
    dp^T = V dO^T; ds^T = p^T (dp^T - delta) scale; dk = bf16(ds^T) Q."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    st = torch.einsum("bnkd,bnqd->bnkq", k.float(), q.float()) * scale
    keep = _causal_keep(q.shape[2], kv_start, q.device).transpose(-1, -2)
    pt = torch.where(keep, torch.exp(st - lse[..., None, :]), 0.0)
    dof = do.float()
    dv = torch.einsum("bnkq,bnqd->bnkd", pt, dof)
    dpt = torch.einsum("bnkd,bnqd->bnkq", v.float(), dof)
    dst = pt * (dpt - delta[..., None, :]) * scale
    dk = torch.einsum("bnkq,bnqd->bnkd", dst.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def causal_delta(do, out):
    """delta = rowsum(dO * O) [B, nh, L] in fp32 (products in fp32), the
    backward's torch op, as the reference's wrapper computes it."""
    return (do.float() * out).sum(-1)


def causal_attention_diff_fwd(q, k, v, kv_start=None):
    """The training forward's kernel: (out, lse [B, nh, L] fp32). q/k/v
    bf16 [B, nh, L, hd] on the card."""
    return _causal_forward(flash_causal_attention_diff, q, k, v, kv_start,
                           with_lse=True)


def causal_attention_diff_bwd(q, k, v, out, lse, do, kv_start=None):
    """The training backward's kernels: delta = causal_delta(dO, O), then
    the dq and dk/dv kernels. bf16 but lse; returns (dq, dk, dv)."""
    B, nh, L, hd, hd8, ks = _causal_args("flash_causal_attention_diff", q,
                                         k, v, kv_start)
    delta = causal_delta(do, out)
    q, k, v, do = (_causal_operand(t, hd8) for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if dq.numel() == 0:
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    with torch.cuda.device(q.device):
        _launch("anyref_causal_attention_bwd", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                None if ks is None else ks.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, nh, L, hd8, hd ** -0.5,
                _stream(q))
    flash_causal_attention_diff.backward_launches += 1
    return dq[..., :hd], dk[..., :hd], dv[..., :hd]


class _CausalAttentionDiff(torch.autograd.Function):
    """Saves q, k, v, out, lse and kv_start; the backward runs the plain
    versions for CPU tensors and the kernels for CUDA ones."""

    @staticmethod
    def forward(ctx, q, k, v, kv_start):
        ctx.plain = _on_cpu("flash_causal_attention_diff", q, k, v)
        if ctx.plain:
            out, lse = causal_attention_diff_fwd_plain(q, k, v, kv_start)
        else:
            q, k, v = (t.contiguous() for t in (q, k, v))
            out, lse = causal_attention_diff_fwd(q, k, v, kv_start)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_start = kv_start
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ks = ctx.kv_start
        do = do.contiguous()
        if ctx.plain:
            delta = causal_delta(do, out)
            dq = causal_attention_dq_plain(q, k, v, do, lse, delta, ks)
            dk, dv = causal_attention_dkv_plain(q, k, v, do, lse, delta, ks)
        else:
            _on_cpu("flash_causal_attention_diff", do)
            dq, dk, dv = causal_attention_diff_bwd(q, k, v, out, lse, do, ks)
        return dq, dk, dv, None


def flash_causal_attention_diff(q, k, v, kv_start=None):
    """Differentiable causal attention over [B, nh, L, hd] (the training
    path), kv_start [B] int or None. Neither direction materialises the
    [B, nh, L, L] scores on the card."""
    return _CausalAttentionDiff.apply(q, k, v, kv_start)


flash_causal_attention_diff.launches = 0
flash_causal_attention_diff.backward_launches = 0


# ---------------------------------------------------------------------------
# fused SAM layers and QKV-direct attention: plain versions
# ---------------------------------------------------------------------------
def _erf_f32(x):
    """erf by Abramowitz-Stegun 7.1.26 (|eps| <= 1.5e-7), as the reference's
    fused kernels compute it (anyref_tpu flash.py _erf_f32)."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    z = x.abs()
    t = 1.0 / (1.0 + p * z)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-z * z))


def gelu_exact_plain(x):
    """erf-GELU of the fused kernels (anyref_tpu flash.py _gelu_exact)."""
    return x * 0.5 * (1.0 + _erf_f32(x * 2.0 ** -0.5))


def _dot(a, w):
    """a @ w in fp32 (bf16 operands are exact in fp32): the reference's
    dot_general with preferred_element_type=float32."""
    return torch.matmul(a.float(), w.float())


def _split_qkv(qkv, num_heads: int):
    """[B, L, 3C] -> q, k, v views [B, nh, L, hd]."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    return [qkv[..., i * C:(i + 1) * C].reshape(B, L, num_heads, -1)
            .transpose(1, 2) for i in range(3)]


def _merge_heads(o):
    B, nh, L, hd = o.shape
    return o.transpose(1, 2).reshape(B, L, nh * hd)


def window_pad_mask(NW: int, L: int, ws: int, nwc: int, nw: int, grid_hw,
                    device):
    """[NW, L, 1] fp32, 1 where token l of window n lies inside the H x W
    grid: windows scan row-major over the padded grid, nwc per row, nw per
    image (anyref_tpu flash.py _window_pad_mask)."""
    H, W = grid_hw
    wi = torch.arange(NW, device=device)[:, None] % nw
    li = torch.arange(L, device=device)[None, :]
    rows = (wi // nwc) * ws + li // ws
    cols = (wi % nwc) * ws + li % ws
    return ((rows < H) & (cols < W)).float()[..., None]


def fused_relpos_attention_plain(qkv, rel_h_table, rel_w_table, size_hw,
                                 num_heads: int):
    """Rel-pos attention of all heads off the fused QKV [B, L, 3C] ->
    [B, L, C] in qkv's dtype, as the fused kernels compute it
    (_window_attn_all, _fused_global_tail_kernel): the fp32 factors of
    relpos_factors (tables rounded to qkv's dtype; for windows they are the
    kernels' q . table[(q // ws, j)] and q . table[(q % ws, j)]), P
    normalised, then rounded to v's dtype for the product."""
    q, k, v = _split_qkv(qkv, num_heads)
    s = _relpos_logits(q, k, rel_h_table, rel_w_table, size_hw)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(), v.float())
    return _merge_heads(o).to(qkv.dtype)


def relpos_attention_qkv_plain(qkv, rel_h_table, rel_w_table, size_hw,
                               num_heads: int):
    """flash_relpos_attention_qkv's plain version (_relpos_qkv_kernel): the
    attention of relpos_attention_plain on the heads of the fused QKV
    [B, L, 3C], merged into [B, L, C]. Unlike the fused kernels, P is not
    normalised before its rounding: the product is divided by the row sum
    afterwards."""
    q, k, v = _split_qkv(qkv, num_heads)
    return _merge_heads(relpos_attention_plain(q, k, v, rel_h_table,
                                               rel_w_table, size_hw))


def _window_attn_residual_plain(xw, ln1, qkv_p, tht, twt, proj_p, size_hw,
                                num_heads: int, grid_hw, nwc: int,
                                eps: float):
    """x + proj(attention(qkv(LN1(x) * pad_mask))) over windows [NW, L, C],
    in fp32: h, qkv and the attention output rounded to x's dtype."""
    ws = size_hw[0]
    NW, L, C = xw.shape
    nw = -(-grid_hw[0] // ws) * nwc
    x = xw.float().reshape(NW * L, C)
    mask = window_pad_mask(NW, L, ws, nwc, nw, grid_hw, xw.device)
    h = layer_norm_plain(x, ln1["scale"], ln1["bias"], eps) * mask.reshape(
        NW * L, 1)
    h = h.to(xw.dtype)
    qkv = (_dot(h, qkv_p["w"]) + qkv_p["b"].float()).to(xw.dtype)
    attn = fused_relpos_attention_plain(
        qkv.reshape(NW, L, 3 * C), tht.reshape(ws, ws, -1),
        twt.reshape(ws, ws, -1), size_hw, num_heads)
    proj = _dot(attn.reshape(NW * L, C), proj_p["w"]) + proj_p["b"].float()
    return x + proj


def _mlp_residual_plain(x1, ln2, mlp1_p, mlp2_p, eps: float, dtype):
    """x1 + fc2(GELU(fc1(LN2(x1)))) on fp32 rows x1 [N, C], in ``dtype``:
    the LN output and the GELU hidden rounded to ``dtype``, the residual
    sum in fp32."""
    h = layer_norm_plain(x1, ln2["scale"], ln2["bias"], eps).to(dtype)
    m1 = gelu_exact_plain(_dot(h, mlp1_p["w"])
                          + mlp1_p["b"].float()).to(dtype)
    m2 = mlp2_p["b"].float() + _dot(m1, mlp2_p["w"])
    return (x1 + m2).to(dtype)


def fused_window_attn_plain(xw, ln1, qkv_p, tht, twt, proj_p, size_hw,
                            num_heads: int, grid_hw, nwc: int, eps: float):
    """The attention half of a window layer (_fused_window_attn_kernel),
    [NW, L, C] rounded to x's dtype."""
    return _window_attn_residual_plain(
        xw, ln1, qkv_p, tht, twt, proj_p, size_hw, num_heads, grid_hw, nwc,
        eps).to(xw.dtype).reshape(xw.shape)


def fused_window_block_plain(xw, ln1, qkv_p, tht, twt, proj_p, ln2, mlp1_p,
                             mlp2_p, size_hw, num_heads: int, grid_hw,
                             nwc: int, eps: float):
    """The whole window layer (_fused_window_block_kernel): the attention
    half's residual x1 stays fp32 into LN2 and the MLP residual, where the
    split pair rounds it to x's dtype between its two kernels."""
    x1 = _window_attn_residual_plain(xw, ln1, qkv_p, tht, twt, proj_p,
                                     size_hw, num_heads, grid_hw, nwc, eps)
    return _mlp_residual_plain(x1, ln2, mlp1_p, mlp2_p, eps,
                               xw.dtype).reshape(xw.shape)


def fused_mlp_stream_plain(x, ln2, mlp1_p, mlp2_p, eps: float):
    """x + fc2(GELU(fc1(LN2(x)))) over rows [N, C] (_mlp_stream_kernel)."""
    return _mlp_residual_plain(x.float(), ln2, mlp1_p, mlp2_p, eps, x.dtype)


def fused_global_tail_plain(x, qkv, tht, twt, proj_p, ln2, mlp1_p, mlp2_p,
                            size_hw, num_heads: int, eps: float):
    """Global block after LN1 and the QKV projection: attention, proj,
    residual (x1 kept in fp32), LN2, MLP, residual (_fused_global_tail_kernel).
    Rounded to x's dtype: the attention output, LN2 output, GELU hidden and
    the result."""
    attn = fused_relpos_attention_plain(qkv, tht, twt, size_hw,
                                        num_heads).to(x.dtype)
    x1 = x.float() + (_dot(attn, proj_p["w"]) + proj_p["b"].float())
    return _mlp_residual_plain(x1, ln2, mlp1_p, mlp2_p, eps, x.dtype)


def attention_qkv_plain(qkv, num_heads: int, scale=None):
    """Bias-free attention off the fused QKV [B, L, 3C] -> [B, L, C]
    (_mha_qkv_kernel): unnormalised P rounded to v's dtype, divided by the
    row sum after the product."""
    q, k, v = _split_qkv(qkv, num_heads)
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(), v.float())
    return _merge_heads(o / p.sum(-1, keepdim=True)).to(qkv.dtype)


def _pick_bq(L: int, target: int) -> int:
    bq = min(target, L)
    while L % bq:
        bq //= 2
    return max(bq, 1)


def supported_global_fused(H: int, W: int, head_dim: int) -> bool:
    """The reference's gate for its fused global layer (anyref_tpu flash.py
    supported_global_fused with the kernels on): the shapes whose numerics
    are those of fused_global_tail there."""
    L = H * W
    return (L >= 1024 and _pick_bq(L, 256) >= 128 and H % 8 == 0
            and W % 8 == 0 and head_dim % 8 == 0)


def supported_relpos_qkv(H: int, W: int) -> bool:
    """The reference's gate for flash_relpos_attention_qkv
    (anyref_tpu image_encoder.py _attn_block with supported_relpos): grids
    of 64 <= H * W < 1024 tokens, the SAM windows (and, at anyref_tiny(),
    its 16 x 16 global layer)."""
    return 64 <= H * W < 1024


def layer_norm_rows_plain(x, scale, bias, eps: float, keep=None):
    """The fused layers' LayerNorm row pass: h = bf16(LayerNorm(x) * keep)
    over rows x [N, C] (bf16 or fp32), fp32 moments and arithmetic, keep
    [N, 1] the window pad mask or None, rounded once at the end, where the
    reference's fused kernels round h (anyref_tpu flash.py
    _fused_window_attn_kernel, _mlp_stream_kernel)."""
    h = layer_norm_plain(x.float(), scale, bias, eps)
    if keep is not None:
        h = h * keep
    return h.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# fused SAM layers: kernels
# ---------------------------------------------------------------------------
_E_BIAS, _E_GELU, _E_RES = 0, 1, 2


def _gemm_operands(name: str, a, *weights):
    """a [M, K] and weights [K, N], contiguous and 16-byte aligned, with K
    and N multiples of 8 (the GEMM's TMA loads take 16-byte row strides);
    else raise."""
    for w in weights:
        if w.dtype != torch.bfloat16 or not w.is_contiguous():
            raise TypeError(f"{name}: weights must be contiguous bfloat16")
    dims = [a.shape[1]] + [d for w in weights for d in w.shape]
    if any(d % 8 for d in dims) or not _aligned(a, *weights):
        raise ValueError(f"{name}: the GEMM takes K and N multiples of 8 "
                         f"and 16-byte aligned operands, got {tuple(a.shape)}"
                         f" x {[tuple(w.shape) for w in weights]}")


def _ln_rows(x2, ln, eps: float, win=None):
    """One launch of csrc/norms.cu's LayerNorm row pass on rows x2 [M, C]
    (bf16 or fp32, contiguous, 16-byte aligned) -> h [M, C] bf16, the
    GEMM's A; ``win`` (L, nw, nwc, ws, H, W) asks for the window pad mask.
    The weights are read as they come (bf16 or fp32), copied only where
    they are not 16-byte aligned."""
    M, C = x2.shape
    s, b = _norm_weights("LayerNorm row pass", C, x2.device, ln["scale"],
                         ln["bias"])
    if not _aligned(s, b):
        s, b = s.clone(), b.clone()
    h = torch.empty(M, C, dtype=torch.bfloat16, device=x2.device)
    _launch("anyref_layer_norm_rows", x2.data_ptr(),
            int(x2.dtype == torch.float32), s.data_ptr(), b.data_ptr(),
            int(s.dtype == torch.float32), h.data_ptr(), M, C, float(eps),
            *(win or (0,) * 6), _stream(x2))
    return h


def _gemm(a, w, bias, epi: int, res=None, out_dtype=torch.bfloat16):
    """epi(a @ w + bias) on the wgmma GEMM of csrc/gemm.cuh: a [M, K] and w
    [K, N] bf16 as _gemm_operands checks them, bias [N] read as it comes
    (bf16 or fp32), res [M, N] (bf16 or fp32) for the residual epilogue."""
    M, K = a.shape
    N = w.shape[1]
    b = bias.to(device=a.device)
    if b.dtype not in (torch.bfloat16, torch.float32):
        b = b.float()
    b = b.contiguous()
    if b.numel() != N:
        raise ValueError(f"fused SAM GEMM: bias {tuple(bias.shape)} for "
                         f"{N} columns")
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    _launch("anyref_gemm", a.data_ptr(), w.data_ptr(), b.data_ptr(),
            int(b.dtype == torch.float32),
            None if res is None else res.data_ptr(), out.data_ptr(), M, N, K,
            epi, int(res is not None and res.dtype == torch.float32),
            int(out_dtype == torch.float32), _stream(a))
    return out


def _window_args(name: str, xw, size_hw, num_heads: int):
    """(ws, NW, L, C) of window rows xw [NW, ws*ws, C] the window kernels
    take (square windows, heads of at most 128); else raise."""
    ws = size_hw[0]
    NW, L, C = xw.shape
    hd = C // num_heads
    if size_hw[1] != ws or L != ws * ws or hd * num_heads != C or hd > 128:
        raise ValueError(f"{name}: shape {tuple(xw.shape)}, window "
                         f"{size_hw}, {num_heads} heads")
    return ws, NW, L, C


def _window_attention(x2, ln1, qkv_p, tht, twt, NW: int, L: int,
                      num_heads: int, ws: int, grid_hw, nwc: int,
                      eps: float):
    """Three launches on the window rows x2 [NW * L, C]: the LayerNorm row
    pass with the pad mask, the QKV GEMM, and the rel-pos attention of
    _window_relpos on the heads of the fused QKV, read in place, with the
    gathered tables tht / twt [ws * ws, hd] viewed as [ws, ws, hd] -> attn
    [NW * L, C] bf16, written head-merged (grids of more than WINDOW_MAX_L
    tokens take _global_relpos after its factor einsums)."""
    C = x2.shape[1]
    hd = C // num_heads
    H, W = grid_hw
    h = _ln_rows(x2, ln1, eps, win=(L, -(-H // ws) * nwc, nwc, ws, H, W))
    qkv = _gemm(h, qkv_p["w"], qkv_p["b"], _E_BIAS)
    attn = torch.empty(NW * L, C, dtype=torch.bfloat16, device=x2.device)
    heads = attn.view(NW, L, num_heads, hd).transpose(1, 2)
    q, k, v = _split_qkv(qkv.view(NW, L, 3 * C), num_heads)
    th, tw = (t.reshape(ws, ws, hd) for t in (tht, twt))
    if _relpos_route(L, hd) == "window":
        _window_relpos(q, k, v, th, tw, (ws, ws), heads)
    else:
        _global_relpos(q, k, v, th, tw, (ws, ws), heads)
    return attn


def _mlp_residual(x, ln2, mlp1_p, mlp2_p, eps: float):
    """Three launches: the LayerNorm row pass of x [N, C] (bf16 or fp32)
    -> bf16 h, the fc1 GEMM with the GELU epilogue (bf16 hidden), the fc2
    GEMM with the residual x -> [N, C] bf16."""
    h = _ln_rows(x, ln2, eps)
    hid = _gemm(h, mlp1_p["w"], mlp1_p["b"], _E_GELU)
    return _gemm(hid, mlp2_p["w"], mlp2_p["b"], _E_RES, res=x)


def _qkv_dims(qkv, size_hw, num_heads: int):
    """(B, L, C, hd) of a fused QKV [B, L, 3C] over an H x W grid; else
    raise."""
    H, W = size_hw
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if H * W != L or C3 != 3 * C or hd * num_heads != C:
        raise ValueError(f"rel-pos attention off the fused QKV: qkv "
                         f"{tuple(qkv.shape)}, grid {size_hw}, {num_heads} "
                         "heads")
    return B, L, C, hd


def _relpos_qkv_attention(qkv, tht, twt, size_hw, num_heads: int):
    """The fp32 bias factors (two einsums, as the reference's wrappers
    compute them) and one launch of the global kernel on the heads of the
    fused QKV [B, L, 3C], read in place -> [B, L, C] bf16, written
    head-merged."""
    B, L, C, hd = _qkv_dims(qkv, size_hw, num_heads)
    out = torch.empty(B, L, C, dtype=torch.bfloat16, device=qkv.device)
    if out.numel():
        _global_relpos(*_split_qkv(qkv, num_heads), tht, twt, size_hw,
                       out.view(B, L, num_heads, hd).transpose(1, 2))
    return out


def fused_window_attn(xw, ln1, qkv_p, tht, twt, proj_p, size_hw,
                      num_heads: int, grid_hw, nwc: int, eps: float):
    """xw [NW, ws*ws, C] window-resident stream -> x + proj(window attention
    (qkv(LN1(x) * pad mask))), [NW, ws*ws, C]. tht/twt [ws*ws, hd]: the
    gathered rel-pos tables, rows (j, s); grid_hw the token grid before
    padding; nwc windows per row. Four launches: the LayerNorm row pass, QKV
    GEMM, window attention, proj GEMM."""
    if _on_cpu("fused_window_attn", xw, qkv_p["w"], proj_p["w"]):
        return fused_window_attn_plain(xw, ln1, qkv_p, tht, twt, proj_p,
                                       size_hw, num_heads, grid_hw, nwc, eps)
    ws, NW, L, C = _window_args("fused_window_attn", xw, size_hw, num_heads)
    x2 = xw.reshape(NW * L, C).contiguous()
    _gemm_operands("fused_window_attn", x2, qkv_p["w"], proj_p["w"])
    with torch.cuda.device(xw.device):
        attn = _window_attention(x2, ln1, qkv_p, tht, twt, NW, L, num_heads,
                                 ws, grid_hw, nwc, eps)
        out = _gemm(attn, proj_p["w"], proj_p["b"], _E_RES, res=x2)
    fused_window_attn.launches += 1
    return out.view(NW, L, C)


def fused_window_block(xw, ln1, qkv_p, tht, twt, proj_p, ln2, mlp1_p, mlp2_p,
                       size_hw, num_heads: int, grid_hw, nwc: int,
                       eps: float):
    """The whole window layer on the window-resident stream xw [NW, ws*ws,
    C] -> [NW, ws*ws, C]; arguments as fused_window_attn plus LN2 and the
    MLP. Seven launches: the four of fused_window_attn with the proj GEMM
    writing the residual x1 in fp32, then the LayerNorm row pass of fp32
    x1, the fc1 GEMM (GELU) and the fc2 GEMM (fp32 residual x1, bf16
    out)."""
    if _on_cpu("fused_window_block", xw, qkv_p["w"], proj_p["w"],
               mlp1_p["w"], mlp2_p["w"]):
        return fused_window_block_plain(xw, ln1, qkv_p, tht, twt, proj_p,
                                        ln2, mlp1_p, mlp2_p, size_hw,
                                        num_heads, grid_hw, nwc, eps)
    ws, NW, L, C = _window_args("fused_window_block", xw, size_hw,
                                num_heads)
    x2 = xw.reshape(NW * L, C).contiguous()
    _gemm_operands("fused_window_block", x2, qkv_p["w"], proj_p["w"],
                   mlp1_p["w"], mlp2_p["w"])
    with torch.cuda.device(xw.device):
        attn = _window_attention(x2, ln1, qkv_p, tht, twt, NW, L, num_heads,
                                 ws, grid_hw, nwc, eps)
        x1 = _gemm(attn, proj_p["w"], proj_p["b"], _E_RES, res=x2,
                   out_dtype=torch.float32)
        out = _mlp_residual(x1, ln2, mlp1_p, mlp2_p, eps)
    fused_window_block.launches += 1
    return out.view(NW, L, C)


def fused_mlp_stream(x, ln2, mlp1_p, mlp2_p, eps: float):
    """x [N, C] -> x + fc2(GELU(fc1(LN2(x)))). Three launches: the
    LayerNorm row pass (bf16 h), fc1 GEMM with the GELU epilogue (bf16
    hidden), fc2 GEMM with the residual epilogue."""
    if _on_cpu("fused_mlp_stream", x, mlp1_p["w"], mlp2_p["w"]):
        return fused_mlp_stream_plain(x, ln2, mlp1_p, mlp2_p, eps)
    xc = x.contiguous()
    _gemm_operands("fused_mlp_stream", xc, mlp1_p["w"], mlp2_p["w"])
    with torch.cuda.device(x.device):
        out = _mlp_residual(xc, ln2, mlp1_p, mlp2_p, eps)
    fused_mlp_stream.launches += 1
    return out


def fused_global_tail(x, qkv, tht, twt, proj_p, ln2, mlp1_p, mlp2_p,
                      size_hw, num_heads: int, eps: float):
    """Global block after LN1 and the QKV projection. x [B, L, C] the block
    input, qkv [B, L, 3C], tht/twt [S, S, hd] gathered tables -> [B, L, C].
    The fp32 bias factors are two einsums here, as in the reference's
    wrapper; then five launches: attention off the fused QKV, proj GEMM
    into fp32 x1, the LayerNorm row pass of x1, fc1 GEMM (GELU), fc2 GEMM
    (fp32 residual)."""
    if _on_cpu("fused_global_tail", x, qkv, proj_p["w"], mlp1_p["w"],
               mlp2_p["w"]):
        return fused_global_tail_plain(x, qkv, tht, twt, proj_p, ln2, mlp1_p,
                                       mlp2_p, size_hw, num_heads, eps)
    B, L, C = x.shape
    if qkv.shape != (B, L, 3 * C):
        raise ValueError(f"fused_global_tail: x {tuple(x.shape)}, qkv "
                         f"{tuple(qkv.shape)}")
    x2 = x.reshape(B * L, C).contiguous()
    _gemm_operands("fused_global_tail", x2, proj_p["w"], mlp1_p["w"],
                   mlp2_p["w"])
    with torch.cuda.device(x.device):
        attn = _relpos_qkv_attention(qkv.contiguous(), tht, twt, size_hw,
                                     num_heads)
        x1 = _gemm(attn.view(B * L, C), proj_p["w"], proj_p["b"], _E_RES,
                   res=x2, out_dtype=torch.float32)
        out = _mlp_residual(x1, ln2, mlp1_p, mlp2_p, eps)
    fused_global_tail.launches += 1
    return out.view(B, L, C)


def flash_relpos_attention_qkv(qkv, rel_h_table, rel_w_table, size_hw,
                               num_heads: int):
    """SAM window rel-pos attention read off the fused QKV [B, L, 3C]
    (heads not split), rel_*_table [S, S, hd] -> [B, L, C] with heads
    merged. One launch: the window kernel up to WINDOW_MAX_L tokens (the
    bias factors computed in it), else the global kernel after the fp32
    factor einsums, as the reference's wrapper computes them."""
    if _on_cpu("flash_relpos_attention_qkv", qkv):
        return relpos_attention_qkv_plain(qkv, rel_h_table, rel_w_table,
                                          size_hw, num_heads)
    B, L, C, hd = _qkv_dims(qkv, size_hw, num_heads)
    qc = qkv.contiguous()
    with torch.cuda.device(qkv.device):
        if _relpos_route(L, hd) == "window":
            out = torch.empty(B, L, C, dtype=torch.bfloat16,
                              device=qkv.device)
            if out.numel():
                _window_relpos(*_split_qkv(qc, num_heads), rel_h_table,
                               rel_w_table, size_hw,
                               out.view(B, L, num_heads, hd).transpose(1, 2))
        else:
            out = _relpos_qkv_attention(qc, rel_h_table, rel_w_table,
                                        size_hw, num_heads)
    flash_relpos_attention_qkv.launches += 1
    return out


def flash_attention_qkv(qkv, num_heads: int, scale=None):
    """Self-attention off the fused QKV [B, L, 3C] (heads not split) ->
    [B, L, C] with heads merged; scale defaults to head_dim ** -0.5. One
    launch of csrc/relpos_global.cu without the bias, the thirds of qkv
    read in place and the output written head-merged (heads whose width is
    not a multiple of 8 copied and zero-padded first, _tma_heads)."""
    if _on_cpu("flash_attention_qkv", qkv):
        return attention_qkv_plain(qkv, num_heads, scale)
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if C3 != 3 * C or hd * num_heads != C or not 0 < hd <= 128:
        raise ValueError(f"flash_attention_qkv: qkv {tuple(qkv.shape)}, "
                         f"{num_heads} heads (heads of at most 128)")
    out = torch.empty(B, L, C, dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    heads = out.view(B, L, num_heads, hd).transpose(1, 2)
    q, k, v, strides, o = _tma_heads(*_split_qkv(qkv, num_heads), heads)
    with torch.cuda.device(qkv.device):
        _launch("anyref_attention_heads", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), *strides, o.data_ptr(), *o.stride()[:3], B,
                num_heads, L, q.shape[-1],
                hd ** -0.5 if scale is None else float(scale), _stream(qkv))
    if o is not heads:
        heads.copy_(o[..., :hd])
    flash_attention_qkv.launches += 1
    return out


# ---------------------------------------------------------------------------
# weight-only int8 matmul (ops/quant.py builds on it)
# ---------------------------------------------------------------------------
def int8_matmul_plain(x, w_q, scale):
    """x [..., K] @ w_q [K, N] int8 in fp32, times scale [N], rounded to x's
    dtype (the reference's int8_matmul_xla)."""
    y = torch.matmul(x.float(), w_q.float())
    return (y * scale.float()).to(x.dtype)


# csrc/int8_matmul.cu's M <= 16 body: rows of x it takes (DT_MAX_M),
# columns of W a block (DT_TN), K rows a stage (DT_BK), ring stages
# (DT_STAGES), largest K split, the cluster size (DT_MAX_SPLITS)
_I8_DECODE_ROWS, _I8_TN, _I8_BK, _I8_STAGES, _I8_MAX_SPLITS = 16, 128, 64, 4, 8


class Int8DecodePlan(NamedTuple):
    """Launch plan of int8_matmul's M <= 16 body: a grid of ``splits`` x
    ceil(N / tn) blocks, clusters of ``splits`` along K; block (r, i) sums
    the columns [tn i, tn (i + 1)) over its stages of ``bk`` rows [r KT /
    S, (r + 1) KT / S), KT = ceil(K / bk), S = splits. ``smem``: its
    dynamic shared memory in bytes (the ring of W and x boxes, which then
    holds the partial sums, its barriers and the tile's column scales)."""
    tn: int
    splits: int
    bk: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def _int8_decode_plan(M: int, N: int, K: int, num_sms: int) -> Int8DecodePlan:
    """The fewest K splits (at most 8, and at most one a stage) that give
    every SM a block: on 132 SMs the column tiles alone fill the card at
    lm_head's width (251 tiles), 4096-wide outputs take 5 splits (160
    blocks) and 11008-wide ones 2 (172). On the H100 this measured within
    a few percent of the best split at each 7B shape (PERF.md §6); at
    least two blocks fit an SM, so the grid is one wave."""
    tiles = -(-N // _I8_TN)
    kt = -(-K // _I8_BK)
    splits = min(_I8_MAX_SPLITS, kt, -(-num_sms // tiles))
    x_box = 8 * (1 if M <= 8 else 2) * _I8_BK * 2
    smem = (_I8_STAGES * (_I8_BK * _I8_TN + x_box) + 2 * _I8_STAGES * 8
            + _I8_TN * 4 + 1024)
    return Int8DecodePlan(_I8_TN, splits, _I8_BK, tiles * splits, smem)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_matmul(x, w_q, scale):
    """x [..., K] bf16, w_q [K, N] int8, scale [N] fp32 -> [..., N] in x's
    dtype: the fp32 sum of x times the exact bf16 weights, scaled per
    column once, then rounded. One launch at every M: up to 16 rows of x,
    a split-K streaming kernel whose blocks sum their partials through
    distributed shared memory (``_int8_decode_plan``); more rows, a
    warp-specialised wgmma GEMM fed by TMA."""
    dev = x.device
    if w_q.device != dev or scale.device != dev:
        raise ValueError("int8_matmul: inputs on different devices")
    if dev.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {dev}")
    if (x.dtype, w_q.dtype, scale.dtype) != (torch.bfloat16, torch.int8,
                                            torch.float32):
        raise TypeError(f"int8_matmul: the CUDA kernel takes bf16 x, int8 "
                        f"w_q and fp32 scale, got {x.dtype}, {w_q.dtype}, "
                        f"{scale.dtype}")
    K, N = w_q.shape
    x2 = x.reshape(-1, K).contiguous()
    sc = scale.contiguous()
    if (x.shape[-1] != K or tuple(sc.shape) != (N,) or K % 8 or N % 8
            or not w_q.is_contiguous() or not _aligned(x2, w_q)):
        raise ValueError(f"int8_matmul: the kernel takes K and N multiples "
                         f"of 8, contiguous 16-byte aligned x and w_q and "
                         f"scale [N], got {tuple(x.shape)} x "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    M = x2.shape[0]
    out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    if M:
        plan = (_int8_decode_plan(M, N, K, _num_sms(dev.index))
                if M <= _I8_DECODE_ROWS else Int8DecodePlan(0, 0, 0, 0, 0))
        with torch.cuda.device(dev):
            _launch("anyref_int8_matmul", x2.data_ptr(), w_q.data_ptr(),
                    sc.data_ptr(), out.data_ptr(), M, N, K, plan.tn,
                    plan.splits, plan.bk, _stream(x))
        int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


fused_window_attn.launches = 0
fused_window_block.launches = 0
fused_mlp_stream.launches = 0
fused_global_tail.launches = 0
flash_relpos_attention_qkv.launches = 0
flash_attention_qkv.launches = 0
int8_matmul.launches = 0

KERNELS = (layer_norm_fused, rms_norm_fused, flash_relpos_attention,
           flash_causal_attention, fused_window_attn, fused_mlp_stream,
           fused_global_tail, flash_attention_qkv,
           flash_causal_attention_diff, flash_relpos_attention_qkv,
           fused_window_block, int8_matmul)
