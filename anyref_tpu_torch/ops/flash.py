"""Hand-written CUDA kernels of the port, their plain PyTorch versions, their
launch counters and their build.

Eight kernels, each the Hopper counterpart of a Pallas kernel of
``anyref_tpu/ops/flash.py`` (the sources under ``anyref_tpu_torch/csrc/``
say which, what bounds each on the H100 and how its design answers that):

* ``layer_norm_fused``        <- ``layer_norm_fused`` / ``_ln_kernel``
* ``rms_norm_fused``          <- ``rms_norm_fused`` / ``_rms_kernel``
* ``flash_relpos_attention``  <- ``flash_relpos_attention`` (window and
  global kernels)
* ``flash_causal_attention``  <- ``flash_causal_attention`` (multi-head and
  per-head kernels)
* ``fused_window_attn``       <- ``fused_window_attn``
* ``fused_mlp_stream``        <- ``fused_mlp_stream``
* ``fused_global_tail``       <- ``fused_global_tail``
* ``flash_attention_qkv``     <- ``flash_attention_qkv`` / ``_mha_qkv_kernel``

The first four and ``flash_attention_qkv`` are one CUDA kernel each. The
three fused layers are each a short chain of the port's own kernels (row
moments, the GEMM of ``csrc/gemm.cuh`` with a LayerNorm prologue and a
bias / GELU / residual epilogue, QKV-direct attention), with no other torch
op between them than allocation, views and, in the global tail, the fp32
bias-factor einsums the reference's wrapper also computes outside its
kernel.

Each wrapper runs its plain version when, and only when, its input lies on
the CPU (the tests). For a CUDA tensor it launches its kernels or raises:
there is no fallback. Each wrapper carries ``.launches``, a plain int it
raises by one per call that launched its kernel (or chain), so a run can
show which kernels its path went through.

Build: at first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``
(one process per source, all started together) and links them into one
shared library under ``anyref_tpu_torch/build/``, named after a hash of the
sources; the library is loaded with ``ctypes`` and each C entry returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("norms.cu", "relpos_attention.cu", "causal_attention.cu",
           "fused_layers.cu", "qkv_attention.cu")
HEADERS = ("common.cuh", "attention.cuh", "gemm.cuh")
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
                "anyref_layer_norm": [P, P, P, P, I, I, F, I, P],
                "anyref_rms_norm": [P, P, P, I, I, F, I, P],
                "anyref_relpos_attention": [P, P, P, P, P, P, I, I, I, I, I,
                                            I, F, I, P],
                "anyref_causal_attention": [P, P, P, P, P, I, I, I, I, F, I,
                                            P],
                "anyref_row_stats": [P, P, I, I, F, I, P],
                "anyref_gemm": [P, P, P, P, P, I, I, I, P, P, P, I, I, I, I,
                                I, I, I, I, I, I, P],
                "anyref_window_attention_qkv": [P, P, P, P, I, I, I, I, I, F,
                                                I, P],
                "anyref_relpos_attention_qkv": [P, P, P, P, I, I, I, I, I, I,
                                                F, I, P],
                "anyref_mha_qkv": [P, P, I, I, I, I, F, I, P],
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


def _norm(entry: str, wrapper, x, params, eps: float):
    C = x.shape[-1]
    xc = x.contiguous()
    N = xc.numel() // max(C, 1)
    y = torch.empty_like(xc)
    if N == 0:
        return y
    ps = [p.to(device=x.device, dtype=torch.float32).contiguous()
          for p in params]
    vec = int(C % 8 == 0 and _aligned(xc, y, *ps))
    with torch.cuda.device(x.device):
        _launch(entry, xc.data_ptr(), *(p.data_ptr() for p in ps),
                y.data_ptr(), N, C, float(eps), vec, _stream(x))
    wrapper.launches += 1
    return y


def layer_norm_fused(x, scale, bias, eps: float):
    """x [..., C], scale/bias [C] -> LayerNorm(x), same dtype as x."""
    if _on_cpu("layer_norm_fused", x):
        return layer_norm_plain(x, scale, bias, eps)
    return _norm("anyref_layer_norm", layer_norm_fused, x, (scale, bias), eps)


def rms_norm_fused(x, scale, eps: float):
    """x [..., C], scale [C] -> RMSNorm(x), same dtype as x."""
    if _on_cpu("rms_norm_fused", x):
        return rms_norm_plain(x, scale, eps)
    return _norm("anyref_rms_norm", rms_norm_fused, x, (scale,), eps)


layer_norm_fused.launches = 0
rms_norm_fused.launches = 0


# ---------------------------------------------------------------------------
# SAM attention with decomposed rel-pos bias
# ---------------------------------------------------------------------------
def relpos_factors(q, rel_h_table, rel_w_table, size_hw):
    """The q-dependent bias factors rh = q . Rh [B, nh, L, H] and
    rw = q . Rw [B, nh, L, W] in fp32 (anyref_tpu flash.py:203-207): two
    small products kept outside the kernel, as the reference keeps them."""
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


def flash_relpos_attention(q, k, v, rel_h_table, rel_w_table, size_hw):
    """q/k/v [B, nh, L, hd]; rel_*_table [S, S, hd] -> [B, nh, L, hd]."""
    if _on_cpu("flash_relpos_attention", q, k, v):
        return relpos_attention_plain(q, k, v, rel_h_table, rel_w_table,
                                      size_hw)
    H, W = size_hw
    B, nh, L, hd = q.shape
    if H * W != L or k.shape != q.shape or v.shape != q.shape or hd > 128:
        raise ValueError(f"flash_relpos_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {size_hw}")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    rh, rw = (t.contiguous() for t in
              relpos_factors(qc, rel_h_table, rel_w_table, size_hw))
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    vec = int(hd % 8 == 0 and _aligned(qc, kc, vc))
    with torch.cuda.device(q.device):
        _launch("anyref_relpos_attention", qc.data_ptr(), kc.data_ptr(),
                vc.data_ptr(), rh.data_ptr(), rw.data_ptr(), out.data_ptr(),
                B, nh, L, hd, H, W, hd ** -0.5, vec, _stream(q))
    flash_relpos_attention.launches += 1
    return out


flash_relpos_attention.launches = 0


# ---------------------------------------------------------------------------
# causal prefill attention with a left-pad mask
# ---------------------------------------------------------------------------
def causal_attention_plain(q, k, v, kv_start=None):
    """Causal attention over [B, nh, L, hd] where row b drops keys before
    kv_start[b]. Dropped logits are float32.min and the denominator is
    clamped at 1e-20, so a fully masked row is the mean of V over all L keys
    (_causal_mh_kernel)."""
    B, nh, L, hd = q.shape
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * hd ** -0.5
    pos = torch.arange(L, device=q.device)
    keep = (pos[None, :] <= pos[:, None])[None]                  # [1, L, L]
    if kv_start is not None:
        keep = keep & (pos[None, None, :]
                       >= kv_start.to(q.device)[:, None, None])
    s = torch.where(keep[:, None], s, torch.finfo(torch.float32).min)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-20)).to(q.dtype)


def flash_causal_attention(q, k, v, kv_start=None):
    """q/k/v [B, nh, L, hd] prefill attention; kv_start [B] int or None."""
    if _on_cpu("flash_causal_attention", q, k, v):
        return causal_attention_plain(q, k, v, kv_start)
    B, nh, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or hd > 128:
        raise ValueError(f"flash_causal_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    ks = (torch.zeros(B, dtype=torch.int32, device=q.device)
          if kv_start is None else
          kv_start.to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    vec = int(hd % 8 == 0 and _aligned(qc, kc, vc))
    with torch.cuda.device(q.device):
        _launch("anyref_causal_attention", qc.data_ptr(), kc.data_ptr(),
                vc.data_ptr(), ks.data_ptr(), out.data_ptr(), B, nh, L, hd,
                hd ** -0.5, vec, _stream(q))
    flash_causal_attention.launches += 1
    return out


flash_causal_attention.launches = 0


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


def relpos_attention_qkv_plain(qkv, rel_h_table, rel_w_table, size_hw,
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


def fused_window_attn_plain(xw, ln1, qkv_p, tht, twt, proj_p, size_hw,
                            num_heads: int, grid_hw, nwc: int, eps: float):
    """x + proj(attention(qkv(LN1(x) * pad_mask))) over windows [NW, L, C]
    (_fused_window_attn_kernel): h, qkv and the attention output rounded
    to x's dtype, the residual sum in fp32."""
    ws = size_hw[0]
    NW, L, _ = xw.shape
    nw = -(-grid_hw[0] // ws) * nwc
    x = xw.float()
    mask = window_pad_mask(NW, L, ws, nwc, nw, grid_hw, xw.device)
    h = layer_norm_plain(x, ln1["scale"], ln1["bias"], eps) * mask
    h = h.to(xw.dtype)
    qkv = (_dot(h, qkv_p["w"]) + qkv_p["b"].float()).to(xw.dtype)
    attn = relpos_attention_qkv_plain(qkv, tht.reshape(ws, ws, -1),
                                      twt.reshape(ws, ws, -1), size_hw,
                                      num_heads)
    proj = _dot(attn, proj_p["w"]) + proj_p["b"].float()
    return (x + proj).to(xw.dtype)


def fused_mlp_stream_plain(x, ln2, mlp1_p, mlp2_p, eps: float):
    """x + fc2(GELU(fc1(LN2(x)))) over rows [N, C] (_mlp_stream_kernel):
    LN output and GELU hidden rounded to x's dtype."""
    xf = x.float()
    h = layer_norm_plain(xf, ln2["scale"], ln2["bias"], eps).to(x.dtype)
    m1 = gelu_exact_plain(_dot(h, mlp1_p["w"])
                          + mlp1_p["b"].float()).to(x.dtype)
    acc = mlp2_p["b"].float() + _dot(m1, mlp2_p["w"])
    return (xf + acc).to(x.dtype)


def fused_global_tail_plain(x, qkv, tht, twt, proj_p, ln2, mlp1_p, mlp2_p,
                            size_hw, num_heads: int, eps: float):
    """Global block after LN1 and the QKV projection: attention, proj,
    residual (x1 kept in fp32), LN2, MLP, residual (_fused_global_tail_kernel).
    Rounded to x's dtype: the attention output, LN2 output, GELU hidden and
    the result."""
    attn = relpos_attention_qkv_plain(qkv, tht, twt, size_hw,
                                      num_heads).to(x.dtype)
    x1 = x.float() + (_dot(attn, proj_p["w"]) + proj_p["b"].float())
    h2 = layer_norm_plain(x1, ln2["scale"], ln2["bias"], eps).to(x.dtype)
    m1 = gelu_exact_plain(_dot(h2, mlp1_p["w"])
                          + mlp1_p["b"].float()).to(x.dtype)
    m2 = mlp2_p["b"].float() + _dot(m1, mlp2_p["w"])
    return (x1 + m2).to(x.dtype)


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


# ---------------------------------------------------------------------------
# fused SAM layers and QKV-direct attention: kernels
# ---------------------------------------------------------------------------
_A_BF16, _A_LN_BF16, _A_LN_F32 = 0, 1, 2
_E_BIAS, _E_GELU, _E_RES = 0, 1, 2


def _f32(t, device):
    return t.to(device=device, dtype=torch.float32).contiguous()


def _gemm_operands(name: str, a, *weights):
    """a [M, K] and weights [K, N], contiguous and 16-byte aligned, with K
    and N multiples of 8 (the GEMM's 16-byte copies); else raise."""
    for w in weights:
        if w.dtype != torch.bfloat16 or not w.is_contiguous():
            raise TypeError(f"{name}: weights must be contiguous bfloat16")
    dims = [a.shape[1]] + [d for w in weights for d in w.shape]
    if any(d % 8 for d in dims) or not _aligned(a, *weights):
        raise ValueError(f"{name}: the GEMM takes K and N multiples of 8 "
                         f"and 16-byte aligned operands, got {tuple(a.shape)}"
                         f" x {[tuple(w.shape) for w in weights]}")


def _row_stats(x2, eps: float):
    M, K = x2.shape
    stats = torch.empty(M, 2, dtype=torch.float32, device=x2.device)
    _launch("anyref_row_stats", x2.data_ptr(), stats.data_ptr(), M, K,
            float(eps), int(x2.dtype == torch.float32), _stream(x2))
    return stats


def _gemm(a, w, bias, epi: int, ln=None, stats=None, res=None, win=None,
          out_dtype=torch.bfloat16):
    """epi(prologue(a) @ w + bias) on the GEMM of csrc/gemm.cuh. ``ln``
    (fp32 scale, bias) with ``stats`` asks for the LayerNorm prologue, ``win``
    (L, nw, nwc, ws, H, W) for its window pad mask."""
    M, K = a.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    amode = _A_BF16 if ln is None else (
        _A_LN_F32 if a.dtype == torch.float32 else _A_LN_BF16)
    _launch("anyref_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(), M, N, K,
            None if stats is None else stats.data_ptr(),
            None if ln is None else ln[0].data_ptr(),
            None if ln is None else ln[1].data_ptr(),
            *(win or (0,) * 6), amode, epi,
            int(res is not None and res.dtype == torch.float32),
            int(out_dtype == torch.float32), _stream(a))
    return out


def fused_window_attn(xw, ln1, qkv_p, tht, twt, proj_p, size_hw,
                      num_heads: int, grid_hw, nwc: int, eps: float):
    """xw [NW, ws*ws, C] window-resident stream -> x + proj(window attention
    (qkv(LN1(x) * pad mask))), [NW, ws*ws, C]. tht/twt [ws*ws, hd]: the
    gathered rel-pos tables, rows (j, s); grid_hw the token grid before
    padding; nwc windows per row. Four launches: row moments, QKV GEMM,
    window attention, proj GEMM."""
    if _on_cpu("fused_window_attn", xw, qkv_p["w"], proj_p["w"]):
        return fused_window_attn_plain(xw, ln1, qkv_p, tht, twt, proj_p,
                                       size_hw, num_heads, grid_hw, nwc, eps)
    ws = size_hw[0]
    NW, L, C = xw.shape
    hd = C // num_heads
    if size_hw[1] != ws or L != ws * ws or hd * num_heads != C or hd > 128:
        raise ValueError(f"fused_window_attn: shape {tuple(xw.shape)}, "
                         f"window {size_hw}, {num_heads} heads")
    H, W = grid_hw
    dev = xw.device
    x2 = xw.reshape(NW * L, C).contiguous()
    wqkv, wproj = qkv_p["w"], proj_p["w"]
    _gemm_operands("fused_window_attn", x2, wqkv, wproj)
    ln = (_f32(ln1["scale"], dev), _f32(ln1["bias"], dev))
    bqkv, bproj = _f32(qkv_p["b"], dev), _f32(proj_p["b"], dev)
    th, tw = (t.to(torch.bfloat16).contiguous() for t in (tht, twt))
    attn = torch.empty(NW * L, C, dtype=torch.bfloat16, device=dev)
    win = (L, -(-H // ws) * nwc, nwc, ws, H, W)
    with torch.cuda.device(dev):
        stats = _row_stats(x2, eps)
        qkv = _gemm(x2, wqkv, bqkv, _E_BIAS, ln=ln, stats=stats, win=win)
        _launch("anyref_window_attention_qkv", qkv.data_ptr(), th.data_ptr(),
                tw.data_ptr(), attn.data_ptr(), NW, L, num_heads, hd, ws,
                hd ** -0.5, int(hd % 8 == 0 and _aligned(th, tw)),
                _stream(xw))
        out = _gemm(attn, wproj, bproj, _E_RES, res=x2)
    fused_window_attn.launches += 1
    return out.view(NW, L, C)


def fused_mlp_stream(x, ln2, mlp1_p, mlp2_p, eps: float):
    """x [N, C] -> x + fc2(GELU(fc1(LN2(x)))). Three launches: row moments,
    fc1 GEMM with the LayerNorm prologue and GELU epilogue (bf16 hidden),
    fc2 GEMM with the residual epilogue."""
    if _on_cpu("fused_mlp_stream", x, mlp1_p["w"], mlp2_p["w"]):
        return fused_mlp_stream_plain(x, ln2, mlp1_p, mlp2_p, eps)
    dev = x.device
    xc = x.contiguous()
    w1, w2 = mlp1_p["w"], mlp2_p["w"]
    _gemm_operands("fused_mlp_stream", xc, w1, w2)
    ln = (_f32(ln2["scale"], dev), _f32(ln2["bias"], dev))
    b1, b2 = _f32(mlp1_p["b"], dev), _f32(mlp2_p["b"], dev)
    with torch.cuda.device(dev):
        stats = _row_stats(xc, eps)
        hid = _gemm(xc, w1, b1, _E_GELU, ln=ln, stats=stats)
        out = _gemm(hid, w2, b2, _E_RES, res=xc)
    fused_mlp_stream.launches += 1
    return out


def fused_global_tail(x, qkv, tht, twt, proj_p, ln2, mlp1_p, mlp2_p,
                      size_hw, num_heads: int, eps: float):
    """Global block after LN1 and the QKV projection. x [B, L, C] the block
    input, qkv [B, L, 3C], tht/twt [S, S, hd] gathered tables -> [B, L, C].
    The fp32 bias factors are two einsums here, as in the reference's
    wrapper; then five launches: attention off the fused QKV, proj GEMM
    into fp32 x1, row moments of x1, fc1 GEMM (LayerNorm prologue on fp32,
    GELU), fc2 GEMM (fp32 residual)."""
    if _on_cpu("fused_global_tail", x, qkv, proj_p["w"], mlp1_p["w"],
               mlp2_p["w"]):
        return fused_global_tail_plain(x, qkv, tht, twt, proj_p, ln2, mlp1_p,
                                       mlp2_p, size_hw, num_heads, eps)
    H, W = size_hw
    B, L, C = x.shape
    hd = C // num_heads
    if (H * W != L or qkv.shape != (B, L, 3 * C) or hd * num_heads != C
            or hd > 128):
        raise ValueError(f"fused_global_tail: x {tuple(x.shape)}, qkv "
                         f"{tuple(qkv.shape)}, grid {size_hw}, {num_heads} "
                         "heads")
    dev = x.device
    x2 = x.reshape(B * L, C).contiguous()
    qkvc = qkv.contiguous()
    wproj, w1, w2 = proj_p["w"], mlp1_p["w"], mlp2_p["w"]
    _gemm_operands("fused_global_tail", x2, wproj, w1, w2)
    ln = (_f32(ln2["scale"], dev), _f32(ln2["bias"], dev))
    bproj, b1, b2 = (_f32(p["b"], dev) for p in (proj_p, mlp1_p, mlp2_p))
    q = _split_qkv(qkvc, num_heads)[0]
    rh, rw = (t.contiguous() for t in relpos_factors(q, tht, twt, size_hw))
    attn = torch.empty(B * L, C, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        _launch("anyref_relpos_attention_qkv", qkvc.data_ptr(), rh.data_ptr(),
                rw.data_ptr(), attn.data_ptr(), B, L, num_heads, hd, H, W,
                hd ** -0.5, int(hd % 8 == 0 and _aligned(qkvc)), _stream(x))
        x1 = _gemm(attn, wproj, bproj, _E_RES, res=x2,
                   out_dtype=torch.float32)
        stats = _row_stats(x1, eps)
        hid = _gemm(x1, w1, b1, _E_GELU, ln=ln, stats=stats)
        out = _gemm(hid, w2, b2, _E_RES, res=x1)
    fused_global_tail.launches += 1
    return out.view(B, L, C)


def flash_attention_qkv(qkv, num_heads: int, scale=None):
    """Self-attention off the fused QKV [B, L, 3C] (heads not split) ->
    [B, L, C] with heads merged; scale defaults to head_dim ** -0.5."""
    if _on_cpu("flash_attention_qkv", qkv):
        return attention_qkv_plain(qkv, num_heads, scale)
    B, L, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if C3 != 3 * C or hd * num_heads != C or hd > 128:
        raise ValueError(f"flash_attention_qkv: qkv {tuple(qkv.shape)}, "
                         f"{num_heads} heads")
    qc = qkv.contiguous()
    out = torch.empty(B, L, C, dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        _launch("anyref_mha_qkv", qc.data_ptr(), out.data_ptr(), B, L,
                num_heads, hd, hd ** -0.5 if scale is None else float(scale),
                int(hd % 8 == 0 and _aligned(qc)), _stream(qkv))
    flash_attention_qkv.launches += 1
    return out


fused_window_attn.launches = 0
fused_mlp_stream.launches = 0
fused_global_tail.launches = 0
flash_attention_qkv.launches = 0

KERNELS = (layer_norm_fused, rms_norm_fused, flash_relpos_attention,
           flash_causal_attention, fused_window_attn, fused_mlp_stream,
           fused_global_tail, flash_attention_qkv)
