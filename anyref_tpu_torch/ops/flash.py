"""Hand-written CUDA kernels of the port, their plain PyTorch versions, their
launch counters and their build.

Four kernels, each the Hopper counterpart of a Pallas kernel of
``anyref_tpu/ops/flash.py`` (the sources under ``anyref_tpu_torch/csrc/``
say which, what bounds each on the H100 and how its design answers that):

* ``layer_norm_fused``        <- ``layer_norm_fused`` / ``_ln_kernel``
* ``rms_norm_fused``          <- ``rms_norm_fused`` / ``_rms_kernel``
* ``flash_relpos_attention``  <- ``flash_relpos_attention`` (window and
  global kernels)
* ``flash_causal_attention``  <- ``flash_causal_attention`` (multi-head and
  per-head kernels)

Each wrapper runs its plain version when, and only when, its input lies on
the CPU (the tests). For a CUDA tensor it launches the kernel or raises:
there is no fallback. Each wrapper carries ``.launches``, a plain int it
raises by one per kernel launch, so a run can show which kernels its path
went through.

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
SOURCES = ("norms.cu", "relpos_attention.cu", "causal_attention.cu")
HEADERS = ("common.cuh", "attention.cuh")
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
                                            F, I, P],
                "anyref_causal_attention": [P, P, P, P, P, I, I, I, I, F, I,
                                            P],
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


def relpos_attention_plain(q, k, v, rel_h_table, rel_w_table, size_hw):
    """softmax(q k^T * scale + rh[q, k // W] + rw[q, k % W]) v with fp32
    scores, p rounded to v's dtype for the product (_relpos_kernel)."""
    H, W = size_hw
    B, nh, L, hd = q.shape
    rh, rw = relpos_factors(q, rel_h_table, rel_w_table, size_hw)
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * hd ** -0.5
    s = (s.view(B, nh, L, H, W) + rh[..., :, None]
         + rw[..., None, :]).view(B, nh, L, L)
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
                B * nh, L, hd, H, W, hd ** -0.5, vec, _stream(q))
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

KERNELS = (layer_norm_fused, rms_norm_fused, flash_relpos_attention,
           flash_causal_attention)
