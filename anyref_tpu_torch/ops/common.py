"""Shared functional NN primitives (port of anyref_tpu/ops/common.py).

Parameter convention: nested dicts of tensors, keys as in the JAX tree.
  linear: {"w": [in, out], "b": [out]?} or, int8 (ops/quant.py),
          {"w_q": int8 [in, out], "scale": fp32 [out]}
  layer_norm: {"scale": [d], "bias": [d]}
  conv: {"w": [out, in, kh, kw], "b": [out]?}   (OIHW)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash
from .quant import quant_linear


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b) in x's dtype: the weight is rounded
    to x's dtype and the product accumulates in fp32, as the reference's
    einsum with preferred_element_type=x.dtype does. An int8 leaf goes
    through quant_linear (the int8_matmul kernel)."""
    if "w_q" in p:
        return quant_linear(p, x)
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6,
               fused: bool = False) -> torch.Tensor:
    """LayerNorm over the last dim, moments in fp32. ``fused`` runs the CUDA
    kernel (ops/flash.py layer_norm_fused) at the call sites where the
    reference runs its Pallas kernel."""
    fn = flash.layer_norm_fused if fused else flash.layer_norm_plain
    return fn(x, p["scale"], p["bias"], eps)


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6,
             fused: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim, mean square in fp32; ``fused`` as in
    layer_norm."""
    if fused:
        return flash.rms_norm_fused(x, p["scale"], eps)
    return flash.rms_norm_plain(x, p["scale"], eps)


def layer_norm_2d(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channel-wise LayerNorm for NCHW tensors."""
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    var = (xf - mean).square().mean(1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * p["scale"].float()[:, None, None]
         + p["bias"].float()[:, None, None])
    return y.to(x.dtype)


def conv2d(p, x: torch.Tensor, stride=(1, 1), padding=0) -> torch.Tensor:
    """NCHW conv with OIHW weights."""
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.conv2d(x, p["w"].to(x.dtype), b, stride=stride, padding=padding)


def conv2d_transpose(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride as a matmul plus
    depth-to-space; weight layout [in, out, k, k]."""
    w = p["w"].to(x.dtype)
    cin, cout, k, _ = w.shape
    b, c, h, wd = x.shape
    y = torch.einsum("bchw,cokl->bhwokl", x, w)
    y = y.permute(0, 3, 1, 4, 2, 5).reshape(b, cout, h * k, wd * k)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None, None]
    return y


def mha(q, k, v) -> torch.Tensor:
    """Plain multi-head attention over [..., heads, len, head_dim], scale
    head_dim^-0.5; softmax in fp32, p rounded to v's dtype for the
    product."""
    logits = torch.einsum("...qd,...kd->...qk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", probs.float(),
                        v.float()).to(v.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid spelled 1 / (1 + exp(-x)) op by op,
    so a bf16 input rounds after each step exactly where the reference's
    XLA lowering of jax.nn.silu rounds."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)
