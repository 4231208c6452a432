"""Weight-only int8 quantization of the LLaMA decoder (port of
anyref_tpu/ops/quant.py).

``quantize_llama`` turns every decoder matrix and ``lm_head`` into
``{"w_q": int8 [in, out], "scale": fp32 [out]}`` (symmetric, per output
column); ``ops.common.linear`` sends such a leaf through ``quant_linear``,
and ``llama.logits`` reads ``lm_head_q``. The product is the CUDA kernel
``int8_matmul`` (ops/flash.py, csrc/int8_matmul.cu): on the H100, a decode
step at batch 2 is bound by the weight bytes, which int8 halves (about
6.6 GB against 13 GB of bf16 at 7B).

Serving on an int8 tree is greedy (``Predictor`` / ``Server`` with
``speculative=False``): the reference's speculative ``Predictor`` converts
the decoder to its bf16 serving layout, which an int8 tree lacks. A tree
already in that layout (``models/llama.py`` ``transpose_for_serving``,
``fuse_for_serving``) is refused, as the reference's quantize_llama, which
reads ``"w"``, refuses it with a KeyError.
"""

from __future__ import annotations

import torch

from .flash import int8_matmul, int8_matmul_plain

__all__ = ["int8_matmul", "int8_matmul_plain", "is_quantized",
           "quant_linear", "quantize_int8", "quantize_llama"]

_MATRICES = {"attn": ("q", "k", "v", "o"), "mlp": ("gate", "up", "down")}


def plain_layout(layers, matrices: dict, what: str) -> None:
    """Raise a ValueError naming the serving layout unless every matrix
    ``matrices`` names ({part: names}) of every layer is an [in, out]
    ``"w"`` leaf."""
    for layer in layers:
        for part, names in matrices.items():
            if any("w" not in layer[part].get(n, {}) for n in names):
                raise ValueError(
                    f"{what} takes the decoder's [in, out] layout ({{'w': "
                    "...}} leaves); this tree is in the serving layout of "
                    "llama.transpose_for_serving / fuse_for_serving, into "
                    "which a speculative Predictor converts its tree")


def quantize_int8(w) -> dict:
    """[in, out] float -> {"w_q": int8 [in, out], "scale": fp32 [out]}:
    scale = max(amax over the input axis, 1e-8) / 127 in fp32, w / scale
    rounded half to even and clipped to +-127, as the reference."""
    wf = w.float()
    scale = wf.abs().amax(0).clamp_min(1e-8) / 127.0
    w_q = torch.round(wf / scale[None, :]).clamp_(-127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale}


def quant_linear(p: dict, x):
    """ops.common.linear for {"w_q", "scale"(, "b")} leaves: the int8
    product rounded to x's dtype, then the bias added in that dtype."""
    y = int8_matmul(x, p["w_q"], p["scale"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def is_quantized(llama_params: dict) -> bool:
    """True for a decoder tree made by quantize_llama."""
    return llama_params.get("lm_head_q") is not None


@torch.no_grad()
def quantize_llama(params: dict) -> dict:
    """The decoder tree with q/k/v/o/gate/up/down and lm_head in int8, on
    the device the weights live on, one matrix at a time (so the fp32
    temporary is one matrix): a new tree whose layers keep their norms,
    ``lm_head_q`` added, ``lm_head`` None and ``embed_tokens`` in bf16. The
    caller's tree is left as it is; dropping it frees the float weights.
    A tree in the serving layout raises a ValueError."""
    plain_layout(params["layers"], _MATRICES, "quantize_llama")
    out = dict(params)
    out["layers"] = [
        {"input_norm": layer["input_norm"],
         "post_attn_norm": layer["post_attn_norm"],
         **{part: {k: quantize_int8(layer[part][k]["w"]) for k in names}
            for part, names in _MATRICES.items()}}
        for layer in params["layers"]]
    out["lm_head_q"] = quantize_int8(params["lm_head"])
    out["lm_head"] = None
    out["embed_tokens"] = params["embed_tokens"].to(torch.bfloat16)
    return out
