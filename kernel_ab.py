"""Time the port's attention kernels, the norms, the fused SAM layers and
their GEMM, and int8_matmul in several checkouts, in turns, on one CUDA
card.

    python3 kernel_ab.py ROOT [ROOT ...]     # e.g. parent change change parent

Each ROOT is a checkout holding anyref_tpu_torch/. Each runs in a process of
its own (and builds its own kernels), in the order given, so that two trees
are compared on the same card within one run. Per root it prints one JSON
line: the median device time (CUDA events, L2 flushed by a 256 MB read
and a ~0.5 ms spin kernel before every launch, so host work is not timed)
of each case, in ms:
  relpos_window  flash_relpos_attention [50, 16, 196, 80] (SAM-H windows,
                 batch 2), the whole wrapper
  relpos_qkv_window  flash_relpos_attention_qkv [50, 196, 3840], 16 heads
                 of 80, the whole wrapper; both window cases are first held
                 against their plain versions (as the int8 cases below)
  sdpa_bias_window  SDPA at the window shape given the bias precomputed in
                 bf16 (library yardstick, timed only)
  sdpa_factors_window  relpos_factors, the bias expansion and SDPA, all in
                 the timed call
  relpos_global  flash_relpos_attention [2, 16, 4096, 80] (SAM-H's global
                 layers, batch 2), the whole wrapper, factor einsums
                 included
  relpos_qkv_global  flash_relpos_attention_qkv [2, 4096, 3840], 16 heads
                 of 80, the whole wrapper (the attention of
                 fused_global_tail); both global cases are first held
                 against their plain versions
  sdpa_bias_global  SDPA at the global shape given the bias precomputed in
                 bf16 (library yardstick, timed only)
  factors_window / factors_global  relpos_factors alone at those shapes
  rms_norm       rms_norm_fused [1280, 4096] with a bf16 scale (the LLaMA-7B
                 prefill at batch 2), first held against its plain version
  f_rms_norm     torch.nn.functional.rms_norm at the same inputs (library
                 yardstick, timed only)
  layer_norm_NxC  layer_norm_fused at SAM-H's [9800, 1280] (the window rows
                 at batch 2, pad rows included) and [8192, 1280] (the global
                 layers) with bf16 scale and bias, each first held against
                 its plain version
  f_layer_norm_NxC  torch.nn.functional.layer_norm at the same inputs
                 (library yardstick, timed only)
  mha_qkv        flash_attention_qkv [2, 257, 3072], 16 heads of 64 (CLIP-L
                 at batch 2), first held against its plain version
  sdpa_clip      SDPA on the same q, k, v (views of the fused QKV; library
                 yardstick, timed only)
  causal         flash_causal_attention [2, 32, 640, 128], kv_start (0, 200)
                 (the serving prefill)
  causal_diff_fwd  causal_attention_diff_fwd [2, 32, 768, 128] (the training
                 forward: O and the log-sum-exp)
  causal_diff_bwd  causal_attention_diff_bwd at the same shape (delta =
                 rowsum(dO * O), then the dq and dk/dv kernels); the prefill
                 and both training cases are first held against their plain
                 versions, the training outputs each within a relative L2
                 error of 1e-2 (the element limits of chip_smoke.py need the
                 terms' sizes, which are not computed here)
  sdpa_causal_fwd / sdpa_causal_fwd_bwd  SDPA with is_causal at the training
                 shape, forward alone and forward plus backward (library
                 yardsticks, timed only)
  int8_MxKxN     int8_matmul of bf16 x [M, K] by int8 w_q [K, N]: the 7B
                 decoder's prefill products at batch 2 (M = 1280: q/k/v/o
                 4096 x 4096, gate/up 4096 x 11008, down 11008 x 4096) and
                 one decode product (M = 2); each is first held against
                 int8_matmul_plain (|a - b| <= 2e-2 + 2e-2 |b|, relative L2
                 <= 1e-2; the run fails if a checked case disagrees)
  cublas_MxKxN   torch.matmul by the bf16 weight, the same prefill shapes
  gemm_qkv / gemm_proj / gemm_fc1 / gemm_fc2  the fused SAM layers' GEMM
                 (flash._gemm) at M = 9800 (SAM-H's windows at batch 2):
                 QKV 1280 x 3840 (+ bias), proj 1280 x 1280 (+ bias + bf16
                 residual), fc1 1280 x 5120 (+ bias, GELU), fc2 5120 x 1280
                 (+ bias + bf16 residual), each first held against the
                 same product in fp32; a tree whose GEMM applies GELU only
                 behind its LayerNorm prologue (the mma.sync GEMM) runs fc1
                 with that prologue, unit weights, the row moments computed
                 outside the timed call; cublas_9800xKxN is torch.matmul at
                 each shape (library yardstick, timed only)
  fused_mlp_stream  [9800, 1280], MLP 5120, and fused_window_attn [50, 196,
                 1280], 16 heads of 80, windows of 14 on the 64 x 64 grid,
                 bf16 weights, each first held against its plain version
Exits non-zero where there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ITERS = 20
SAM_GEMMS = (("qkv", 1280, 3840, "bias"), ("proj", 1280, 1280, "residual"),
             ("fc1", 1280, 5120, "gelu"), ("fc2", 5120, 1280, "residual"))
INT8_SHAPES = ((1280, 4096, 4096), (1280, 4096, 11008), (1280, 11008, 4096),
               (2, 4096, 11008))


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from anyref_tpu_torch.ops import flash

    flash.build()
    g = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(ITERS):
            flush.amax()
            torch.cuda._sleep(1_000_000)  # ~0.5 ms: the host gets ahead
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def check(name, got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        if not bool((err <= 2e-2 + 2e-2 * want.abs()).all()) or \
                float(err.norm() / want.norm()) > 1e-2:
            raise SystemExit(f"{root}: {name} disagrees with its plain "
                             f"version (max abs err {err.max().item()})")

    out = {}
    for name, B, S in (("window", 50, 14), ("global", 2, 64)):
        q, k, v = (rnd(B, 16, S * S, 80) for _ in range(3))
        th, tw = rnd(S, S, 80, scale=0.1), rnd(S, S, 80, scale=0.1)
        check(f"relpos_{name}",
              flash.flash_relpos_attention(q, k, v, th, tw, (S, S)),
              flash.relpos_attention_plain(q, k, v, th, tw, (S, S)))
        out[f"relpos_{name}"] = ms(
            lambda: flash.flash_relpos_attention(q, k, v, th, tw, (S, S)))
        out[f"factors_{name}"] = ms(
            lambda: flash.relpos_factors(q, th, tw, (S, S)))

        def bias():
            rh, rw = flash.relpos_factors(q, th, tw, (S, S))
            return (rh[..., :, None] + rw[..., None, :]).reshape(
                B, 16, S * S, S * S).to(torch.bfloat16)
        b = bias()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out[f"sdpa_bias_{name}"] = ms(lambda: sdpa(q, k, v, attn_mask=b))
        if name == "window":
            out["sdpa_factors_window"] = ms(
                lambda: sdpa(q, k, v, attn_mask=bias()))
        del b
    qkv = rnd(2, 4096, 3 * 1280)
    th, tw = rnd(64, 64, 80, scale=0.1), rnd(64, 64, 80, scale=0.1)
    check("relpos_qkv_global",
          flash.flash_relpos_attention_qkv(qkv, th, tw, (64, 64), 16),
          flash.relpos_attention_qkv_plain(qkv, th, tw, (64, 64), 16))
    out["relpos_qkv_global"] = ms(
        lambda: flash.flash_relpos_attention_qkv(qkv, th, tw, (64, 64), 16))
    del qkv
    x, s = rnd(1280, 4096), rnd(4096)
    check("rms_norm", flash.rms_norm_fused(x, s, 1e-6),
          flash.rms_norm_plain(x, s, 1e-6))
    out["rms_norm"] = ms(lambda: flash.rms_norm_fused(x, s, 1e-6))
    out["f_rms_norm"] = ms(
        lambda: torch.nn.functional.rms_norm(x, (4096,), s, 1e-6))
    for N in (9800, 8192):
        x, s, b = rnd(N, 1280, scale=2.0), rnd(1280), rnd(1280)
        check(f"layer_norm {N}x1280", flash.layer_norm_fused(x, s, b, 1e-6),
              flash.layer_norm_plain(x, s, b, 1e-6))
        out[f"layer_norm_{N}x1280"] = ms(
            lambda: flash.layer_norm_fused(x, s, b, 1e-6))
        out[f"f_layer_norm_{N}x1280"] = ms(
            lambda: torch.nn.functional.layer_norm(x, (1280,), s, b, 1e-6))
    qkv = rnd(50, 196, 3 * 1280)
    th, tw = rnd(14, 14, 80, scale=0.1), rnd(14, 14, 80, scale=0.1)
    check("relpos_qkv_window",
          flash.flash_relpos_attention_qkv(qkv, th, tw, (14, 14), 16),
          flash.relpos_attention_qkv_plain(qkv, th, tw, (14, 14), 16))
    out["relpos_qkv_window"] = ms(
        lambda: flash.flash_relpos_attention_qkv(qkv, th, tw, (14, 14), 16))
    del qkv
    qkv = rnd(2, 257, 3 * 1024)
    check("mha_qkv", flash.flash_attention_qkv(qkv, 16),
          flash.attention_qkv_plain(qkv, 16))
    out["mha_qkv"] = ms(lambda: flash.flash_attention_qkv(qkv, 16))
    q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].view(2, 257, 16, 64)
               .transpose(1, 2) for i in range(3))
    out["sdpa_clip"] = ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    del qkv, q, k, v
    q, k, v = (rnd(2, 32, 640, 128) for _ in range(3))
    ks = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
    check("causal", flash.flash_causal_attention(q, k, v, ks),
          flash.causal_attention_plain(q, k, v, ks))
    out["causal"] = ms(lambda: flash.flash_causal_attention(q, k, v, ks))
    del q, k, v
    out.update(time_causal_diff(torch, flash, rnd, ms, root))
    out.update(time_sam_layers(torch, flash, rnd, ms, check))
    from anyref_tpu_torch.ops import quant
    for M, K, N in INT8_SHAPES:
        x = rnd(M, K)
        w = rnd(K, N, scale=K ** -0.5)
        wq = quant.quantize_int8(w)
        check(f"int8_matmul {M}x{K}x{N}",
              flash.int8_matmul(x, wq["w_q"], wq["scale"]),
              flash.int8_matmul_plain(x, wq["w_q"], wq["scale"]))
        out[f"int8_{M}x{K}x{N}"] = ms(
            lambda: flash.int8_matmul(x, wq["w_q"], wq["scale"]))
        if M > 16:
            out[f"cublas_{M}x{K}x{N}"] = ms(lambda: torch.matmul(x, w))
        del x, w, wq
    return out


def time_sam_layers(torch, flash, rnd, ms, check) -> dict:
    """The fused SAM layers' GEMM at SAM_GEMMS (M = 9800) beside
    torch.matmul, then fused_mlp_stream and fused_window_attn at SAM-H's
    window shapes, each first held against its plain version."""
    out, M, eps = {}, 9800, 1e-6
    epis = {"bias": flash._E_BIAS, "gelu": flash._E_GELU,
            "residual": flash._E_RES}
    for name, K, N, epi in SAM_GEMMS:
        a, w = rnd(M, K), rnd(K, N, scale=K ** -0.5)
        b = rnd(N, scale=0.02).float()
        res = rnd(M, N) if epi == "residual" else None
        kw = {} if res is None else {"res": res}
        h = a
        if epi == "gelu" and hasattr(flash, "_row_stats"):
            one, zero = (torch.full((K,), v, device="cuda") for v in (1., 0.))
            kw.update(ln=(one, zero), stats=flash._row_stats(a, eps))
            h = flash.layer_norm_plain(a.float(), one, zero, eps).to(a.dtype)
        want = h.float() @ w.float() + b
        if epi == "gelu":
            want = flash.gelu_exact_plain(want)
        if res is not None:
            want = want + res.float()
        check(f"gemm_{name}", flash._gemm(a, w, b, epis[epi], **kw),
              want.to(torch.bfloat16))
        del want
        out[f"gemm_{name}"] = ms(lambda: flash._gemm(a, w, b, epis[epi], **kw))
        out[f"cublas_{M}x{K}x{N}"] = ms(lambda: torch.matmul(a, w))
        del a, w, b, res, kw, h
    C, nh, ws = 1280, 16, 14

    def lin(i, o):
        return {"w": rnd(i, o, scale=i ** -0.5), "b": rnd(o, scale=0.02)}

    def ln():
        return {"scale": 1 + rnd(C, scale=0.1), "bias": rnd(C, scale=0.05)}

    xw = rnd(50, ws * ws, C)
    mlp = (xw.view(-1, C), ln(), lin(C, 4 * C), lin(4 * C, C), eps)
    check("fused_mlp_stream", flash.fused_mlp_stream(*mlp),
          flash.fused_mlp_stream_plain(*mlp))
    out["fused_mlp_stream"] = ms(lambda: flash.fused_mlp_stream(*mlp))
    attn = (xw, ln(), lin(C, 3 * C), rnd(ws * ws, C // nh, scale=0.1),
            rnd(ws * ws, C // nh, scale=0.1), lin(C, C), (ws, ws), nh,
            (64, 64), 5, eps)
    check("fused_window_attn", flash.fused_window_attn(*attn),
          flash.fused_window_attn_plain(*attn))
    out["fused_window_attn"] = ms(lambda: flash.fused_window_attn(*attn))
    return out


def time_causal_diff(torch, flash, rnd, ms, root) -> dict:
    """The training attention at [2, 32, 768, 128], no pad: its forward and
    backward kernels, each first held against the plain versions (relative
    L2 error of each output at most 1e-2), and SDPA's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (rnd(2, 32, 768, 128, scale=0.5) for _ in range(3))
    do = rnd(2, 32, 768, 128)
    o, lse = flash.causal_attention_diff_fwd(q, k, v)
    grads = flash.causal_attention_diff_bwd(q, k, v, o, lse, do)
    po, plse = flash.causal_attention_diff_fwd_plain(q, k, v)
    delta = (do.float() * po.float()).sum(-1)
    want = (po, plse, flash.causal_attention_dq_plain(q, k, v, do, plse, delta),
            *flash.causal_attention_dkv_plain(q, k, v, do, plse, delta))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                          want):
        a, b = a.float(), b.float()
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > 1e-2:
            raise SystemExit(f"{root}: causal_diff {name} disagrees with its "
                             f"plain version (relative L2 err {rel})")
    del grads, po, plse, delta, want
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        qg.grad = kg.grad = vg.grad = None
        sdpa(qg, kg, vg, is_causal=True).backward(do)

    return {
        "causal_diff_fwd": ms(lambda: flash.causal_attention_diff_fwd(q, k, v)),
        "causal_diff_bwd": ms(lambda: flash.causal_attention_diff_bwd(
            q, k, v, o, lse, do)),
        "sdpa_causal_fwd": ms(lambda: sdpa(q, k, v, is_causal=True)),
        "sdpa_causal_fwd_bwd": ms(sdpa_fwd_bwd)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps({"root": sys.argv[2], "ms": time_root(sys.argv[2])}),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
