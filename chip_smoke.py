"""Drive the PyTorch / CUDA port (anyref_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):
  1. print the card's name and power limit; build the CUDA kernels from
     anyref_tpu_torch/csrc with nvcc (sm_90a, one process per source) and
     print each kernel's ptxas registers and spills;
  2. hold each of the eight kernels against its plain PyTorch version on
     the card, in bf16, at the shapes the main path gives it (batch 2 at
     anyref_7b) and at one small odd shape, and time kernel, plain version
     and one library call (CUDA events, L2 flushed before every launch,
     median); for the three fused SAM layers, where no one library call
     computes the function, time instead the unfused chain of the same
     layer (the rel-pos / LayerNorm kernels plus cuBLAS matmuls);
  3. check the slice on the card against the same weights and inputs on the
     CPU (whose plain versions the CPU tests hold against the JAX package),
     on both encoder paths: "unfused" at anyref_tiny(), "fused" at
     anyref_tiny() with a 512-pixel SAM image and windows of 8, where both
     fused SAM gates open;
  4. for each encoder path, "fused" (the default) then "unfused": serve 4
     text requests at anyref_7b width and depth (random weights from a
     seed) through Server -> Predictor -> generate with speculative decode,
     max_batch 2, and check every answer and each kernel's launch count on
     that path; then serve them again, warm, under torch.profiler for the
     wall time, the device's busy share and the top kernels;
  5. print {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bf16 tolerance of a kernel against its plain version: |a - b| <= ATOL +
# RTOL * |b|. One bf16 ulp is 2^-8 relative (0.4%); the kernels round P to
# bf16 at a different running max than the plain version, and sum in
# another order.
ATOL = RTOL = 2e-2
# The tiny slice on the card against the CPU: bf16 through two layers of
# each tower, relative to the largest magnitude of the reference.
SLICE_REL_TOL = 5e-2
H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA data sheet (SXM)
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores
SPIN_CYCLES = 1_000_000       # ~0.5 ms at the H100's ~1.98 GHz

TEXTS = (
    "the small brown dog that is sitting on the left side of the wooden "
    "bench next to the old man reading a newspaper",
    "the red car parked behind the blue truck at the far end of the street, "
    "partly hidden by the tall green hedge",
    "the woman in the yellow raincoat holding an umbrella while she waits "
    "for the bus at the corner of the square",
    "the largest of the three ceramic bowls on the kitchen shelf, the one "
    "with the painted flowers around its rim",
)
IMAGE_SIZES = ((224, 224), (224, 320), (288, 224), (224, 480))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
class Timer:
    """Median device time of one call, CUDA events around each launch. The
    L2 cache (50 MB) is flushed before every launch by READING a 256 MB
    buffer: a write would leave the cache full of dirty lines whose
    write-back the timed call would pay. A spin kernel of ~0.5 ms then keeps
    the card busy while the host enqueues the start event, the call and the
    end event, so a wrapper's host work (ctypes, allocation) is not timed as
    device idle between the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.amax()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def bound(nbytes: float, ops: float, ops_rate: float):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def causal_ops(L: int, hd: int, nh: int, kv_start) -> float:
    """Operations the data needs: 4*hd per kept (query, key) pair; each
    fully masked (left-pad) row needs only the mean of V, 2*hd*L once per
    (row of the batch, head)."""
    total = 0.0
    for pad in kv_start:
        kept = sum(q - pad + 1 for q in range(pad, L))
        total += nh * (4 * hd * kept + (2 * hd * L if pad else 0))
    return total


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(torch, F, flash, port):
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    def compare(name, got, want):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            fail(f"{name}: kernel output {tuple(got.shape)}, plain "
                 f"{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite kernel output")
        err = (got - want).abs()
        if not bool((err <= ATOL + RTOL * want.abs()).all()):
            fail(f"{name}: kernel disagrees with its plain version, max abs "
                 f"err {err.max().item()}")
        return float(err.max().item())

    results = {}

    def run_case(kname, shape_desc, kernel, plain, library, nbytes, ops,
                 ops_rate, iters=10, plain_iters=5, unfused=None):
        """library: one PyTorch call computing the same function, or None;
        unfused: the unfused chain of the same SAM layer half, timed where
        there is no library call."""
        err = compare(f"{kname} {shape_desc}", kernel(), plain())
        row = {"shape": shape_desc, "max_abs_err": err,
               "ms": timer.ms(kernel, iters),
               "plain_ms": timer.ms(plain, plain_iters),
               "library_ms": None if library is None else
               timer.ms(library, iters)}
        if unfused is not None:
            row["unfused_ms"] = timer.ms(unfused, iters)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_rate)
        other = (f"library {row['library_ms']:.4f} ms" if library else
                 f"unfused chain {row['unfused_ms']:.4f} ms")
        log(f"[kernel] {kname} {shape_desc}: max_abs_err {err} kernel "
            f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms {other} "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        results.setdefault(kname, []).append(row)

    # LayerNorm: SAM LN1/LN2 rows at batch 2 (window run with pad rows,
    # then global layers)
    for N in (9800, 8192):
        C = 1280
        x, s, b = rnd(N, C, scale=2.0), rnd(C), rnd(C)
        run_case("layer_norm_fused", f"{N}x{C}",
                 lambda: flash.layer_norm_fused(x, s, b, 1e-6),
                 lambda: flash.layer_norm_plain(x, s, b, 1e-6),
                 lambda: F.layer_norm(x, (C,), s, b, 1e-6),
                 2 * N * C * 2 + 2 * C * 2, 8 * N * C, H100_FP32_OPS_PER_S)
    # RMSNorm: LLaMA prefill rows at batch 2, L = 640
    N, C = 1280, 4096
    x, s = rnd(N, C), rnd(C)
    run_case("rms_norm_fused", f"{N}x{C}",
             lambda: flash.rms_norm_fused(x, s, 1e-6),
             lambda: flash.rms_norm_plain(x, s, 1e-6),
             lambda: F.rms_norm(x, (C,), s, 1e-6),
             2 * N * C * 2 + C * 2, 5 * N * C, H100_FP32_OPS_PER_S)
    # rel-pos attention: SAM-H windows (B*25 windows of 14x14) and global
    # layers (64x64), 16 heads of 80
    for B, S in ((50, 14), (2, 64)):
        nh, hd, L = 16, 80, S * S
        q, k, v = (rnd(B, nh, L, hd) for _ in range(3))
        th, tw = rnd(S, S, hd, scale=0.1), rnd(S, S, hd, scale=0.1)
        rh, rw = flash.relpos_factors(q, th, tw, (S, S))
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(
            B, nh, L, L).to(torch.bfloat16)
        run_case("flash_relpos_attention", f"{B}x{nh}x{L}x{hd}",
                 lambda: flash.flash_relpos_attention(q, k, v, th, tw, (S, S)),
                 lambda: flash.relpos_attention_plain(q, k, v, th, tw,
                                                      (S, S)),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=bias),
                 4 * B * nh * L * hd * 2 + 2 * S * S * hd * 2,
                 B * nh * (4 * L * L * hd + 2 * L * 2 * S * hd),
                 H100_BF16_OPS_PER_S, plain_iters=3)
        del bias, rh, rw
    # causal prefill: LLaMA-7B, batch 2, prompt bucket 385 -> L 640, one
    # row left-padded by 200
    B, nh, L, hd = 2, 32, 640, 128
    q, k, v = (rnd(B, nh, L, hd) for _ in range(3))
    ks = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
    pos = torch.arange(L, device="cuda")
    keep = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] >= ks[:, None, None]))[:, None]
    run_case("flash_causal_attention", f"{B}x{nh}x{L}x{hd}",
             lambda: flash.flash_causal_attention(q, k, v, ks),
             lambda: flash.causal_attention_plain(q, k, v, ks),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
             4 * B * nh * L * hd * 2 + B * 4,
             causal_ops(L, hd, nh, (0, 200)), H100_BF16_OPS_PER_S)
    del q, k, v, keep
    check_fused_kernels(torch, F, flash, port, rnd, run_case)
    del timer
    torch.cuda.empty_cache()
    return results


def check_fused_kernels(torch, F, flash, port, rnd, run_case):
    """The four kernels of the fused encoder path, at the main path's shapes
    (SAM-H at batch 2: C 1280, 16 heads of 80, MLP 5120, windows of 14 on
    the 64 x 64 grid padded to 70, global grid 64 x 64; CLIP-L: [2, 257,
    3072], 16 heads of 64) and at one small odd shape each."""
    enc, common = port["image_encoder"], port["common"]
    eps = 1e-6

    def lin(i, o):
        return {"w": rnd(i, o, scale=i ** -0.5), "b": rnd(o, scale=0.02)}

    def ln(d):
        return {"scale": (1 + 0.1 * rnd(d).float()).to(torch.bfloat16),
                "bias": rnd(d, scale=0.05)}

    def gemm_ops(M, *kn):
        return sum(2 * M * k * n for k, n in kn)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # fused_window_attn / fused_mlp_stream: 7B windows, then C 128 (4 heads
    # of 32) with windows of 8 on a 20 x 20 grid (edge windows overhang)
    for B, C, nh, ws, G in ((2, 1280, 16, 14, 64), (2, 128, 4, 8, 20)):
        hd = C // nh
        p = {"norm1": ln(C), "norm2": ln(C),
             "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C),
                      "rel_pos_h": rnd(2 * ws - 1, hd, scale=0.1),
                      "rel_pos_w": rnd(2 * ws - 1, hd, scale=0.1)},
             "mlp": {"lin1": lin(C, 4 * C), "lin2": lin(4 * C, C)}}
        x = rnd(B, G, G, C)
        xw4, pad_hw = enc._window_partition(x, ws)
        mask, _ = enc._window_partition(
            torch.ones(B, G, G, 1, dtype=x.dtype, device="cuda"), ws)
        NW, L = xw4.shape[0], ws * ws
        nwc = pad_hw[1] // ws
        xw = xw4.reshape(NW, L, C)
        tht = enc._get_rel_pos_table(ws, p["attn"]["rel_pos_h"]).reshape(L, -1)
        twt = enc._get_rel_pos_table(ws, p["attn"]["rel_pos_w"]).reshape(L, -1)
        args = (xw, p["norm1"], p["attn"]["qkv"], tht, twt, p["attn"]["proj"],
                (ws, ws), nh, (G, G), nwc, eps)

        def unfused_attn():
            h = common.layer_norm(p["norm1"], xw4, eps, fused=True) * mask
            return xw4 + enc._attn_block(p["attn"], h, nh, (ws, ws))

        M = NW * L
        run_case("fused_window_attn", f"{NW}x{L}x{C}",
                 lambda: flash.fused_window_attn(*args),
                 lambda: flash.fused_window_attn_plain(*args), None,
                 nbytes(xw, p["attn"]["qkv"]["w"], p["attn"]["proj"]["w"],
                        tht, twt) + M * C * 2,
                 gemm_ops(M, (C, 3 * C), (C, C))
                 + NW * nh * (4 * L * L * hd + 2 * L * 2 * ws * hd),
                 H100_BF16_OPS_PER_S, plain_iters=3, unfused=unfused_attn)
        xf = xw.reshape(M, C) if C == 1280 else rnd(700, C)
        mlp = (xf, p["norm2"], p["mlp"]["lin1"], p["mlp"]["lin2"], eps)

        def unfused_mlp():
            h = common.layer_norm(p["norm2"], xf, eps, fused=True)
            return xf + common.linear(p["mlp"]["lin2"], common.gelu(
                common.linear(p["mlp"]["lin1"], h)))

        run_case("fused_mlp_stream", f"{xf.shape[0]}x{C}",
                 lambda: flash.fused_mlp_stream(*mlp),
                 lambda: flash.fused_mlp_stream_plain(*mlp), None,
                 nbytes(xf, p["mlp"]["lin1"]["w"], p["mlp"]["lin2"]["w"])
                 + xf.numel() * 2,
                 gemm_ops(xf.shape[0], (C, 4 * C), (4 * C, C)),
                 H100_BF16_OPS_PER_S, plain_iters=3, unfused=unfused_mlp)
        del xw4, mask, xw, xf, mlp, args, p

    # fused_global_tail: the 7B global layer, then a 16 x 64 grid of 2
    # heads of 32
    for B, H, W, C, nh in ((2, 64, 64, 1280, 16), (2, 16, 64, 64, 2)):
        hd, L = C // nh, H * W
        p = {"norm2": ln(C), "proj": lin(C, C), "lin1": lin(C, 4 * C),
             "lin2": lin(4 * C, C)}
        x, qkv = rnd(B, L, C), rnd(B, L, 3 * C)
        tht = enc._get_rel_pos_table(H, rnd(2 * H - 1, hd, scale=0.1))
        twt = enc._get_rel_pos_table(W, rnd(2 * W - 1, hd, scale=0.1))
        args = (x, qkv, tht, twt, p["proj"], p["norm2"], p["lin1"],
                p["lin2"], (H, W), nh, eps)

        def unfused_tail():
            q, k, v = qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
            o = flash.flash_relpos_attention(q, k, v, tht, twt, (H, W))
            x1 = x + common.linear(p["proj"], o.transpose(1, 2).reshape(
                B, L, C))
            h = common.layer_norm(p["norm2"], x1, eps, fused=True)
            return x1 + common.linear(p["lin2"], common.gelu(
                common.linear(p["lin1"], h)))

        run_case("fused_global_tail", f"{B}x{L}x{C}",
                 lambda: flash.fused_global_tail(*args),
                 lambda: flash.fused_global_tail_plain(*args), None,
                 nbytes(x, qkv, p["proj"]["w"], p["lin1"]["w"],
                        p["lin2"]["w"], tht, twt) + x.numel() * 2,
                 B * nh * (4 * L * L * hd + 2 * L * (H + W) * hd)
                 + gemm_ops(B * L, (C, C), (C, 4 * C), (4 * C, C)),
                 H100_BF16_OPS_PER_S, plain_iters=2, unfused=unfused_tail)
        del x, qkv, args, p

    # flash_attention_qkv: CLIP-L at batch 2, then L 77 with 4 heads of 36
    # (a head width that takes the kernel's unvectorised loads)
    for B, L, nh, hd in ((2, 257, 16, 64), (2, 77, 4, 36)):
        C = nh * hd
        qkv = rnd(B, L, 3 * C)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, L, nh, hd)
                   .transpose(1, 2) for i in range(3))
        run_case("flash_attention_qkv", f"{B}x{L}x{3 * C}",
                 lambda: flash.flash_attention_qkv(qkv, nh),
                 lambda: flash.attention_qkv_plain(qkv, nh),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 B * L * 4 * C * 2, 4 * B * nh * L * L * hd,
                 H100_BF16_OPS_PER_S)


# ---------------------------------------------------------------------------
# phase 3: the tiny slice on the card against the CPU
# ---------------------------------------------------------------------------
def check_tiny_slice(torch, cfg, encoder_path, tparams, anyref_mod):
    p_cpu = tparams.init(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, device="cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    rng = np.random.default_rng(0)
    ids = np.zeros((2, 257), np.int64)
    for b, n in enumerate((200, 150)):
        ids[b, 257 - n:] = rng.integers(3, 259, n)
        ids[b, 257 - n + 5] = cfg.tokens.image
    batch = {"input_ids": ids,
             "clip_images": rng.standard_normal(
                 (2, 3, 224, 224)).astype(np.float32),
             "sam_images": rng.standard_normal(
                 (2, 3, cfg.sam.image_size, cfg.sam.image_size)
             ).astype(np.float32)}
    want = anyref_mod.generate(p_cpu, cfg, batch, max_new_tokens=4,
                               device="cpu", encoder_path=encoder_path)
    got = anyref_mod.generate(p_gpu, cfg, batch, max_new_tokens=4,
                              device="cuda", encoder_path=encoder_path)
    torch.cuda.synchronize()
    m_got = got.low_res_masks.float().cpu()
    m_want = want.low_res_masks.float()
    if m_got.shape != m_want.shape or not bool(torch.isfinite(m_got).all()):
        fail("tiny slice: masks of the wrong shape or not finite")
    rel = float((m_got - m_want).abs().max() / m_want.abs().max())
    same = int((got.output_ids.cpu() == want.output_ids).sum())
    log(f"[slice-tiny] {encoder_path} path, SAM {cfg.sam.image_size} px, "
        f"windows of {cfg.sam.window_size}, bf16, card vs CPU: mask max rel "
        f"err {rel:.4g} (limit {SLICE_REL_TOL}), ids equal {same}/"
        f"{want.output_ids.numel()}")
    if rel > SLICE_REL_TOL:
        fail(f"tiny slice ({encoder_path}) on the card disagrees with the "
             f"CPU: {rel}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 4: the main path at anyref_7b
# ---------------------------------------------------------------------------
def serve_7b(torch, flash, mods):
    """Both encoder paths at anyref_7b on one set of weights; returns the
    launch counts of each path's counted run."""
    cfg = mods["anyref_7b"]()
    t0 = time.time()
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[slice] params.init(anyref_7b) on the card: "
        f"{time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    # Random weights almost never emit [SEG]; scale the [SEG] column of the
    # fp32 lm_head by 1000 so [SEG] wins wherever its logit is positive and
    # the mask path runs.
    params["llama"]["lm_head"][:, cfg.tokens.seg] *= 1000.0
    log("[slice] lm_head[:, tokens.seg] scaled by 1000 so [SEG] is emitted "
        "(random weights)")

    tok = mods["AnyRefTokenizer"]()
    lens = [len(mods["tokenize_prompt"](tok, mods["seg_question"](t)))
            for t in TEXTS]
    if not all(257 < n <= 385 for n in lens):
        fail(f"prompt lengths {lens} miss the 385 bucket")

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in IMAGE_SIZES]
    s, l, c = cfg.sam, cfg.llama, cfg.clip
    n_global = len(s.encoder_global_attn_indexes)
    per_batch = {
        "fused": {"fused_window_attn": s.encoder_depth - n_global,
                  "fused_mlp_stream": s.encoder_depth - n_global,
                  "fused_global_tail": n_global,
                  "layer_norm_fused": n_global,
                  "flash_attention_qkv": c.num_layers + c.select_layer + 1,
                  "flash_relpos_attention": 0},
        "unfused": {"layer_norm_fused": 2 * s.encoder_depth,
                    "flash_relpos_attention": s.encoder_depth,
                    "fused_window_attn": 0, "fused_mlp_stream": 0,
                    "fused_global_tail": 0, "flash_attention_qkv": 0},
    }
    launches = {}
    for path in ("fused", "unfused"):
        want = dict(per_batch[path], rms_norm_fused=2 * l.num_layers,
                    flash_causal_attention=l.num_layers)
        launches[path] = serve_path(torch, flash, mods, params, cfg, path,
                                    images, want)
    return launches


def serve_path(torch, flash, mods, params, cfg, path, images, per_batch):
    """Serve the 4 requests on one encoder path: counted run (every answer
    and every kernel's launch count checked), then a warm run under the
    profiler."""
    server = mods["Server"](params, cfg, max_batch=2, speculative=True,
                            max_new_tokens=8, encoder_path=path)
    for kernel in flash.KERNELS:
        kernel.launches = 0
    t0 = time.time()
    reqs = [server.submit(mods["Request"](image=im, text=t))
            for im, t in zip(images, TEXTS)]
    results = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.__name__: k.launches for k in flash.KERNELS}
    stats = dict(server.stats)
    passes = server.predictor.decode_passes_total
    warm = profile_warm_round(torch, server, mods["Request"], images)
    server.shutdown()

    for i, (r, (h, w)) in enumerate(zip(results, IMAGE_SIZES)):
        if not r:
            fail(f"request {i}: no answer within the time limit")
        if "error" in r:
            fail(f"request {i}: {r['error']}")
        ml = r["mask_logits"]
        if ml is None:
            fail(f"request {i}: no [SEG] emitted, ids {r['output_ids']}")
        if ml.shape[-2:] != (h, w) or not np.isfinite(ml).all():
            fail(f"request {i}: mask logits {ml.shape} (want {(h, w)}) or "
                 "not finite")
        if r["mask"].shape != (h, w):
            fail(f"request {i}: mask {r['mask'].shape}, want {(h, w)}")
        log(f"[slice {path}] request {i} {h}x{w}: ids "
            f"{r['output_ids'].tolist()} mask {ml.shape[-2:]} on-pixels "
            f"{int(r['mask'].sum())}")

    n_batches = stats["batches"]
    for name, n in per_batch.items():
        if launches[name] != n * n_batches or (n and not launches[name]):
            fail(f"{name}: {launches[name]} launches on the {path} path, "
                 f"want {n} per batch x {n_batches} batches")
    log(f"[slice {path}] anyref_7b, 4 requests in {n_batches} batches "
        f"({stats['rows']} rows), {wall:.2f} s wall -> "
        f"{len(TEXTS) / wall:.3f} q/s (first run, nothing warmed but the "
        f"kernels); decode passes {passes}")
    log(f"[slice {path}] kernel launches {json.dumps(launches)} (per batch "
        f"{json.dumps(per_batch)})")
    log(f"[slice {path}] Server.stats {json.dumps(stats)}")
    log(f"[slice-warm {path}] the same 4 requests again under torch.profiler: "
        f"{warm['wall_s']:.3f} s wall -> {len(TEXTS) / warm['wall_s']:.3f} q/s; "
        f"kernels busy {warm['busy_ms']:.1f} ms -> device idle "
        f"{100 * (1 - warm['busy_ms'] / 1e3 / warm['wall_s']):.1f}% of the wall")
    for name, ms in warm["top"]:
        log(f"[slice-warm {path}]   {ms:9.3f} ms  {name}")
    return launches


def profile_warm_round(torch, server, Request, images):
    """Serve the same requests a second time, warm, under torch.profiler:
    wall time, summed kernel time (one stream, so the device's busy time)
    and the kernels that take most of it. Runs after the launch counts of
    the main path were read."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        reqs = [server.submit(Request(image=im, text=t))
                for im, t in zip(images, TEXTS)]
        results = [r.result(timeout=600) for r in reqs]
        torch.cuda.synchronize()
        wall = time.time() - t0
    if not all(r and "error" not in r for r in results):
        fail("warm round: a request failed")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "busy_ms": busy_ms,
            "top": [(n[:90], us / 1e3) for n, us in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import torch.nn.functional as F
        from anyref_tpu_torch import params as tparams
        from anyref_tpu_torch.config import anyref_7b, anyref_tiny
        from anyref_tpu_torch.models import anyref as anyref_mod
        from anyref_tpu_torch.models.sam import image_encoder
        from anyref_tpu_torch.ops import common, flash
        from anyref_tpu_torch.serve import Request, Server
        from anyref_tpu_torch.tokenizer import (AnyRefTokenizer,
                                                seg_question, tokenize_prompt)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    # phase 1
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    t0 = time.time()
    lib = flash.build()
    log(f"[build] {lib.name} in {time.time() - t0:.1f} s")
    for src in flash.SOURCES:
        tag = lib.stem.rsplit("-", 1)[1]
        logf = flash.BUILD_DIR / f"{src.rsplit('.', 1)[0]}-{tag}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {src}: {line.strip()}")

    # phase 2
    results = check_kernels(torch, F, flash, {"image_encoder": image_encoder,
                                              "common": common})
    # phase 3: the unfused path at anyref_tiny, the fused one where both
    # fused SAM gates open (64 <= ws^2 and a 32 x 32 global grid)
    tiny = anyref_tiny()
    check_tiny_slice(torch, tiny, "unfused", tparams, anyref_mod)
    check_tiny_slice(torch, dataclasses.replace(tiny, sam=dataclasses.replace(
        tiny.sam, image_size=512, window_size=8)), "fused", tparams,
        anyref_mod)
    # phase 4
    launches = serve_7b(torch, flash, {
        "anyref_7b": anyref_7b, "tparams": tparams, "Server": Server,
        "Request": Request, "AnyRefTokenizer": AnyRefTokenizer,
        "seg_question": seg_question, "tokenize_prompt": tokenize_prompt})

    # phase 5
    meta = {
        "layer_norm_fused": ("anyref_tpu_torch/csrc/norms.cu",
                             "anyref_tpu/ops/flash.py:615"),
        "rms_norm_fused": ("anyref_tpu_torch/csrc/norms.cu",
                           "anyref_tpu/ops/flash.py:651"),
        "flash_relpos_attention": ("anyref_tpu_torch/csrc/relpos_attention.cu",
                                   "anyref_tpu/ops/flash.py:192"),
        "flash_causal_attention": ("anyref_tpu_torch/csrc/causal_attention.cu",
                                   "anyref_tpu/ops/flash.py:323"),
        "fused_window_attn": ("anyref_tpu_torch/csrc/fused_layers.cu",
                              "anyref_tpu/ops/flash.py:989"),
        "fused_mlp_stream": ("anyref_tpu_torch/csrc/fused_layers.cu",
                             "anyref_tpu/ops/flash.py:1109"),
        "fused_global_tail": ("anyref_tpu_torch/csrc/fused_layers.cu",
                              "anyref_tpu/ops/flash.py:1226"),
        "flash_attention_qkv": ("anyref_tpu_torch/csrc/qkv_attention.cu",
                                "anyref_tpu/ops/flash.py:1395"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        rows = results[name]
        head = rows[0]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            # the count of the encoder path the kernel serves: the fused
            # one (the default) for all but the unfused path's rel-pos
            # attention
            "launches": by_path["unfused" if name == "flash_relpos_attention"
                                else "fused"],
            "launches_by_path": by_path,
            "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "unfused_ms": head.get("unfused_ms"),
            "other_shapes": rows[1:],
        })
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
