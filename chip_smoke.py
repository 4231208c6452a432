"""Drive the PyTorch / CUDA port (anyref_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):
  1. print the card's name and power limit; build the CUDA kernels from
     anyref_tpu_torch/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes the main path gives it (batch 2 at anyref_7b), and
     time kernel, plain version and one library call (CUDA events, L2
     flushed before every launch, median);
  3. check the slice at anyref_tiny() on the card against the same weights
     and inputs on the CPU (whose plain versions the CPU tests hold against
     the JAX package);
  4. serve 4 text requests at anyref_7b width and depth (random weights from
     a seed) through Server -> Predictor -> generate with speculative
     decode, max_batch 2, and check every answer and each kernel's launch
     count on that path; then serve them again, warm, under torch.profiler
     for the wall time, the device's busy share and the top kernels;
  5. print {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    write-back the timed call would pay."""

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
def check_kernels(torch, F, flash):
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    def compare(name, got, want):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite kernel output")
        err = (got - want).abs()
        if not bool((err <= ATOL + RTOL * want.abs()).all()):
            fail(f"{name}: kernel disagrees with its plain version, max abs "
                 f"err {err.max().item()}")
        return float(err.max().item())

    results = {}

    def run_case(kname, shape_desc, kernel, plain, library, nbytes, ops,
                 ops_rate, iters=10, plain_iters=5):
        err = compare(f"{kname} {shape_desc}", kernel(), plain())
        row = {"shape": shape_desc, "max_abs_err": err,
               "ms": timer.ms(kernel, iters),
               "plain_ms": timer.ms(plain, plain_iters),
               "library_ms": timer.ms(library, iters)}
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_rate)
        log(f"[kernel] {kname} {shape_desc}: max_abs_err {err} kernel "
            f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
            f"{row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
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
    del timer
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: the tiny slice on the card against the CPU
# ---------------------------------------------------------------------------
def check_tiny_slice(torch, anyref_tiny, tparams, anyref_mod):
    cfg = anyref_tiny()
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
                               device="cpu")
    got = anyref_mod.generate(p_gpu, cfg, batch, max_new_tokens=4,
                              device="cuda")
    torch.cuda.synchronize()
    m_got = got.low_res_masks.float().cpu()
    m_want = want.low_res_masks.float()
    if m_got.shape != m_want.shape or not bool(torch.isfinite(m_got).all()):
        fail("tiny slice: masks of the wrong shape or not finite")
    rel = float((m_got - m_want).abs().max() / m_want.abs().max())
    same = int((got.output_ids.cpu() == want.output_ids).sum())
    log(f"[slice-tiny] anyref_tiny bf16, card vs CPU: mask max rel err "
        f"{rel:.4g} (limit {SLICE_REL_TOL}), ids equal {same}/"
        f"{want.output_ids.numel()}")
    if rel > SLICE_REL_TOL:
        fail(f"tiny slice on the card disagrees with the CPU: {rel}")


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
    server = mods["Server"](params, cfg, max_batch=2, speculative=True,
                            max_new_tokens=8)
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
        log(f"[slice] request {i} {h}x{w}: ids {r['output_ids'].tolist()} "
            f"mask {ml.shape[-2:]} on-pixels {int(r['mask'].sum())}")

    n_batches = stats["batches"]
    s, l = cfg.sam, cfg.llama
    per_batch = {"layer_norm_fused": 2 * s.encoder_depth,
                 "flash_relpos_attention": s.encoder_depth,
                 "rms_norm_fused": 2 * l.num_layers,
                 "flash_causal_attention": l.num_layers}
    for name, n in per_batch.items():
        if launches[name] != n * n_batches or launches[name] == 0:
            fail(f"{name}: {launches[name]} launches on the main path, want "
                 f"{n} per batch x {n_batches} batches")
    log(f"[slice] anyref_7b, 4 requests in {n_batches} batches "
        f"({stats['rows']} rows), {wall:.2f} s wall -> "
        f"{len(TEXTS) / wall:.3f} q/s (first run, nothing warmed but the "
        f"kernels); decode passes {passes}")
    log(f"[slice] kernel launches {json.dumps(launches)} (per batch "
        f"{json.dumps(per_batch)})")
    log(f"[slice] Server.stats {json.dumps(stats)}")
    log(f"[slice-warm] the same 4 requests again under torch.profiler: "
        f"{warm['wall_s']:.3f} s wall -> {len(TEXTS) / warm['wall_s']:.3f} q/s; "
        f"kernels busy {warm['busy_ms']:.1f} ms -> device idle "
        f"{100 * (1 - warm['busy_ms'] / 1e3 / warm['wall_s']):.1f}% of the wall")
    for name, ms in warm["top"]:
        log(f"[slice-warm]   {ms:9.3f} ms  {name}")
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
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
        from anyref_tpu_torch.ops import flash
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
    results = check_kernels(torch, F, flash)
    # phase 3
    check_tiny_slice(torch, anyref_tiny, tparams, anyref_mod)
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
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        rows = results[name]
        head = rows[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
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
