"""The port's kernel plain versions (anyref_tpu_torch/ops/flash.py) against
the JAX package's Pallas kernels run in interpret mode, fp32, same inputs.

On the CPU every port wrapper runs its plain version; the CUDA kernels are
held against these same plain versions on the card by chip_smoke.py.
Tolerance: atol = rtol = 1e-5 in fp32 unless a test says otherwise (the two
sides sum in different orders; a wrong mask, bias or index is O(1)).

Every test here runs torch's CPU products in IEEE fp32 (``ieee_fp32``): a
reduced-precision fp32 product (torch's "high" matmul precision selects
oneDNN's TF32 math, which CPUs with AMX-FP16 execute) errs by about 2^-15,
which these limits rightly refuse but which says nothing about the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyref_tpu.ops import flash as jflash
from anyref_tpu_torch.ops import flash as tflash

TOL = {"atol": 1e-5, "rtol": 1e-5}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True)
def ieee_fp32():
    """torch's CPU fp32 products in IEEE fp32, whatever an earlier test of
    the same process set: the "highest" matmul precision and no oneDNN."""
    prec = torch.get_float32_matmul_precision()
    onednn = torch.backends.mkldnn.enabled
    torch.set_float32_matmul_precision("highest")
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = onednn
        torch.set_float32_matmul_precision(prec)


def _relpos_fp64(q, k, v, th, tw, ws):
    """The rel-pos attention in fp64, to name the side that strays."""
    q, k, v, th, tw = (a.astype(np.float64) for a in (q, k, v, th, tw))
    B, nh, L, hd = q.shape
    qg = q.reshape(B, nh, ws, ws, hd)
    rh = np.einsum("bnhwc,hkc->bnhwk", qg, th).reshape(B, nh, L, ws)
    rw = np.einsum("bnhwc,wkc->bnhwk", qg, tw).reshape(B, nh, L, ws)
    s = np.einsum("bnqd,bnkd->bnqk", q, k) * hd ** -0.5
    s = s + np.repeat(rh, ws, axis=-1) + np.tile(rw, (1, 1, 1, ws))
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p @ v) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("ws,nh,hd", [(14, 2, 80), (32, 1, 16), (4, 2, 32)],
                         ids=["window-L196", "blocked-L1024", "window-L16"])
def test_relpos_attention_matches_pallas(ws, nh, hd):
    """ws 14 and 4 (anyref_7b's and anyref_tiny's windows) run the
    reference's one-window-per-step kernel, 32x32 its query-blocked kernel
    (L >= 1024)."""
    rng = np.random.default_rng(0)
    L = ws * ws
    q, k, v = (rng.standard_normal((2, nh, L, hd)).astype(np.float32)
               for _ in range(3))
    th = (rng.standard_normal((ws, ws, hd)) * 0.1).astype(np.float32)
    tw = (rng.standard_normal((ws, ws, hd)) * 0.1).astype(np.float32)
    want = np.asarray(jflash.flash_relpos_attention(
        *(jnp.asarray(a) for a in (q, k, v, th, tw)), (ws, ws),
        interpret=True))
    got = tflash.flash_relpos_attention(*(_t(a) for a in (q, k, v, th, tw)),
                                        (ws, ws)).numpy()
    exact = _relpos_fp64(q, k, v, th, tw, ws)
    np.testing.assert_allclose(got, want, **TOL, err_msg=(
        f"largest error against fp64: port {np.abs(got - exact).max():.3g}, "
        f"reference {np.abs(want - exact).max():.3g}; torch "
        f"{torch.get_float32_matmul_precision()} matmuls, "
        f"{torch.get_num_threads()} threads"))


def _sam_grids(cfg):
    """(L, head width) of each rel-pos attention grid of cfg's SAM encoder:
    its windows and its global layers."""
    s = cfg.sam
    hd = s.encoder_embed_dim // s.encoder_num_heads
    return {"window": (s.window_size ** 2, hd),
            "global": (s.embedding_size ** 2, hd)}


def test_relpos_route_by_grid():
    """The windows of anyref_7b (14 x 14) and anyref_tiny (4 x 4) and
    anyref_tiny's 16 x 16 global layer take the window kernel; anyref_7b's
    64 x 64 global layers the global kernel (csrc/relpos_global.cu), heads
    whose width is not a multiple of 8 (17 x 19 of 36) after the wrapper
    zero-pads them; heads wider than 128 neither."""
    from anyref_tpu_torch.config import anyref_7b, anyref_tiny
    big, tiny = _sam_grids(anyref_7b()), _sam_grids(anyref_tiny())
    assert big == {"window": (196, 80), "global": (4096, 80)}
    assert tiny == {"window": (16, 32), "global": (256, 32)}
    route = tflash._relpos_route
    assert [route(*big["window"]), route(*tiny["window"]),
            route(*tiny["global"])] == ["window"] * 3
    assert route(*big["global"]) == "global"
    assert route(tflash.WINDOW_MAX_L + 1, 80) == "global"
    assert route(17 * 19, 36) == "global_pad8"
    for L in (196, 4096):
        with pytest.raises(ValueError):
            route(L, 144)


def test_global_operand_views():
    """The rank-4 views (storage offset, strides) the global kernel's
    tensor maps read: split heads, the unfused path's heads permuted out of
    a fused QKV (models/sam/image_encoder.py _attn_block) and each third of
    a fused QKV (_split_qkv) are read in place, and each view rebuilt with
    torch.as_strided from the flat storage is the tensor itself; q, k and v
    share their strides. A width that is not a multiple of 8 is copied."""
    g = torch.Generator().manual_seed(0)
    B, H, W, nh, hd = 2, 4, 6, 3, 16
    L, C = H * W, nh * hd

    def rebuilt(t):
        off, (sb, sh, sr) = tflash._head_view(t)
        flat = t.untyped_storage()
        base = torch.tensor([], dtype=t.dtype).set_(flat)
        return torch.as_strided(base, t.shape, (sb, sh, sr, 1), off)

    split = [torch.randn(B, nh, L, hd, generator=g) for _ in range(3)]
    qkv = torch.randn(B, L, 3 * C, generator=g)
    permuted = list(qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4))
    thirds = tflash._split_qkv(qkv, nh)
    for views in (split, permuted, thirds):
        strides = {tflash._head_view(t)[1] for t in views}
        assert len(strides) == 1
        for t in views:
            assert torch.equal(rebuilt(t), t)
    assert tflash._head_view(thirds[1])[0] == C
    assert tflash._head_view(permuted[2])[0] == 2 * C
    assert tflash._head_view(thirds[0])[1] == (L * 3 * C, hd, 3 * C)
    out = torch.empty(B, L, C).view(B, L, nh, hd).transpose(1, 2)
    assert tflash._head_view(out) == (0, (L * C, hd, C))
    odd = torch.randn(B, L, 3 * nh * 36, generator=g)
    assert all(tflash._head_view(t) is None
               for t in tflash._split_qkv(odd, nh))


def test_attention_qkv_operands():
    """flash_attention_qkv's operands as csrc/relpos_global.cu takes them
    (_tma_heads): CLIP-L's fused QKV [2, 257, 3072], 16 heads of 64, is
    read in place, its thirds at offsets 0, C and 2C with one set of
    strides, and the head-merged output written in place; heads of 36
    (not a multiple of 8) are copied, zero-padded to 40 columns, and
    written through a buffer of that width."""
    B, L, nh = 2, 257, 16
    for hd in (64, 36):
        C = nh * hd
        qkv = torch.zeros(B, L, 3 * C, dtype=torch.bfloat16)
        thirds = tflash._split_qkv(qkv, nh)
        heads = torch.empty(B, L, C, dtype=torch.bfloat16).view(
            B, L, nh, hd).transpose(1, 2)
        q, k, v, strides, o = tflash._tma_heads(*thirds, heads)
        if hd == 64:
            assert all(a is b for a, b in zip((q, k, v), thirds))
            assert [tflash._head_view(t)[0] for t in thirds] == [0, C, 2 * C]
            assert strides == (L * 3 * C, hd, 3 * C)
            assert o is heads
        else:
            assert all(tflash._head_view(t) is None for t in thirds)
            assert all(t.shape == (B, nh, L, 40) and t.is_contiguous()
                       for t in (q, k, v))
            assert torch.equal(q[..., :hd], thirds[0])
            assert not q[..., hd:].any()
            assert strides == (nh * L * 40, L * 40, 40)
            assert o is not heads and o.shape == (B, nh, L, 40)


def test_causal_route_by_head_width():
    """The decoder heads of anyref_7b (128) and anyref_tiny (32) go to the
    causal kernels as they are ("tma": rows of a multiple of 16 bytes);
    other widths up to 128 are zero-padded to a multiple of 8 ("pad8"),
    which leaves q . k and the kept columns of the output alone; heads
    wider than 128 raise."""
    from anyref_tpu_torch.config import anyref_7b, anyref_tiny
    route = tflash._causal_route
    for cfg in (anyref_7b(), anyref_tiny()):
        ll = cfg.llama
        assert route(ll.hidden_size // ll.num_heads) == "tma"
    assert [route(hd) for hd in (8, 64, 80, 120)] == ["tma"] * 4
    assert [route(hd) for hd in (1, 36, 127)] == ["pad8"] * 3
    for hd in (0, 136):
        with pytest.raises(ValueError):
            route(hd)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 36, generator=g) for _ in range(3))
    assert tflash._causal_args("t", q, k, v, None)[4] == 40
    qp, kp = (tflash._causal_operand(t, 40) for t in (q, k))
    assert qp.shape == (1, 2, 40, 40) and bool((qp[..., 36:] == 0).all())
    assert torch.equal(qp[..., :36], q)
    np.testing.assert_allclose(torch.einsum("bnqd,bnkd->bnqk", qp, kp),
                               torch.einsum("bnqd,bnkd->bnqk", q, k), **TOL)


@pytest.mark.parametrize("mh", ["1", "0"])
def test_causal_attention_matches_pallas(monkeypatch, mh):
    """kv_start 70 leaves rows 0..69 of batch row 1 with no key: they must
    be finite and equal to the reference's uniform mean of V, like every
    other row. mh selects the reference's multi-head or per-head kernel."""
    monkeypatch.setenv("ANYREF_CAUSAL_MH_KERNEL", mh)
    rng = np.random.default_rng(1)
    B, nh, L, hd = 2, 2, 256, 64
    q, k, v = (rng.standard_normal((B, nh, L, hd)).astype(np.float32)
               for _ in range(3))
    ks = np.asarray([0, 70], np.int32)
    want = np.asarray(jflash.flash_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), kv_start=jnp.asarray(ks),
        interpret=True))
    got = tflash.flash_causal_attention(*(_t(a) for a in (q, k, v)),
                                        _t(ks)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[1, :, :70],
                               np.broadcast_to(v[1].mean(1, keepdims=True),
                                               (nh, 70, hd)), **TOL)


@pytest.mark.parametrize("kind,C,scale_dtype", [
    pytest.param("layer", 128, "float32", id="layer"),
    pytest.param("layer", 1280, "bfloat16", id="layer-bf16-weights-1280"),
    pytest.param("layer", 100, "float32", id="layer-odd-width"),
    pytest.param("rms", 128, "float32", id="rms"),
    pytest.param("rms", 4096, "bfloat16", id="rms-bf16-scale-4096"),
    pytest.param("rms", 100, "float32", id="rms-odd-width")])
def test_norms_match_pallas(kind, C, scale_dtype):
    """300 rows (not a multiple of the reference's 256-row block), C 128;
    LayerNorm also at SAM-H's width with bf16 scale and bias (anyref_7b's
    weights: the CUDA kernel reads them as bf16), RMSNorm at the LLaMA-7B
    width with a bf16 scale, and both at a width that is not a multiple of
    8 (the kernel's element-by-element path)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 100, C)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    js, jb = (jnp.asarray(a).astype(scale_dtype) for a in (s, b))
    ts, tb = (_t(a).to(getattr(torch, scale_dtype)) for a in (s, b))
    if kind == "layer":
        want = jflash.layer_norm_fused(jnp.asarray(x), js, jb, 1e-6,
                                       interpret=True)
        got = tflash.layer_norm_fused(_t(x), ts, tb, 1e-6)
    else:
        want = jflash.rms_norm_fused(jnp.asarray(x), js, 1e-6,
                                     interpret=True)
        got = tflash.rms_norm_fused(_t(x), ts, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_weights_read_as_they_come():
    """The norm kernels read bf16 or fp32 weights as they are, so a call
    launches one CUDA kernel: only another dtype, or a scale and bias of
    different dtypes, is converted (to fp32); weights of the wrong size
    raise."""
    C = 24
    bf, f32 = torch.ones(C, dtype=torch.bfloat16), torch.zeros(C)
    s, b = tflash._norm_weights("ln", C, "cpu", bf, bf)
    assert s is bf and b is bf
    (s,) = tflash._norm_weights("rms", C, "cpu", f32)
    assert s is f32
    for ws in ((bf, f32), (bf.half(), bf.half())):
        got = tflash._norm_weights("ln", C, "cpu", *ws)
        assert all(w.dtype == torch.float32 for w in got)
        assert all(torch.equal(w, v.float()) for w, v in zip(got, ws))
    assert tflash._norm_weights("ln", C, "cpu", f32[::2].repeat(2),
                                f32)[0].is_contiguous()
    with pytest.raises(ValueError):
        tflash._norm_weights("ln", C + 8, "cpu", bf, bf)


def test_plain_runs_only_for_cpu_tensors():
    """A wrapper takes its plain version only for a CPU tensor: any other
    device gets the kernel or an error, never the plain math, and a plain
    run launches nothing."""
    before = tflash.launch_counts()
    x = torch.ones(4, 8, device="meta")
    with pytest.raises(ValueError):
        tflash.layer_norm_fused(x, torch.ones(8), torch.zeros(8), 1e-6)
    with pytest.raises(ValueError):
        tflash.rms_norm_fused(x, torch.ones(8), 1e-6)
    q = torch.ones(1, 1, 16, 8, device="meta")
    with pytest.raises(ValueError):
        tflash.flash_causal_attention(q, q, q)
    with pytest.raises(ValueError):
        tflash.flash_relpos_attention(q, q, q, torch.zeros(4, 4, 8),
                                      torch.zeros(4, 4, 8), (4, 4))
    tflash.layer_norm_fused(torch.ones(4, 8), torch.ones(8), torch.zeros(8),
                            1e-6)
    assert tflash.launch_counts() == before
