"""The port's fused encoder path against the JAX package's accelerator
default, on the CPU.

The JAX side runs this slice's configuration (ANYREF_FUSED_WINDOW_BLOCK=1
ANYREF_FUSED_GLOBAL_BLOCK=1 ANYREF_FUSED_SPLIT=1 ANYREF_QKV_MHA_KERNEL=1
ANYREF_QKV_WINDOW_KERNEL=0), its Pallas kernels in interpret mode; the port
runs encoder_path="fused", whose wrappers take their plain versions on CPU
tensors (chip_smoke.py holds the CUDA kernels against the same plain
versions on the card).

Tolerances: atol = rtol = 3e-4 in fp32, the reference's own for these
kernels (GEMMs of a few hundred terms summed in different orders; a wrong
mask, bias or index is O(1)); 2e-2 in bf16, where one rounding of a
rounding point (qkv, attention output, GELU hidden) to the other side is
one ulp, 2^-8 relative. Windows are compared on their valid rows: pad rows
hold path-dependent values that are never read.

At anyref_tiny() both fused SAM gates are shut (ws^2 = 16 < 64, L = 256 <
1024), so the encoder and generate tests run a fused-gate config: anyref_tiny
with a 512-pixel SAM image (32 x 32 grid, L = 1024) and windows of 8.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import clip_vit as jclip
from anyref_tpu.models import sam as jsam
from anyref_tpu.models.sam import image_encoder as jenc
from anyref_tpu.ops import flash as jflash
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.models import clip_vit as tclip
from anyref_tpu_torch.models import sam as tsam
from anyref_tpu_torch.ops import flash as tflash
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

TINY = anyref_tiny()
CFG = dataclasses.replace(TINY, sam=dataclasses.replace(
    TINY.sam, image_size=512, window_size=8))
SLICE_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "1", "ANYREF_FUSED_GLOBAL_BLOCK": "1",
             "ANYREF_FUSED_SPLIT": "1", "ANYREF_QKV_MHA_KERNEL": "1",
             "ANYREF_QKV_WINDOW_KERNEL": "0"}
DTYPES = {"float32": 3e-4, "bfloat16": 2e-2}
MNT = 6
BUCKET = 257


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name, value in SLICE_ENV.items():
        monkeypatch.setenv(name, value)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(rng, dtype, **shapes):
    """Random leaves as numpy arrays of ``dtype``: linear {"w", "b"} for a
    (in, out) pair, LayerNorm {"scale", "bias"} for an int."""
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, int):
            out[name] = {"scale": 1 + 0.1 * rng.standard_normal(shape),
                         "bias": 0.05 * rng.standard_normal(shape)}
        elif name.startswith("rel"):
            out[name] = 0.1 * rng.standard_normal(shape)
        else:
            i, o = shape
            out[name] = {"w": rng.standard_normal((i, o)) * i ** -0.5,
                         "b": 0.02 * rng.standard_normal(o)}
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32).astype(jnp.dtype(dtype)), out)


def _both(tree):
    """The same leaves as JAX arrays and as CPU tensors."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tparams.from_numpy(tree, device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# each wrapper's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_window_attn_matches_pallas(dtype):
    """C 128, 4 heads of 32, ws 8 on a 20 x 20 grid: padded to 24, so the
    right and bottom windows overhang and the pad mask matters."""
    ws, nh, C, H, W, B = 8, 4, 128, 20, 20, 2
    hd = C // nh
    rng = np.random.default_rng(5)
    p = _tree(rng, dtype, norm1=C, qkv=(C, 3 * C), proj=(C, C),
              rel_pos_h=(2 * ws - 1, hd), rel_pos_w=(2 * ws - 1, hd))
    x = (rng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    xw, pad_hw = jenc._window_partition(jx, ws)
    mask = np.asarray(jenc._window_partition(
        jnp.ones((B, H, W, 1), jnp.float32), ws)[0]).reshape(-1, ws * ws, 1)
    nwc = pad_hw[1] // ws
    xw = xw.reshape(-1, ws * ws, C)
    jp, tp = _both(p)
    tht = jenc._get_rel_pos_table(ws, jp["rel_pos_h"]).reshape(ws * ws, -1)
    twt = jenc._get_rel_pos_table(ws, jp["rel_pos_w"]).reshape(ws * ws, -1)
    want = jflash.fused_window_attn(xw, jp["norm1"], jp["qkv"], tht, twt,
                                    jp["proj"], (ws, ws), nh, (H, W), nwc,
                                    1e-6, interpret=True)
    t = tparams.from_numpy
    got = tflash.fused_window_attn(
        t(np.asarray(xw), "cpu"), tp["norm1"], tp["qkv"],
        t(np.asarray(tht), "cpu"), t(np.asarray(twt), "cpu"), tp["proj"],
        (ws, ws), nh, (H, W), nwc, 1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got) * mask, _np(want) * mask, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_mlp_stream_matches_pallas(dtype):
    """N = 700 rows: not a multiple of any block of either side."""
    C = 128
    rng = np.random.default_rng(6)
    p = _tree(rng, dtype, norm2=C, lin1=(C, 4 * C), lin2=(4 * C, C))
    x = (rng.standard_normal((700, C)) * 0.7).astype(jnp.dtype(dtype))
    jp, tp = _both(p)
    want = jflash.fused_mlp_stream(jnp.asarray(x), jp["norm2"], jp["lin1"],
                                   jp["lin2"], 1e-6, interpret=True)
    got = tflash.fused_mlp_stream(tparams.from_numpy(x, "cpu"), tp["norm2"],
                                  tp["lin1"], tp["lin2"], 1e-6)
    _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,W", [(32, 32), (16, 64)])
def test_fused_global_tail_matches_pallas(dtype, H, W):
    """2 heads of 32; the non-square grid catches a swap of the row and
    column factors that a square grid hides."""
    nh, hd, B = 2, 32, 2
    C = nh * hd
    rng = np.random.default_rng(17)
    p = _tree(rng, dtype, proj=(C, C), norm2=C, lin1=(C, 4 * C),
              lin2=(4 * C, C), rel_pos_h=(2 * H - 1, hd),
              rel_pos_w=(2 * W - 1, hd))
    x = (rng.standard_normal((B, H * W, C)) * 0.5).astype(jnp.dtype(dtype))
    qkv = (rng.standard_normal((B, H * W, 3 * C)) * 0.5).astype(
        jnp.dtype(dtype))
    jp, tp = _both(p)
    tht = jenc._get_rel_pos_table(H, jp["rel_pos_h"])
    twt = jenc._get_rel_pos_table(W, jp["rel_pos_w"])
    want = jflash.fused_global_tail(
        jnp.asarray(x), jnp.asarray(qkv), tht, twt, jp["proj"], jp["norm2"],
        jp["lin1"], jp["lin2"], (H, W), nh, 1e-6, interpret=True)
    t = tparams.from_numpy
    got = tflash.fused_global_tail(
        t(x, "cpu"), t(qkv, "cpu"), t(np.asarray(tht), "cpu"),
        t(np.asarray(twt), "cpu"), tp["proj"], tp["norm2"], tp["lin1"],
        tp["lin2"], (H, W), nh, 1e-6)
    _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_layer_norm_rows_plain_matches_reference_h(x_dtype, masked):
    """The plain version of the fused layers' LayerNorm row pass (the CUDA
    GEMMs' A) against the reference's h (anyref_tpu flash.py
    _fused_window_attn_kernel: fp32 moments, LN, times the pad mask,
    rounded to bf16), computed in jnp from the same numpy rows: windows of
    8 over a 20 x 20 grid (padded to 24: the right and bottom windows
    overhang), C 128, bf16 rows (LN1, LN2 of the split pair) or fp32 rows
    (the residual x1 of fused_window_block and fused_global_tail), with
    and without the mask. Tolerance: one bf16 ulp, 2^-8 relative, on
    either side (atol = rtol = 2^-7): both round the same fp32 values,
    whose moments differ only in summation order."""
    ws, C, H, W, B, eps = 8, 128, 20, 20, 2, 1e-6
    rng = np.random.default_rng(31)
    img = (rng.standard_normal((B, H, W, C)) * 1.5 + 0.3).astype(np.float32)
    xw, pad_hw = jenc._window_partition(
        jnp.asarray(img, jnp.dtype(x_dtype)), ws)
    x = np.asarray(jnp.asarray(xw, jnp.float32)).reshape(-1, C).astype(
        jnp.dtype(x_dtype))
    mask = np.asarray(jenc._window_partition(
        jnp.ones((B, H, W, 1), jnp.float32), ws)[0]).reshape(-1, 1)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.05 * rng.standard_normal(C)).astype(np.float32)
    x3 = jnp.asarray(x, jnp.float32)
    mean = jnp.mean(x3, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x3 - mean), axis=-1, keepdims=True)
    h = (x3 - mean) * jax.lax.rsqrt(var + eps) * scale + bias
    if masked:
        h = h * mask
    want = h.astype(jnp.bfloat16)
    t = tparams.from_numpy
    nwc = pad_hw[1] // ws
    keep = tflash.window_pad_mask(x.shape[0] // (ws * ws), ws * ws, ws, nwc,
                                  -(-H // ws) * nwc, (H, W), "cpu")
    assert np.array_equal(_np(keep).reshape(-1, 1), mask)
    got = tflash.layer_norm_rows_plain(
        t(x, "cpu"), torch.from_numpy(scale), torch.from_numpy(bias), eps,
        keep.reshape(-1, 1) if masked else None)
    assert got.dtype == torch.bfloat16
    if masked:
        assert not _np(got)[mask[:, 0] == 0].any()
    _close(got, want, 2.0 ** -7)


def test_kernel_sources_are_listed():
    """The build compiles SOURCES and hashes HEADERS: every listed file
    exists, every csrc file is listed, and the deleted mma.sync attention
    core (attention.cuh, qkv_attention.cu) is named by neither."""
    listed = set(tflash.SOURCES) | set(tflash.HEADERS)
    assert not listed & {"attention.cuh", "qkv_attention.cu"}
    assert all((tflash.CSRC / name).is_file() for name in listed)
    on_disk = {p.name for p in tflash.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    assert on_disk == listed
    assert set(tflash.SOURCES) == {n for n in on_disk if n.endswith(".cu")}


@pytest.mark.parametrize("dtype,B,L,nh,hd", [
    *(pytest.param(d, 2, 257, 4, 64, id=d) for d in DTYPES),
    *(pytest.param(d, 2, 77, 4, 36, id=f"odd-hd36-{d}") for d in DTYPES)])
def test_flash_attention_qkv_matches_pallas(dtype, B, L, nh, hd):
    """CLIP's L = 257 (odd, no tile multiple), 4 heads of 64; L = 77 with
    heads of 36 (the CUDA kernel's zero-padded route)."""
    rng = np.random.default_rng(21)
    qkv = (rng.standard_normal((B, L, 3 * nh * hd)) * 0.3).astype(
        jnp.dtype(dtype))
    want = jflash.flash_attention_qkv(jnp.asarray(qkv), nh, interpret=True)
    got = tflash.flash_attention_qkv(tparams.from_numpy(qkv, "cpu"), nh)
    _close(got, want, DTYPES[dtype])


def test_new_wrappers_take_plain_only_for_cpu_tensors():
    """On any other device than the CPU a wrapper launches its kernels or
    raises; a plain run launches nothing."""
    before = tflash.launch_counts()
    C, meta = 64, torch.device("meta")
    lin = {"w": torch.ones(C, C, device=meta), "b": torch.zeros(C)}
    ln = {"scale": torch.ones(C), "bias": torch.zeros(C)}
    x = torch.ones(4, 64, C, device=meta)
    tab = torch.zeros(64, C // 2)
    with pytest.raises(ValueError):
        tflash.fused_window_attn(x, ln, lin, tab, tab, lin, (8, 8), 2,
                                 (8, 8), 1, 1e-6)
    with pytest.raises(ValueError):
        tflash.fused_mlp_stream(x[0], ln, lin, lin, 1e-6)
    with pytest.raises(ValueError):
        tflash.fused_global_tail(x, x, tab, tab, lin, ln, lin, lin, (8, 8),
                                 2, 1e-6)
    with pytest.raises(ValueError):
        tflash.flash_attention_qkv(torch.ones(1, 9, 3 * C, device=meta), 2)
    tflash.flash_attention_qkv(torch.ones(1, 9, 3 * C), 2)
    assert tflash.launch_counts() == before


# ---------------------------------------------------------------------------
# the towers and generate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jp():
    """The JAX init at the fused-gate config, with random rel-pos tables,
    biases and LayerNorms in the SAM encoder (the init leaves them zero or
    one, which would hide a misplaced bias)."""
    p = janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)
    rng = np.random.default_rng(3)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "rel_pos" in name or name.endswith("['b']") or \
                name.endswith("['bias']"):
            return a + jnp.asarray(
                0.1 * rng.standard_normal(a.shape), a.dtype)
        if name.endswith("['scale']"):
            return a + jnp.asarray(
                0.1 * rng.standard_normal(a.shape), a.dtype)
        return a
    enc = jax.tree_util.tree_map_with_path(perturb,
                                           p["sam"]["image_encoder"])
    p["sam"] = dict(p["sam"], image_encoder=enc)
    return p


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


def test_fused_config_needs_no_new_leaves():
    """params.init at the fused-gate config makes the reference init's tree:
    the fused path reads the same leaves as the unfused one."""
    want = jax.eval_shape(lambda k: janyref.init(k, CFG, jnp.bfloat16),
                          jax.random.key(0))
    got = tparams.init(CFG, torch.Generator().manual_seed(0), torch.bfloat16,
                       device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    assert all(tuple(a.shape) == tuple(b.shape)
               for (_, a), (_, b) in zip(jl, tl))


def test_sam_encoder_fused_matches_jax(jp, tp):
    """One window layer (16 windows of 8 x 8 per image) and one global
    layer (32 x 32): both through the fused layers on both sides."""
    x = np.random.default_rng(2).standard_normal(
        (2, 3, CFG.sam.image_size, CFG.sam.image_size)).astype(np.float32)
    want = jsam.encode_image(jp["sam"], jnp.asarray(x), CFG.sam)
    got = tsam.encode_image(tp["sam"], torch.from_numpy(x), CFG.sam,
                            encoder_path="fused")
    assert got.shape == (2, CFG.sam.prompt_embed_dim, 32, 32)
    _close(got, want, DTYPES["float32"])


def test_clip_fused_matches_jax(jp, tp):
    """CLIP attention through the QKV-direct kernel on both sides."""
    px = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    want = jclip.apply_patch_features(jp["clip"], jnp.asarray(px), CFG.clip)
    got = tclip.apply_patch_features(tp["clip"], torch.from_numpy(px),
                                     CFG.clip, encoder_path="fused")
    _close(got, want, 1e-4)


def test_fused_path_takes_the_fused_kernels(tp, monkeypatch):
    """One encode of each tower reaches each fused plain version the
    expected number of times on the fused path, and none on the unfused
    path (which reaches the rel-pos attention instead)."""
    names = ("fused_window_attn_plain", "fused_mlp_stream_plain",
             "fused_global_tail_plain", "attention_qkv_plain",
             "relpos_attention_plain")
    counts = dict.fromkeys(names, 0)

    def counted(name):
        fn = getattr(tflash, name)

        def wrapper(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapper
    for name in names:
        monkeypatch.setattr(tflash, name, counted(name))

    s, c = CFG.sam, CFG.clip
    n_global = len(s.encoder_global_attn_indexes)
    n_clip = c.num_layers + c.select_layer + 1
    x = torch.zeros(1, 3, s.image_size, s.image_size)
    px = torch.zeros(1, 3, 224, 224)
    for path, want in (
            ("fused", (s.encoder_depth - n_global, s.encoder_depth - n_global,
                       n_global, n_clip, 0)),
            ("unfused", (0, 0, 0, 0, s.encoder_depth))):
        counts.update(dict.fromkeys(names, 0))
        tsam.encode_image(tp["sam"], x, s, encoder_path=path)
        tclip.apply_patch_features(tp["clip"], px, c, encoder_path=path)
        assert tuple(counts[n] for n in names) == want, (path, counts)
    with pytest.raises(ValueError):
        tsam.encode_image(tp["sam"], x, s, encoder_path="fast")


def test_generate_fused_matches_jax(jp, tp):
    """generate at the fused-gate config: greedy ids equal to the JAX ids,
    masks within the tolerance of tests/test_torch_generate.py."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    texts = ("the cat", "the red cat on the red mat near the open door")
    ds = SegDataset(CFG)
    batch = Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, texts)])
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(batch["prompt_lens"][b])
        ids[b, BUCKET - n:] = batch["input_ids"][b, :n]
    inputs = {"input_ids": ids, "clip_images": batch["clip_images"],
              "sam_images": batch["sam_images"]}
    want = jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT),
                   static_argnums=(1,))(
        jp, CFG, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tanyref.generate(tp, CFG, inputs, max_new_tokens=MNT,
                           device="cpu", encoder_path="fused")
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    np.testing.assert_allclose(got.low_res_masks.numpy(),
                               np.asarray(want.low_res_masks),
                               atol=2e-2, rtol=2e-2)
