"""Port modules against the JAX package at anyref_tiny(), fp32, with the JAX
weights bridged by anyref_tpu_torch.params.from_numpy.

The JAX side runs the unfused configuration (the four switches below), so
its Pallas kernels (relpos global layer, causal prefill, RMSNorm) run in
interpret mode and everything else as XLA; the port runs the same path,
encoder_path="unfused" (tests/test_torch_fused.py holds the fused one).
Tolerance: atol = rtol = 1e-4 in fp32 (several layers summed in different
orders; a wrong mask, layout or index is O(1))."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import clip_vit as jclip
from anyref_tpu.models import llama as jllama
from anyref_tpu.models import sam as jsam
from anyref_tpu_torch.models import clip_vit as tclip
from anyref_tpu_torch.models import llama as tllama
from anyref_tpu_torch.models import sam as tsam
from anyref_tpu_torch import params as tparams

CFG = anyref_tiny()
TOL = {"atol": 1e-4, "rtol": 1e-4}
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_init_tree_matches_reference():
    """params.init makes the reference init's tree: same keys, list
    lengths, shapes and dtypes."""
    want = jax.eval_shape(lambda k: janyref.init(k, CFG, jnp.bfloat16),
                          jax.random.key(0))
    got = tparams.init(CFG, torch.Generator().manual_seed(0), torch.bfloat16,
                       device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), \
            jax.tree_util.keystr(path)


def test_clip_patch_features(jp, tp):
    px = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    want = jclip.apply_patch_features(jp["clip"], jnp.asarray(px), CFG.clip)
    got = tclip.apply_patch_features(tp["clip"], torch.from_numpy(px),
                                     CFG.clip, encoder_path="unfused")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_llama_prefill_decode_and_chunk(jp, tp):
    """Left-padded prefill (causal kernel + RMSNorm kernel), then a decode
    step and a 4-token verify chunk on the cache: hidden states and the
    whole stacked cache agree after each."""
    c = CFG.llama
    rng = np.random.default_rng(1)
    B, L, cap = 2, 384, 400
    pad = np.asarray([0, 37], np.int32)
    emb = rng.standard_normal((B, L, c.hidden_size)).astype(np.float32)
    jc = jllama.init_cache(c, B, cap, jnp.float32)
    tc = tllama.init_cache(c, B, cap, torch.float32, device="cpu")
    jpad, tpad = jnp.asarray(pad), torch.from_numpy(pad).long()
    jh, jc = jllama.prefill(jp["llama"], c, jnp.asarray(emb), jc,
                            pad_len=jpad)
    th, tc = tllama.prefill(tp["llama"], c, torch.from_numpy(emb), tc,
                            pad_len=tpad)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **TOL)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), **TOL)

    step = rng.standard_normal((B, 1, c.hidden_size)).astype(np.float32)
    jh, jc = jllama.decode_step(jp["llama"], c, jnp.asarray(step),
                                jnp.int32(L), jc, pad_len=jpad)
    th, tc = tllama.decode_step(tp["llama"], c, torch.from_numpy(step), L,
                                tc, pad_len=tpad)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)

    chunk = rng.standard_normal((B, 4, c.hidden_size)).astype(np.float32)
    jh, jc = jllama.decode_chunk(jp["llama"], c, jnp.asarray(chunk),
                                 jnp.int32(L + 1), jc, pad_len=jpad)
    th, tc = tllama.decode_chunk(tp["llama"], c, torch.from_numpy(chunk),
                                 L + 1, tc, pad_len=tpad)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tc.k), _np(jc.k), **TOL)
    np.testing.assert_allclose(_np(tc.v), _np(jc.v), **TOL)
    np.testing.assert_allclose(_np(tllama.logits(tp["llama"], th)),
                               _np(jllama.logits(jp["llama"], jh)), **TOL)


def test_sam_image_encoder(jp, tp):
    """The tiny encoder runs one windowed layer (4x4 windows, padded
    16 -> 16) and one global layer, then the fp32 neck."""
    x = np.random.default_rng(2).standard_normal(
        (2, 3, CFG.sam.image_size, CFG.sam.image_size)).astype(np.float32)
    want = jsam.encode_image(jp["sam"], jnp.asarray(x), CFG.sam)
    got = tsam.encode_image(tp["sam"], torch.from_numpy(x), CFG.sam,
                            encoder_path="unfused")
    assert got.shape == (2, CFG.sam.prompt_embed_dim,
                         CFG.sam.embedding_size, CFG.sam.embedding_size)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_sam_window_padding(jp, tp):
    """A window grid that does not divide the image (ws 6 on a 16 grid)
    exercises the zero pad and the pad re-mask after LN1."""
    import dataclasses
    cfg = dataclasses.replace(CFG.sam, window_size=6,
                              encoder_global_attn_indexes=())
    sp = jax.tree_util.tree_map(lambda a: a, jp["sam"])
    rng = np.random.default_rng(5)
    for blk in sp["image_encoder"]["blocks"]:
        hd = blk["attn"]["rel_pos_h"].shape[1]
        blk["attn"]["rel_pos_h"] = jnp.asarray(
            rng.standard_normal((11, hd)).astype(np.float32) * 0.1)
        blk["attn"]["rel_pos_w"] = jnp.asarray(
            rng.standard_normal((11, hd)).astype(np.float32) * 0.1)
    x = rng.standard_normal((1, 3, cfg.image_size,
                             cfg.image_size)).astype(np.float32)
    want = jsam.encode_image(sp, jnp.asarray(x), cfg)
    got = tsam.encode_image(tparams.from_numpy(jax.device_get(sp), "cpu"),
                            torch.from_numpy(x), cfg, encoder_path="unfused")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_decode_text_prompts(jp, tp):
    """Prompt encoder + two-way transformer + mask decoder on fixed [SEG]
    embeddings (random tiny weights rarely emit [SEG] by themselves)."""
    rng = np.random.default_rng(3)
    s = CFG.sam
    emb = rng.standard_normal((2, s.prompt_embed_dim, s.embedding_size,
                               s.embedding_size)).astype(np.float32)
    pred = rng.standard_normal((3, s.prompt_embed_dim)).astype(np.float32)
    idx = np.asarray([0, 1, 1], np.int32)
    jm, ji = jsam.decode_text_prompts(jp["sam"], s, jnp.asarray(emb),
                                      jnp.asarray(pred), jnp.asarray(idx))
    tm, ti = tsam.decode_text_prompts(tp["sam"], s, torch.from_numpy(emb),
                                      torch.from_numpy(pred),
                                      torch.from_numpy(idx).long())
    assert tm.shape == (3, 1, 4 * s.embedding_size, 4 * s.embedding_size)
    np.testing.assert_allclose(_np(tm), _np(jm), **TOL)
    np.testing.assert_allclose(_np(ti), _np(ji), **TOL)
