"""The port's training path against the JAX package's, on the CPU at
anyref_tiny().

The JAX side runs the fused configuration of tests/test_torch_fused.py
(ANYREF_FUSED_WINDOW_BLOCK=1 ANYREF_FUSED_GLOBAL_BLOCK=1 ANYREF_FUSED_SPLIT=1
ANYREF_QKV_MHA_KERNEL=1 ANYREF_QKV_WINDOW_KERNEL=0; at anyref_tiny() both
fused SAM gates are shut, so SAM runs its unfused blocks on both sides), its
Pallas kernels in interpret mode; the port runs encoder_path="fused", whose
wrappers take their plain versions on CPU tensors (chip_smoke.py holds the
CUDA kernels against the same plain versions on the card). Weights are the
JAX init bridged by params.from_numpy; inputs come from numpy seeds.

Tolerances, each with its reason:
- kernels' plain versions in fp32: atol = rtol = 1e-5 for the forward and
  LSE, 1e-4 for the gradients (sums of a few hundred fp32 terms in another
  order; a wrong mask or scale is O(1));
- loss terms: 1e-3 relative; gradients: 2e-2 of each leaf's largest
  magnitude. The decoder runs bf16 activations on both sides, and one bf16
  rounding falling the other way is 2^-8 relative;
- optimizer: rtol 1e-5 (the same fp32 arithmetic in another library).
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from anyref_tpu.config import anyref_tiny
from anyref_tpu.data import collator as jcollator
from anyref_tpu.data import loader as jloader
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import llama as jllama
from anyref_tpu.ops import attention as jattention
from anyref_tpu.ops import flash as jflash
from anyref_tpu.ops import losses as jlosses
from anyref_tpu.ops import resize as jresize
from anyref_tpu.train import lora as jlora
from anyref_tpu.train import step as jstep
from anyref_tpu_torch import checkpoint as tckpt
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.data.loader import DataLoader
from anyref_tpu_torch.models import llama as tllama
from anyref_tpu_torch.ops import attention as tattention
from anyref_tpu_torch.ops import flash as tflash
from anyref_tpu_torch.ops import losses as tlosses
from anyref_tpu_torch.ops import resize as tresize
from anyref_tpu_torch.tokenizer import (AnyRefTokenizer, seg_answer,
                                        seg_question, tokenize_conversation)
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = anyref_tiny()
SLICE_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "1", "ANYREF_FUSED_GLOBAL_BLOCK": "1",
             "ANYREF_FUSED_SPLIT": "1", "ANYREF_QKV_MHA_KERNEL": "1",
             "ANYREF_QKV_WINDOW_KERNEL": "0"}
PHRASES = ("a cat", "a dog", "a rat", "a pig")
LCFG = jlora.LoraConfig()
TCFG = tlora.LoraConfig()


@contextlib.contextmanager
def slice_env():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SLICE_ENV.items():
            mp.setenv(name, value)
        yield


@pytest.fixture(autouse=True)
def slice_config():
    with slice_env():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _samples(phrases, seed=0):
    """Collator-ready samples: images whose shortest edge is 224 (no PIL
    resize), SAM frames padded on the right or the bottom, one rectangle
    mask each."""
    rng = np.random.default_rng(seed)
    ds = SegDataset(CFG)
    out = []
    for i, text in enumerate(phrases):
        h, w = ((224, 300), (280, 224))[i % 2]
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4:h // 2 + i * 9, w // 5:w // 2 + i * 7] = 1
        out.append(ds.make_sample(rng.integers(0, 256, (h, w, 3), np.uint8),
                                  seg_question(text), seg_answer(text),
                                  mask[None], file_name=f"{i}.jpg"))
    return out


def _tree_pairs(got, want, path=""):
    """(path, port tensor, JAX array) leaf pairs of two trees of the same
    structure; None positions skipped."""
    if want is None:
        assert got is None, path
        return []
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [p for k in want for p in _tree_pairs(got[k], want[k],
                                                     f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in _tree_pairs(g, w, f"{path}/{i}")]
    return [(path, got, want)]


# ---------------------------------------------------------------------------
# (a) the kernel's plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,kv_start,hd",
                         [(256, (0, 50), 32), (200, None, 32),
                          (256, (0, 50), 128), (200, None, 128)],
                         ids=["L256-kvstart", "L200", "hd128-L256-kvstart",
                              "hd128-L200"])
def test_causal_diff_matches_jax_vjp(L, kv_start, hd):
    """Forward and dq, dk, dv through causal_attention(differentiable=True)
    on both sides: the pad to a multiple of 128, the kernel (its plain
    version here) and the slice. The cotangent of the left-pad rows is
    zeroed, as tests/test_flash.py does (those rows have no gradient).
    Heads of 32 (anyref_tiny) and of 128 (anyref_7b, the width the CUDA
    kernels are built for)."""
    B, nh = 2, 2
    rng = np.random.default_rng(5)
    q, k, v = ((rng.standard_normal((B, nh, L, hd)) * 0.3).astype(np.float32)
               for _ in range(3))
    ct = rng.standard_normal((B, nh, L, hd)).astype(np.float32)
    ks = None if kv_start is None else np.asarray(kv_start, np.int32)
    if ks is not None:
        ct = np.where(np.arange(L)[None, None, :, None]
                      < ks[:, None, None, None], 0.0, ct).astype(np.float32)
    jks = None if ks is None else jnp.asarray(ks)

    def jfwd(q_, k_, v_):
        return jattention.causal_attention(q_, k_, v_, kv_start=jks,
                                           use_flash=True,
                                           differentiable=True)
    jout, vjp = jax.vjp(jfwd, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(ct))

    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tout = tattention.causal_attention(tq, tk, tv, kv_start=None if ks is None
                                       else _t(ks), differentiable=True)
    tout.backward(_t(ct))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{name} L={L}")


def test_causal_diff_lse_matches_jax():
    """The forward's log-sum-exp, fully masked left-pad rows included
    (-float32.max + log(L), which is -float32.max in fp32)."""
    B, nh, L, hd = 2, 2, 256, 32
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((B, nh, L, hd)).astype(np.float32)
               for _ in range(3))
    ks = np.asarray([0, 70], np.int32)
    pad = jnp.repeat(jnp.asarray(ks), nh)
    jo, jlse = jflash._flash_causal_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                        pad, True)
    to, tlse = tflash.causal_attention_diff_fwd_plain(_t(q), _t(k), _t(v),
                                                      _t(ks))
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse).reshape(
        B, nh, L), atol=1e-5, rtol=1e-5)
    assert np.isfinite(tlse.numpy()).all()


def test_causal_diff_wrapper_plain_only_on_cpu():
    """A CUDA-less device gets an error, never the plain math; a plain run
    counts no launch in either direction."""
    f = tflash.flash_causal_attention_diff
    before = tflash.launch_counts()
    with pytest.raises(ValueError):
        f(*(torch.ones(1, 1, 128, 32, device="meta") for _ in range(3)))
    q = torch.randn(1, 2, 128, 32, requires_grad=True)
    f(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert tflash.launch_counts() == before
    assert f in tflash.KERNELS


def test_chip_check_of_the_training_attention_rejects_a_dropped_tile():
    """chip_smoke.py's limits for the training attention's output and
    gradients, with the plain versions standing in for the kernel: the
    plain result passes them; dropping one tile (the last 32 of 256 values
    from o, the last 32 keys from dq, the last 32 queries from dk and dv)
    fails both the element limit and the relative L2 limit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    g = torch.Generator().manual_seed(0)
    q, k, v = ((torch.randn(1, 4, 256, 128, generator=g) * 0.5).bfloat16()
               for _ in range(3))
    do = torch.randn(1, 4, 256, 128, generator=g).bfloat16()
    o, lse = tflash.causal_attention_diff_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    want = (tflash.causal_attention_dq_plain(q, k, v, do, lse, delta),
            *tflash.causal_attention_dkv_plain(q, k, v, do, lse, delta))
    terms = cs.term_sizes(torch, tflash, q, k, v, do, o, lse, None)
    keep = torch.ones(256, 1)
    keep[-32:] = 0
    k_cut, do_cut = (t.float().mul(keep).bfloat16() for t in (k, do))
    cut = (tflash.causal_attention_dq_plain(q, k_cut, v, do, lse, delta),
           *tflash.causal_attention_dkv_plain(q, k, v, do_cut, lse, delta))
    v_cut = v.float().mul(keep).bfloat16()
    want = (o, *want)
    cut = (tflash.causal_attention_diff_fwd_plain(q, k, v_cut)[0], *cut)
    for name, w, c in zip(("o", "dq", "dk", "dv"), want, cut):
        t = terms[name]
        assert cs.diff_errors(w, w, t)[1:] == (0.0, 0), name
        _, rel_l2, bad = cs.diff_errors(c, w, t)
        assert bad > 1000 and rel_l2 > cs.DIFF_REL_L2, (name, bad, rel_l2)


# ---------------------------------------------------------------------------
# (b) losses, the differentiable resize and the decoder's training forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dice_loss", "sigmoid_ce_loss",
                                  "lm_cross_entropy"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(8)
    if name == "lm_cross_entropy":
        logits = rng.standard_normal((2, 12, 50)).astype(np.float32) * 3
        labels = rng.integers(0, 50, (2, 12)).astype(np.int32)
        labels[:, :5] = -100
        args = (logits, labels)
    else:
        pred = rng.standard_normal((4, 16, 16)).astype(np.float32) * 4
        gt = (rng.random((4, 16, 16)) > 0.6).astype(np.float32)
        valid = np.asarray([True, False, True, True])
        px = np.zeros((4, 16, 16), bool)
        px[:, :12, :9] = True
        args = (pred, gt, valid, px)
    want = getattr(jlosses, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tlosses, name)(*(_t(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_upscale_masks_matches_jax_and_differentiates():
    """resize_bilinear (the dense fp32 weight-matrix form) 16 x 16 -> 37 x
    64 and 256 x 256 -> image_size, with a gradient equal to JAX's."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, 16, 16)).astype(np.float32)
    ct = rng.standard_normal((3, 1, 37, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jresize.resize_bilinear(a, 37, 64),
                        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tresize.resize_bilinear(tx, 37, 64)
    got.backward(_t(ct))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(vjp(
        jnp.asarray(ct))[0]), atol=1e-5, rtol=1e-5)
    from anyref_tpu.models import sam as jsam
    from anyref_tpu_torch.models import sam as tsam
    low = rng.standard_normal((2, 1, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tsam.upscale_masks(_t(low), CFG.sam)),
        np.asarray(jsam.upscale_masks(jnp.asarray(low), CFG.sam)),
        atol=1e-5, rtol=1e-5)


def test_llama_forward_matches_jax(jp, tp):
    """The decoder's training forward alone (no cache, differentiable
    attention, plain norms), bf16 activations, with the input to the last
    layer, within 2e-2 of the largest magnitude; remat gives the same
    values."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((2, 200, CFG.llama.hidden_size)) * 0.5).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, want_last = jllama.forward(jp["llama"], CFG.llama, jx,
                                     return_last_input=True)
    tx = _t(x).to(torch.bfloat16)
    for remat in (False, True):
        got, got_last = tllama.forward(tp["llama"], CFG.llama, tx,
                                       return_last_input=True, remat=remat)
        for g, w in ((got, want), (got_last, want_last)):
            w = _np(w)
            np.testing.assert_allclose(_np(g), w, rtol=0,
                                       atol=2e-2 * np.abs(w).max())


def test_llama_forward_positions_and_kv_len_match_jax(jp, tp):
    """The training forward's other options: per-row positions [B, L]
    (shifted RoPE) and kv_len [B] (trailing keys masked, plain attention on
    both sides), within 2e-2 of the largest magnitude."""
    rng = np.random.default_rng(11)
    B, L = 2, 160
    x = (rng.standard_normal((B, L, CFG.llama.hidden_size)) * 0.5).astype(
        np.float32)
    pos = (np.arange(L)[None] + np.asarray([[0], [7]])).astype(np.int32)
    kv_len = np.asarray([L, 110], np.int32)
    want = _np(jllama.forward(jp["llama"], CFG.llama,
                              jnp.asarray(x, jnp.bfloat16),
                              positions=jnp.asarray(pos),
                              kv_len=jnp.asarray(kv_len)))
    got = tllama.forward(tp["llama"], CFG.llama, _t(x).to(torch.bfloat16),
                         positions=_t(pos), kv_len=_t(kv_len))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# (c) tokenization and the collator in train mode
# ---------------------------------------------------------------------------
def test_tokenize_conversation_matches_jax():
    from anyref_tpu import tokenizer as jtok
    for text in ("the cat", "the red cat on the mat, left of the dog"):
        want = jtok.tokenize_conversation(jtok.AnyRefTokenizer(),
                                          seg_question(text),
                                          jtok.seg_answer(text))
        got = tokenize_conversation(AnyRefTokenizer(), seg_question(text),
                                    seg_answer(text))
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.prompt_len == want.prompt_len
        assert seg_answer(text, itisseg=True) == jtok.seg_answer(text, True)


def test_collator_train_matches_jax():
    from anyref_tpu.tokenizer import AnyRefTokenizer as JTok
    insts = _samples(PHRASES[:2] + ("the red cat on the mat",))
    want = jcollator.Collator(JTok(), CFG, train=True)(insts)
    got = Collator(AnyRefTokenizer(), CFG, train=True)(insts)
    for key in ("input_ids", "labels", "prompt_lens", "sam_resized_sizes",
                "gt_masks", "mask_valid", "clip_images", "sam_images"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["gt_masks"].shape == (3, CFG.max_seg_per_sample,
                                     CFG.sam.image_size, CFG.sam.image_size)
    assert got["mask_valid"].sum() == 3
    prompt = Collator(AnyRefTokenizer(), CFG)(insts)
    assert "labels" not in prompt and "gt_masks" not in prompt


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_matches_jax(workers):
    """Same batches in the same order as the JAX loader, epoch after epoch
    (seeded shuffle), threaded or not."""
    data = list(range(23))

    def collate(b):
        return list(b)
    want = jloader.DataLoader(data, collate, batch_size=4, shuffle=True,
                              num_workers=workers, seed=3, drop_last=True)
    got = DataLoader(data, collate, batch_size=4, shuffle=True,
                     num_workers=workers, seed=3, drop_last=True)
    assert len(got) == len(want) == 5
    for _ in range(2):
        assert list(got) == list(want)


# ---------------------------------------------------------------------------
# (d) train_forward: loss terms and the gradients of every trainable leaf
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def batch():
    col = Collator(AnyRefTokenizer(), CFG, train=True)
    return tstep.device_batch(col(_samples(PHRASES[:2])))


@pytest.fixture(scope="module")
def jlora_params(jp):
    """JAX LoRA init with B set to small random values: with B = 0 the
    gradient of A is zero and would hide a wrong fold."""
    lp = jlora.init(jax.random.key(1), jp["llama"], LCFG)
    rng = np.random.default_rng(11)
    for layer in lp["layers"]:
        for t in layer.values():
            t["b"] = jnp.asarray(0.02 * rng.standard_normal(t["b"].shape),
                                 jnp.float32)
    return lp


@pytest.fixture(scope="module")
def jax_loss_grads(jp, jlora_params, batch):
    dense, frozen = jlora.split_trainable(jp)
    fn = jax.jit(jax.value_and_grad(jstep.loss_fn, argnums=(0, 1),
                                    has_aux=True), static_argnums=(3, 4))
    with slice_env():
        (_, metrics), grads = fn(jlora_params, dense, frozen, CFG, LCFG,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get(metrics), jax.device_get(grads)


def _port_state(tp, jlora_params):
    lora_p = tparams.from_numpy(jax.device_get(jlora_params), device="cpu")
    dense, frozen = tlora.split_trainable(tp)
    dense = tstep.tree_map(lambda t: t.detach().clone(), dense)
    for t in tstep.tree_leaves((lora_p, dense)):
        t.requires_grad_(True)
    return lora_p, dense, frozen


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_forward_grads_match_jax(tp, jlora_params, batch,
                                       jax_loss_grads, remat):
    jmetrics, (jg_lora, jg_dense) = jax_loss_grads
    lora_p, dense, frozen = _port_state(tp, jlora_params)
    _, metrics, (g_lora, g_dense) = tstep.value_and_grad(
        lora_p, dense, frozen, CFG, TCFG, batch, encoder_path="fused",
        remat=remat)
    for k in tstep.METRICS:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-3, err_msg=k)
    pairs = (_tree_pairs(g_lora, jg_lora, "lora")
             + _tree_pairs(g_dense, jg_dense, "dense"))
    assert len(pairs) == len(tstep.tree_leaves((lora_p, dense)))
    for path, got, want in pairs:
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=path)
    # the LoRA and mask-decoder leaves carry a gradient
    assert np.abs(_np(g_lora["layers"][0]["q"]["a"])).max() > 0
    assert np.abs(_np(g_dense["sam"]["mask_decoder"]["mask_tokens"])).max() > 0


def test_train_forward_text_only(tp, batch):
    """A text batch trains the same, bit for bit, when it also carries RoI
    and audio keys: its prompts have no <img_ref> or <audio_ref>
    placeholder, so nothing is spliced (the reference paths are held
    against JAX in tests/test_torch_references.py)."""
    from anyref_tpu_torch.models import anyref as tanyref
    B = batch["input_ids"].shape[0]
    a = CFG.audio
    refs = {"roi_boxes": np.full((B, 4), 0.5, np.float32),
            "ref_valid": np.ones((B,), bool),
            "audio_mels": np.ones((B, a.clips_per_audio, 1, a.mel_bins,
                                   a.target_len), np.float32),
            "audio_valid": np.ones((B,), bool)}
    with torch.no_grad():
        want = tanyref.train_forward(tp, CFG, batch)
        got = tanyref.train_forward(tp, CFG, {**batch, **refs})
    for name in ("loss", "lm_loss", "bce_loss", "dice_loss"):
        assert getattr(got, name).item() == getattr(want, name).item(), name


def test_train_forward_rephrase_grads_match_jax(jp, tp, jlora_params):
    """rephrase_weight=0.1 (the reference's eval setting): the [SEG] states
    gain the pooled answer span, and the loss and every trainable leaf's
    gradient (through the pooling too) match jax.value_and_grad of the JAX
    loss under the limits of test_train_forward_grads_match_jax, on a batch
    of all four phrases. (On the two-phrase batch of the other tests the
    mask-path leaves differ by 3% of their largest magnitude. There the
    mask-path gradient follows the bf16 rounding of the [SEG] embedding:
    JAX's own moves 2.7% between two compilations of its loss, one of them
    also returning the embedding, and taken at the port's embedding it is
    the port's to 1e-6, as
    test_train_forward_rephrase_grads_at_port_seg_embedding checks. The
    pooling's backward alone is held in fp32 by
    tests/test_torch_rephrase.py.)"""
    cfg = CFG.scaled(rephrase_weight=0.1)
    batch = tstep.device_batch(Collator(AnyRefTokenizer(), CFG, train=True)(
        _samples(PHRASES)))
    dense_j, frozen_j = jlora.split_trainable(jp)
    fn = jax.jit(jax.value_and_grad(jstep.loss_fn, argnums=(0, 1),
                                    has_aux=True), static_argnums=(3, 4))
    (_, jmetrics), (jg_lora, jg_dense) = fn(
        jlora_params, dense_j, frozen_j, cfg, LCFG,
        {k: jnp.asarray(v) for k, v in batch.items()})
    lora_p, dense, frozen = _port_state(tp, jlora_params)
    _, metrics, (g_lora, g_dense) = tstep.value_and_grad(
        lora_p, dense, frozen, cfg, TCFG, batch, encoder_path="fused")
    with torch.no_grad():
        _, plain = tstep.loss_fn(*_port_state(tp, jlora_params), CFG, TCFG,
                                 batch, "fused")
    for k in tstep.METRICS:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-3, err_msg=k)
    # the pooled term reaches the mask losses
    assert metrics["bce_loss"].item() != plain["bce_loss"].item()
    pairs = (_tree_pairs(g_lora, jg_lora, "lora")
             + _tree_pairs(g_dense, jg_dense, "dense"))
    assert len(pairs) == len(tstep.tree_leaves((lora_p, dense)))
    for path, got, want in pairs:
        want = np.asarray(jax.device_get(want), np.float32)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=path)


def test_train_forward_rephrase_grads_at_port_seg_embedding(
        jp, tp, jlora_params, batch):
    """The two-phrase batch at rephrase_weight=0.1, where the two packages'
    mask-path gradients differ by 3%: the JAX loss evaluated at the port's
    [SEG] embedding (project_seg_hidden's output moved by the difference of
    the two) gives the port's gradient to 1e-5 of each leaf's largest
    magnitude, for every leaf that sees the embedding and nothing of the
    bf16 decoder before it: the embedding itself, the trainable SAM leaves
    and text_hidden_fcs' biases."""
    from anyref_tpu_torch.models import anyref as tanyref
    cfg = CFG.scaled(rephrase_weight=0.1)
    B = np.asarray(batch["input_ids"]).shape[0]
    shape = (B, cfg.max_seg_per_sample, cfg.out_dim)
    dense_j, frozen_j = jlora.split_trainable(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jproject = janyref.project_seg_hidden

    def jloss(delta, dense):
        seen = []

        def moved(p, h):
            seen.append(jproject(p, h))
            return seen[-1] + delta
        janyref.project_seg_hidden = moved
        try:
            loss, _ = jstep.loss_fn(jlora_params, dense, frozen_j, cfg, LCFG,
                                    jb)
        finally:
            janyref.project_seg_hidden = jproject
        return loss, seen[0]
    fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    with slice_env():
        (_, jemb), _ = fn(jnp.zeros(shape, jnp.float32), dense_j)

    tproject = tanyref.project_seg_hidden
    delta = torch.zeros(shape, requires_grad=True)
    seen = []

    def moved_t(p, h):
        seen.append(tproject(p, h))
        return seen[-1] + delta
    lora_p, dense, frozen = _port_state(tp, jlora_params)
    tanyref.project_seg_hidden = moved_t
    try:
        loss, _ = tstep.loss_fn(lora_p, dense, frozen, cfg, TCFG, batch,
                                "fused")
    finally:
        tanyref.project_seg_hidden = tproject
    leaves = tstep.tree_leaves(dense)
    g_delta, *g_dense = torch.autograd.grad(loss, [delta, *leaves],
                                            allow_unused=True)
    g_dense = iter(g_dense)
    g_dense = tstep.tree_map(lambda p: next(g_dense), dense)
    temb = seen[0].detach().numpy()
    with slice_env():
        (_, _), (jg_delta, jg_dense) = fn(jnp.asarray(temb - np.asarray(jemb)),
                                          dense_j)
    pairs = [("delta", g_delta, jg_delta)] + [
        p for p in _tree_pairs(g_dense, jg_dense, "dense")
        if p[0].startswith(("dense/sam/", "dense/text_hidden_fcs/"))
        and not p[0].endswith(("/lin1/w", "/lin2/w"))]
    checked = set()
    for path, got, want in pairs:
        want = np.asarray(want, np.float32)
        got = np.zeros_like(want) if got is None else _np(got)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)
        if np.abs(want).max() > 0:
            checked.add(path)
    assert {"delta", "dense/sam/mask_decoder/mask_tokens",
            "dense/text_hidden_fcs/lin2/b"} <= checked, sorted(checked)
    assert np.abs(temb - np.asarray(jemb)).max() > 0


@pytest.mark.parametrize("with_boxes", [True, False],
                         ids=["loc_boxes", "no_loc_boxes"])
def test_train_forward_loc_tokens_match_jax(jp, tp, batch, with_boxes):
    """use_loc_tokens=True: with loc_boxes in the batch each [SEG] slot's
    prompt embedding gains loc_weight x the mean of its 4 loc embeddings
    (JAX anyref.py:437-440), and loc_embeddings get a gradient; without
    them the batch trains without loc tokens (no gradient reaches the
    table). Loss terms and that gradient against the JAX train_forward."""
    from anyref_tpu_torch.models import anyref as tanyref
    cfg = CFG.scaled(use_loc_tokens=True)
    rng = np.random.default_rng(12)
    loc = (0.5 * rng.standard_normal((cfg.tokens.num_loc, cfg.out_dim))
           ).astype(np.float32)
    b = dict(batch)
    if with_boxes:
        B = np.asarray(batch["input_ids"]).shape[0]
        b["loc_boxes"] = rng.integers(0, cfg.tokens.num_loc,
                                      (B, cfg.max_seg_per_sample, 4)
                                      ).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(table):
        out = janyref.train_forward({**jp, "loc_embeddings": table}, cfg, jb)
        return out.loss, out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(loc))
    table = torch.from_numpy(loc).requires_grad_(True)
    out = tanyref.train_forward({**tp, "loc_embeddings": table}, cfg, b)
    if out.loss.requires_grad:   # only the table asks for a gradient here
        out.loss.backward()
    for name in ("loss", "lm_loss", "bce_loss", "dice_loss"):
        np.testing.assert_allclose(getattr(out, name).item(),
                                   float(getattr(jout, name)), rtol=1e-3,
                                   err_msg=name)
    jgrad = np.asarray(jgrad, np.float32)
    got = (np.zeros_like(jgrad) if table.grad is None
           else table.grad.numpy())
    np.testing.assert_allclose(got, jgrad, rtol=0,
                               atol=2e-2 * max(np.abs(jgrad).max(), 1e-30))
    assert (np.abs(jgrad).max() > 0) == with_boxes


# ---------------------------------------------------------------------------
# (e) the optimizer against optax
# ---------------------------------------------------------------------------
def test_optimizer_matches_optax():
    """Three steps of make_optimizer on a gradient tree with None positions,
    a norm above the clip in steps 1 and 3 and below it in step 2; lr(0) =
    0, so the first update is zero."""
    rng = np.random.default_rng(12)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": None}, "e": [(2, 2)]}

    def make(fn):
        def walk(s):
            if s is None:
                return None
            if isinstance(s, dict):
                return {k: walk(v) for k, v in s.items()}
            if isinstance(s, list):
                return [walk(v) for v in s]
            return fn(s)
        return walk(shapes)
    params = make(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [make(lambda s: (rng.standard_normal(s) * scale).astype(
        np.float32)) for scale in (3.0, 0.05, 2.0)]
    jopt = jstep.make_optimizer(lr=1e-2, warmup=1, total_steps=3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    topt = tstep.make_optimizer(lr=1e-2, warmup=1, total_steps=3)
    tparams_ = tstep.tree_map(_t, params)
    tstate = topt.init(tparams_)
    for i, g in enumerate(grads):
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, tstate = topt.update(tstep.tree_map(_t, g), tstate, tparams_)
        for p, u in zip(tstep.tree_leaves(tparams_), tstep.tree_leaves(tu)):
            p.add_(u)
        for path, got, want in _tree_pairs(tparams_, jparams):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i}{path}")
        if i == 0:
            assert all(float(np.abs(_np(u)).max()) == 0.0
                       for u in tstep.tree_leaves(tu))
    assert tstate.count == 3


@pytest.mark.parametrize("warmup,total", [(1, 3), (4, 10), (0, 5)])
def test_schedule_matches_optax(warmup, total):
    want = optax.join_schedules([
        optax.linear_schedule(0.0, 5e-5, warmup),
        optax.linear_schedule(5e-5, 0.0, total - warmup)], [warmup])
    got = tstep.warmup_decay_schedule(5e-5, warmup, total)
    for c in range(total + 2):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))


# ---------------------------------------------------------------------------
# (f) gradient accumulation
# ---------------------------------------------------------------------------
class _SGD:
    """Updates linear in the gradient, so two micro-steps must equal one
    batch of four exactly up to summation order."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return tstep.tree_map(lambda g: -1e-2 * g, grads), state


def test_grad_accum_equals_big_batch(tp):
    """Equal-length answers: with differing token counts the mean of the
    micro-steps' token-averaged LM losses differs from the pooled mean,
    in the reference too. bf16 decoder activations of a batch of 4 and of 2
    round alike row by row; tolerance 1e-3 of each leaf's largest update."""
    col = Collator(AnyRefTokenizer(), CFG, train=True)
    insts = _samples(PHRASES, seed=4)
    runs = []
    for accum, batch in ((2, tstep.stack_microbatches(
            [col(insts[:2]), col(insts[2:])])),
            (1, tstep.device_batch(col(insts)))):
        state, frozen = tstep.init_state(torch.Generator().manual_seed(1), tp,
                                         TCFG, _SGD())
        step = tstep.make_train_step(CFG, TCFG, _SGD(), remat=False,
                                     grad_accum=accum)
        state, metrics = step(state, frozen, batch)
        runs.append((state, metrics))
    (sa, ma), (sb, mb) = runs
    for k in tstep.METRICS:
        np.testing.assert_allclose(ma[k].item(), mb[k].item(), rtol=1e-3)
    base = tstep.tree_leaves(tlora.split_trainable(tp)[0])
    for a, b, p in zip(tstep.tree_leaves(sa.dense),
                       tstep.tree_leaves(sb.dense), base):
        ua, ub = _np(a) - _np(p), _np(b) - _np(p)
        np.testing.assert_allclose(ua, ub, rtol=0,
                                   atol=1e-3 * np.abs(ub).max() + 1e-12)


# ---------------------------------------------------------------------------
# (g) LoRA
# ---------------------------------------------------------------------------
def test_lora_merge_equals_apply_and_matches_jax(jp, tp, jlora_params):
    lora_p = tparams.from_numpy(jax.device_get(jlora_params), device="cpu")
    merged = tlora.merge(tp["llama"], lora_p, TCFG)
    applied = tlora.apply(tp["llama"], lora_p, TCFG)
    want = jlora.apply(jp["llama"], jlora_params, LCFG)
    for path, got, w in _tree_pairs(merged, want):
        np.testing.assert_allclose(_np(got), np.asarray(w), atol=1e-6,
                                   rtol=1e-6, err_msg=path)
    for a, b in zip(tstep.tree_leaves(merged), tstep.tree_leaves(applied)):
        assert torch.equal(a, b)
    assert merged["layers"][0]["mlp"] is not tp["llama"]["layers"][0]["mlp"]
    assert merged["layers"][0]["mlp"]["up"]["w"] is \
        tp["llama"]["layers"][0]["mlp"]["up"]["w"]


def test_lora_split_merge_round_trips(jp, tp):
    dense, frozen = tlora.split_trainable(tp)
    jdense, jfrozen = jlora.split_trainable(jp)
    for got, want in ((dense, jdense), (frozen, jfrozen)):
        assert len(_tree_pairs(got, want)) == len(jax.tree.leaves(want))
    back = tlora.merge_params(dense, frozen)
    pairs = _tree_pairs(back, tp)
    assert len(pairs) == len(tstep.tree_leaves(tp))
    assert all(a is b for _, a, b in pairs)
    assert dense["sam"]["image_encoder"] is None
    assert frozen["llama"]["lm_head"] is None


def test_lora_init_draws_from_the_generator(tp):
    a = tlora.init(torch.Generator().manual_seed(5), tp["llama"], TCFG)
    b = tlora.init(torch.Generator().manual_seed(5), tp["llama"], TCFG)
    x = a["layers"][1]["v"]
    assert torch.equal(x["a"], b["layers"][1]["v"]["a"])
    assert x["a"].shape == (CFG.llama.hidden_size, TCFG.r)
    assert not x["b"].any() and x["a"].dtype == torch.float32
    assert abs(x["a"].std().item() - 1 / TCFG.r) < 0.02


# ---------------------------------------------------------------------------
# (h) the Trainer and the train-state checkpoint
# ---------------------------------------------------------------------------
class _Dataset:
    def __init__(self, n=4):
        self.items = _samples(PHRASES[:n], seed=2)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_trainer_runs_saves_and_resumes(tmp_path, tp):
    tc = TrainConfig(output_dir=str(tmp_path), per_device_batch_size=1,
                     grad_accum_steps=2, max_steps=2, warmup_steps=1,
                     save_steps=1, log_steps=1, resume=False, remat=True,
                     profile_steps=(1, 1),
                     profile_dir=str(tmp_path / "profile"))
    trainer = Trainer(CFG, tc, tp, dataset=_Dataset(), device="cpu")
    state = trainer.train()
    assert state.step == 2
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1", "checkpoint-2",
                                            "metrics.jsonl", "profile"]
    assert os.listdir(tmp_path / "profile") == ["trace-1-1.json"]
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    # step 2 used lr(1) > 0: the LoRA B moved; the caller's tree did not
    assert state.lora["layers"][0]["q"]["b"].abs().max() > 0
    assert not torch.equal(state.dense["llama"]["lm_head"],
                           tp["llama"]["lm_head"])

    tc2 = dataclasses.replace(tc, max_steps=3, save_steps=10, resume=True,
                              profile_steps=())
    trainer2 = Trainer(CFG, tc2, tp, dataset=_Dataset(), device="cpu")
    assert trainer2.state.step == 2
    for a, b in zip(tstep.tree_leaves((trainer2.state.lora,
                                       trainer2.state.dense,
                                       trainer2.state.opt_state.mu)),
                    tstep.tree_leaves((state.lora, state.dense,
                                       state.opt_state.mu))):
        assert torch.equal(a.detach(), b.detach()) and a.requires_grad == \
            b.requires_grad
    assert trainer2.train().step == 3
    merged = trainer2.merged_params()
    assert len(_tree_pairs(merged, tp)) == len(tstep.tree_leaves(tp))


def test_checkpoint_keeps_three_and_matches_by_name(tmp_path):
    state = tstep.TrainState(0, {"layers": [{"q": {"a": torch.ones(2, 3)}}]},
                             {"x": torch.zeros(4), "y": None},
                             tstep.OptState(1, (torch.ones(1),),
                                            (torch.zeros(1),)))
    for s in range(1, 6):
        tckpt.save_train_state(str(tmp_path), s, state._replace(step=s))
    assert sorted(os.listdir(tmp_path)) == [f"checkpoint-{s}"
                                            for s in (3, 4, 5)]
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint-5")
    tmpl = {"step": 0, "lora": state.lora, "dense": state.dense,
            "opt_state": state.opt_state}
    got = tckpt.restore_train_state(latest, tmpl)
    assert got["step"] == 5 and isinstance(got["opt_state"], tstep.OptState)
    assert torch.equal(got["lora"]["layers"][0]["q"]["a"], torch.ones(2, 3))
    with pytest.raises(ValueError):
        tckpt.restore_train_state(latest, {**tmpl, "dense": {
            "x": torch.zeros(5), "y": None}})
