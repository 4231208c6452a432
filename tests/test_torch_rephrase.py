"""Rephrase pooling in the port against the JAX package, on the CPU at
anyref_tiny(): the final layer's attention row, the span pool, the
training-path pool, and generate at rephrase_weight=0.1, greedy and
speculative, on the unfused encoder path (the JAX side with its four switches
at 0, as tests/test_torch_generate.py runs it).

Weights are the JAX init bridged by params.from_numpy, with lm_head's [SEG]
column scaled by SEG_SCALE so that one prompt answers a few tokens before
its first [SEG] (a non-empty span) and the other answers [SEG] at once (an
empty span, pooled to 0).

Tolerances: the pooling functions in fp32, atol = rtol = 1e-5 (sums of a
few hundred fp32 terms in another order). generate runs the decoder on bf16
activations on both sides, so ids are equal and seg_embeddings and the
low-res masks agree to atol = rtol = 2e-2 of the largest magnitude, as in
tests/test_torch_generate.py (the [SEG] states are bf16, 2^-8 relative)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

CFG = anyref_tiny().scaled(rephrase_weight=0.1)
MNT = 6
BUCKET = 257
# with the JAX init of key 0, prompt 0 answers two tokens, then [SEG]
SEG_SCALE = 3.0
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")
TEXTS = ("the cat", "the red cat on the red mat near the open door")


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


@pytest.fixture(scope="module")
def jp():
    p = janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)
    lm = p["llama"]["lm_head"]
    p["llama"]["lm_head"] = lm.at[:, CFG.tokens.seg].multiply(SEG_SCALE)
    return p


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def batch():
    """Two prompts left-padded into BUCKET, as the Predictor pads them."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = SegDataset(CFG)
    fb = Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(fb["prompt_lens"][b])
        ids[b, BUCKET - n:] = fb["input_ids"][b, :n]
    return {"input_ids": ids, "clip_images": fb["clip_images"],
            "sam_images": fb["sam_images"]}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_last_layer_attn_row_matches_jax(jp, tp):
    """Per-head softmax over the causal row from the left pad, then the
    head mean, with the rope position apart from the key slot."""
    c = CFG.llama
    rng = np.random.default_rng(3)
    B, T = 3, 40
    q_in = rng.standard_normal((B, c.hidden_size)).astype(np.float32)
    k = rng.standard_normal((B, c.num_kv_heads, T, c.head_dim)).astype(
        np.float32)
    q_slot = np.array([39, 20, 5], np.int32)
    kv_start = np.array([0, 7, 2], np.int32)
    q_pos = q_slot - kv_start
    want = janyref._last_layer_attn_row(
        jp, CFG, jnp.asarray(q_in), jnp.asarray(k), jnp.asarray(q_pos),
        jnp.asarray(q_slot), kv_start=jnp.asarray(kv_start))
    got = tanyref._last_layer_attn_row(
        tp, CFG, torch.from_numpy(q_in), torch.from_numpy(k),
        torch.from_numpy(q_pos).long(), torch.from_numpy(q_slot).long(),
        kv_start=torch.from_numpy(kv_start).long())
    _close(got, want, 1e-5)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)
    assert float(got[1, :7].abs().max()) == 0.0
    assert float(got[2, 6:].abs().max()) == 0.0


def test_span_pool_matches_jax():
    """Renormalised over the span; a row whose span is empty pools 0."""
    rng = np.random.default_rng(4)
    row = rng.random((3, 9)).astype(np.float32)
    hidden = rng.standard_normal((3, 9, 16)).astype(np.float32)
    span = np.zeros((3, 9), bool)
    span[0, 2:5] = True
    span[1, :] = True
    want = janyref._span_pool(jnp.asarray(row), jnp.asarray(hidden),
                              jnp.asarray(span))
    got = tanyref._span_pool(torch.from_numpy(row), torch.from_numpy(hidden),
                             torch.from_numpy(span))
    _close(got, want, 1e-5)
    assert float(got[2].abs().max()) == 0.0


def test_rephrase_pool_matches_jax(jp, tp):
    """The training path: keys recomputed from the final layer's input,
    the answer span from the labels, the query the state before [SEG]."""
    c = CFG.llama
    rng = np.random.default_rng(5)
    B, L = 2, 24
    hidden = rng.standard_normal((B, L, c.hidden_size)).astype(np.float32)
    last_in = rng.standard_normal((B, L, c.hidden_size)).astype(np.float32)
    labels = np.full((B, L), -100, np.int32)
    labels[0, 10:18] = 5
    labels[1, 15:20] = 7
    seg_pos = np.array([[16, 0], [15, 0]], np.int32)  # row 1: empty span
    want = janyref._rephrase_pool(jp, CFG, jnp.asarray(hidden),
                                  jnp.asarray(last_in), jnp.asarray(labels),
                                  jnp.asarray(seg_pos))
    got = tanyref._rephrase_pool(tp, CFG, torch.from_numpy(hidden),
                                 torch.from_numpy(last_in),
                                 torch.from_numpy(labels).long(),
                                 torch.from_numpy(seg_pos).long())
    _close(got, want, 1e-5)
    assert float(got[0].abs().max()) > 0


def test_rephrase_pool_backward_matches_jax(jp, tp):
    """The pooling's backward in fp32 against jax.vjp: the gradients of the
    final layer's input, the hidden states and the weights it reads (the
    final layer's input_norm, q and k), for one cotangent. atol 1e-5 of each
    gradient's largest magnitude, rtol 1e-4."""
    c = CFG.llama
    rng = np.random.default_rng(6)
    B, L = 2, 24
    hidden = rng.standard_normal((B, L, c.hidden_size)).astype(np.float32)
    last_in = rng.standard_normal((B, L, c.hidden_size)).astype(np.float32)
    labels = np.full((B, L), -100, np.int32)
    labels[0, 10:18] = 5
    labels[1, 3:20] = 7
    seg_pos = np.array([[16, 0], [19, 0]], np.int32)
    cot = rng.standard_normal((B, 1, c.hidden_size)).astype(np.float32)
    layer = jp["llama"]["layers"][-1]
    wj = (layer["input_norm"]["scale"], layer["attn"]["q"]["w"],
          layer["attn"]["k"]["w"])

    def jfn(h, li, scale, wq, wk):
        lay = {**layer, "input_norm": {"scale": scale},
               "attn": {**layer["attn"], "q": {"w": wq}, "k": {"w": wk}}}
        p = {**jp, "llama": {**jp["llama"], "layers": [
            *jp["llama"]["layers"][:-1], lay]}}
        return janyref._rephrase_pool(p, CFG, h, li, jnp.asarray(labels),
                                      jnp.asarray(seg_pos))

    _, vjp = jax.vjp(jfn, jnp.asarray(hidden), jnp.asarray(last_in), *wj)
    want = vjp(jnp.asarray(cot))
    ins = [torch.from_numpy(hidden).requires_grad_(True),
           torch.from_numpy(last_in).requires_grad_(True)]
    ws = [torch.from_numpy(np.array(w)).requires_grad_(True) for w in wj]
    tlayer = tp["llama"]["layers"][-1]
    lay = {**tlayer, "input_norm": {"scale": ws[0]},
           "attn": {**tlayer["attn"], "q": {"w": ws[1]}, "k": {"w": ws[2]}}}
    p = {**tp, "llama": {**tp["llama"], "layers": [
        *tp["llama"]["layers"][:-1], lay]}}
    out = tanyref._rephrase_pool(p, CFG, *ins,
                                 torch.from_numpy(labels).long(),
                                 torch.from_numpy(seg_pos).long())
    out.backward(torch.from_numpy(cot))
    for name, t, w in zip(("hidden", "last_in", "input_norm", "q", "k"),
                          ins + ws, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.fixture(scope="module")
def port_plain(tp, batch):
    """The port's greedy generate at rephrase 0 (the pooled term is the
    difference from it)."""
    return tanyref.generate(tp, CFG.scaled(rephrase_weight=0.0), batch,
                            max_new_tokens=MNT, device="cpu",
                            encoder_path="unfused")


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["greedy", "speculative"])
def test_generate_rephrase_matches_jax(jp, tp, batch, port_plain,
                                       speculative):
    kw = {"speculative": True, "draft_len": 3} if speculative else {}
    want = jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT,
                                     **kw), static_argnums=(1,))(
        jp, CFG, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tanyref.generate(tp, CFG, batch, max_new_tokens=MNT, device="cpu",
                           encoder_path="unfused", **kw)
    ids = got.output_ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    _close(got.seg_embeddings, want.seg_embeddings, 2e-2)
    _close(got.low_res_masks, want.low_res_masks, 2e-2)
    # row 0's first [SEG] comes at k >= 1 (a pooled span), row 1's at 0
    first = [list(r).index(CFG.tokens.seg) for r in ids]
    assert first[0] >= 1 and first[1] == 0, ids
    np.testing.assert_array_equal(ids, port_plain.output_ids.numpy())
    # the pooled term moves row 0's [SEG] embedding past the tolerance and
    # leaves row 1's (empty span) as it is
    delta = (got.seg_embeddings - port_plain.seg_embeddings)[:, 0].abs()
    scale = float(got.seg_embeddings[:, 0].abs().max())
    assert float(delta[0].max()) > 2e-2 * scale
    assert float(delta[1].max()) == 0.0
