"""The port's main path end to end at anyref_tiny(): generate against the
JAX package's generate in its unfused configuration (the port's
encoder_path="unfused"; tests/test_torch_fused.py holds the fused path),
speculative decode against greedy, and Predictor / Server against generate.

Both packages run the decoder on bf16 activations here (generate embeds in
bf16 whatever the param dtype) with fp32 weights, so token ids must be EQUAL
and the low-res mask logits agree to atol = rtol = 2e-2: the [SEG]-slot
hidden states are bf16 (one ulp is 2^-8 relative) before the fp32
projection and the fp32 mask decoder."""

import functools
import threading

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
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.serve import Server
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

CFG = anyref_tiny()
MNT = 6
BUCKET = 257
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")
TEXTS = ("the cat", "the red cat on the red mat near the open door")


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


@pytest.fixture(scope="module")
def images():
    # shortest edge 224: CLIP's resize is the identity (no PIL involved)
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (224, 300, 3), np.uint8),
            rng.integers(0, 256, (280, 224, 3), np.uint8)]


def _left_padded(batch):
    """The Predictor's left pad into BUCKET, done by hand."""
    B = batch["input_ids"].shape[0]
    ids = np.zeros((B, BUCKET), np.int32)
    for b in range(B):
        n = int(batch["prompt_lens"][b])
        ids[b, BUCKET - n:] = batch["input_ids"][b, :n]
    return {"input_ids": ids, "clip_images": batch["clip_images"],
            "sam_images": batch["sam_images"]}


@pytest.fixture(scope="module")
def float_batch(images):
    ds = SegDataset(CFG)
    samples = [ds.make_sample(im, seg_question(t), None, None)
               for im, t in zip(images, TEXTS)]
    return Collator(AnyRefTokenizer(), CFG)(samples)


@pytest.fixture(scope="module")
def port_greedy(tp, float_batch):
    return tanyref.generate(tp, CFG, _left_padded(float_batch),
                            max_new_tokens=MNT, device="cpu",
                            encoder_path="unfused")


def test_generate_matches_jax(jp, port_greedy, float_batch):
    """Two left-padded prompts of different lengths: prefill with kv_start,
    greedy decode with early exit, [SEG] slots, SAM encode + decode."""
    batch = _left_padded(float_batch)
    want = jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT),
                   static_argnums=(1,))(
        jp, CFG, {k: jnp.asarray(v) for k, v in batch.items()})
    got = port_greedy
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    assert got.decode_passes == int(want.decode_passes)
    np.testing.assert_allclose(got.low_res_masks.numpy(),
                               np.asarray(want.low_res_masks),
                               atol=2e-2, rtol=2e-2)


def test_speculative_matches_greedy(tp, port_greedy, float_batch):
    """Prompt-lookup speculative decode is lossless: the greedy ids."""
    spec = tanyref.generate(tp, CFG, _left_padded(float_batch),
                            max_new_tokens=MNT, speculative=True,
                            draft_len=3, device="cpu",
                            encoder_path="unfused")
    np.testing.assert_array_equal(spec.output_ids.numpy(),
                                  port_greedy.output_ids.numpy())
    np.testing.assert_array_equal(spec.seg_valid.numpy(),
                                  port_greedy.seg_valid.numpy())
    assert spec.decode_passes <= port_greedy.decode_passes


def test_prompt_lookup_draft_matches_jax():
    """Batched drafts equal the reference's per-row drafts, including the
    periodic wrap and the no-match fallback."""
    from anyref_tpu.models.anyref import _prompt_lookup_draft as jdraft
    rng = np.random.default_rng(4)
    seq = rng.integers(3, 9, (3, 40)).astype(np.int64)
    seq[2, :] = np.arange(40)     # no repeated bigram: fallback
    for cur in (5, 17, 33):
        want = np.stack([np.asarray(jdraft(jnp.asarray(r), cur, 2, 7))
                         for r in seq])
        got = tanyref._prompt_lookup_draft(torch.from_numpy(seq), cur, 2, 7)
        np.testing.assert_array_equal(got.numpy(), want)


def test_seg_slots_match_jax():
    """[SEG] positions and validity, including a row with more [SEG]s than
    slots (overflow dropped) and a row with none."""
    from anyref_tpu.models.anyref import _seg_slots as jslots
    seg = CFG.tokens.seg
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 300, (3, 20)).astype(np.int64)
    ids[0, [2, 7, 8]] = seg
    ids[1, ::2] = seg
    for S in (2, 8):
        jp_, jv = jslots(jnp.asarray(ids), seg, S)
        tp_, tv = tanyref._seg_slots(torch.from_numpy(ids), seg, S)
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_generate_output_mask_canvas_matches_jax():
    """GenerateOutput.mask_canvas, the JAX package's compatibility name of
    low_res_masks, on both sides of one set of outputs."""
    rng = np.random.default_rng(9)
    arrays = [rng.integers(0, 300, (2, 4)), rng.integers(0, 4, (2,)),
              rng.standard_normal((2, 3, 8, 8)).astype(np.float32),
              rng.integers(0, 2, (2, 3)).astype(bool),
              rng.standard_normal((2, 3, 5)).astype(np.float32),
              np.asarray(4, np.int32)]
    want = janyref.GenerateOutput(*map(jnp.asarray, arrays))
    got = tanyref.GenerateOutput(*map(torch.from_numpy, arrays))
    assert got.mask_canvas is got.low_res_masks
    np.testing.assert_array_equal(got.mask_canvas.numpy(),
                                  np.asarray(want.mask_canvas))


def test_predictor_matches_generate(tp, port_greedy, float_batch):
    pred = Predictor(tp, CFG, max_new_tokens=MNT, prompt_buckets=(BUCKET,),
                     batch_buckets=(2,), device="cpu", encoder_path="unfused")
    ids, masks = pred.predict(float_batch)
    np.testing.assert_array_equal(ids, port_greedy.output_ids.numpy())
    assert len(masks) == 2 and pred.completed_batches == 1


def test_server_matches_predictor(tp, images):
    """Two concurrent text requests through the server's queue, micro-
    batcher, uint8 device normalize and completion loop give the ids (and
    mask shapes) of one Predictor batch over the same samples."""
    ds = SegDataset(CFG, uint8_images=True)
    samples = [ds.make_sample(im, seg_question(t), None, None)
               for im, t in zip(images, TEXTS)]
    batch = Collator(AnyRefTokenizer(), CFG)(samples)
    pred = Predictor(tp, CFG, max_new_tokens=MNT, batch_buckets=(2,),
                     speculative=True, draft_len=3, device="cpu",
                     encoder_path="unfused")
    want_ids, _ = pred.predict(batch)

    srv = Server(tp, CFG, max_batch=2, max_new_tokens=MNT, draft_len=3,
                 preprocess_workers=2, device="cpu", encoder_path="unfused")
    try:
        results = [None, None]

        def ask(i):
            results[i] = srv.segment(images[i], TEXTS[i])

        threads = [threading.Thread(target=ask, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
    for i, r in enumerate(results):
        assert "error" not in r, r
        np.testing.assert_array_equal(r["output_ids"], want_ids[i])
        assert r["mask"].shape == images[i].shape[:2]
    assert srv.stats["rows"] == 2
