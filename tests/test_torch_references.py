"""The port's image-crop, RoI-box and audio references against the JAX
package's, on the CPU at anyref_tiny().

Weights are the JAX init bridged by params.from_numpy; inputs come from
numpy seeds. generate runs on two encoder paths: "unfused" (the JAX side
with all four switches 0) and "fused" (ANYREF_FUSED_WINDOW_BLOCK=1
ANYREF_FUSED_GLOBAL_BLOCK=1 ANYREF_FUSED_SPLIT=1 ANYREF_QKV_MHA_KERNEL=1
ANYREF_QKV_WINDOW_KERNEL=0 at tests/test_torch_fused.py's 512-pixel SAM
image with windows of 8, so the fused gates open), the JAX Pallas kernels
in interpret mode.

Tolerances, each with its reason:
- log-mel: atol 2e-3 (2e-3 / 9.138 after the clips' normalisation). The two
  fp32 FFTs round differently, and a mel band's power is summed from bins
  whose error is relative to the frame's strongest bin; 2e-3 is a 0.2%
  error in one band's power, where a wrong window, frame or bank is O(1);
- the audio tower and encode_audio in fp32: atol = rtol = 1e-4 (products of
  a few hundred fp32 terms summed in another order); in bf16: relative L2
  1e-2 and 2e-2 of the largest magnitude, one bf16 ulp (2^-8 relative) at
  a rounding point that falls the other way;
- encode_ref_images: 1e-4 in fp32 (tests/test_torch_fused.py's CLIP
  tolerance); its two-stage pooling alone, given the same bf16 features,
  bit for bit;
- encode_roi, _scatter_placeholder and assemble_embeds: bit for bit (a
  gather and a select);
- generate: token ids and [SEG] validity equal, low-res masks 2e-2
  (tests/test_torch_generate.py's limit);
- train_forward: loss terms 1e-3 relative, gradients 2e-2 of each leaf's
  largest magnitude (tests/test_torch_train.py's limits).

Where a crop or audio row meets the bf16 decoder (the crop generate and the
training step), the port's two towers return the JAX towers' fp32 output
for the same inputs (``jax_towers``); the towers themselves are held above.
At random tiny weights CLIP's fp32 sums, taken in another order, move a few
dozen of the 2 x 256 x 128 spliced features across a bf16 rounding
boundary (at most 4.8e-7 apart before the cast), and that alone turns the
crop row's near-tied third token and one ReLU unit of text_hidden_fcs'
gradient; given the JAX towers' output the port's ids are the JAX ids.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu import tokenizer as jtok
from anyref_tpu.config import anyref_tiny
from anyref_tpu.data import base as jbase
from anyref_tpu.data import collator as jcollator
from anyref_tpu.data import preprocess as jpre
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models.imagebind import audio as jaudio
from anyref_tpu.ops import mel as jmel
from anyref_tpu.train import lora as jlora
from anyref_tpu.train import step as jstep
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch import tokenizer as ttok
from anyref_tpu_torch.data import base as tbase
from anyref_tpu_torch.data import collator as tcollator
from anyref_tpu_torch.data import preprocess as tpre
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.models.imagebind import audio as taudio
from anyref_tpu_torch.ops import mel as tmel
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from tests.torch_one_thread import one_thread  # noqa: F401

TINY = anyref_tiny()
FUSED_CFG = dataclasses.replace(TINY, sam=dataclasses.replace(
    TINY.sam, image_size=512, window_size=8))
PATHS = {
    "unfused": (TINY, {"ANYREF_FUSED_WINDOW_BLOCK": "0",
                       "ANYREF_FUSED_GLOBAL_BLOCK": "0",
                       "ANYREF_QKV_WINDOW_KERNEL": "0",
                       "ANYREF_QKV_MHA_KERNEL": "0"}),
    "fused": (FUSED_CFG, {"ANYREF_FUSED_WINDOW_BLOCK": "1",
                          "ANYREF_FUSED_GLOBAL_BLOCK": "1",
                          "ANYREF_FUSED_SPLIT": "1",
                          "ANYREF_QKV_MHA_KERNEL": "1",
                          "ANYREF_QKV_WINDOW_KERNEL": "0"}),
}
MEL_TOL = 2e-3
MNT = 6
BUCKET = 257


@contextlib.contextmanager
def path_env(path):
    with pytest.MonkeyPatch.context() as mp:
        for name, value in PATHS[path][1].items():
            mp.setenv(name, value)
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _wave(seconds: float, seed: int = 0) -> np.ndarray:
    """Noise, a 440 Hz tone and a DC offset at 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.1 * rng.standard_normal(t.shape)
            + 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05).astype(np.float32)


def _perturbed(tree, seed: int):
    """Every leaf moved by 0.1 N(0, 1): the init's zero biases, cls token
    and bias_k / bias_v would hide a misplaced one."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a.astype(jnp.float32) + 0.1 * rng.standard_normal(
            a.shape)).astype(a.dtype), tree)


# ---------------------------------------------------------------------------
# host pieces: prompts, crops, boxes, the collator
# ---------------------------------------------------------------------------
def test_reference_questions_match_jax():
    jt, tt = jtok.AnyRefTokenizer(), ttok.AnyRefTokenizer()
    assert ttok.IMG_REF_PROMPT == jtok.IMG_REF_PROMPT
    assert ttok.AUDIO_REF_PROMPT == jtok.AUDIO_REF_PROMPT
    tk = TINY.tokens
    for name, slot, n in (("img_ref_question", tk.img_ref, 4),
                          ("audio_ref_question", tk.audio_ref, 3),
                          ("region_caption_question", tk.img_ref, 4)):
        q = getattr(ttok, name)()
        assert q == getattr(jtok, name)()
        want = jtok.tokenize_prompt(jt, q)
        got = ttok.tokenize_prompt(tt, q)
        np.testing.assert_array_equal(got, want)
        assert int((got == slot).sum()) == n


def test_crop_box_and_boxes_match_jax():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (40, 60, 3), np.uint8)
    mask = rng.integers(0, 2, (40, 60)).astype(np.uint8)
    boxes = ([3.4, 5.6, 20.5, 30.5], [0, 0, 60, 40], [-5, -3, 70, 50],
             # a 1-pixel box inset at the right / bottom edge: x1 == w
             [60, 39, 59, 38], [59.5, 10, 61, 12], [10, 40, 12, 39])
    for xyxy in boxes:
        for m in (None, mask):
            want = jpre.crop_box_np(image, np.asarray(xyxy, np.float64), m)
            got = tpre.crop_box_np(image, np.asarray(xyxy, np.float64), m)
            assert got.size > 0
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tbase.SegDataset.ref_crop(image, xyxy, m),
                jbase.SegDataset.ref_crop(image, xyxy, m))
    assert tpre.crop_box_np(image, np.asarray([60, 39, 59, 38])).shape == \
        (1, 1, 3)
    for m in (mask, np.zeros_like(mask), mask[:1] * 0 + 1):
        np.testing.assert_array_equal(tbase.mask_to_xyxy(m),
                                      jbase.mask_to_xyxy(m))
    for xyxy in ([0, 0, 60, 40], [3.4, 5.6, 20.5, 30.5], [0.3, 0.2, 1.5, 0.6]):
        np.testing.assert_array_equal(
            tbase.normalized_bbox_0_100(xyxy, 40, 60),
            jbase.normalized_bbox_0_100(xyxy, 40, 60))


def _samples(pkg_base, pkg_tok, with_audio):
    """A crop, a box, an audio and a text sample, made by each package's
    make_sample."""
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (224, 300, 3), np.uint8)
    ds = pkg_base.SegDataset(TINY)
    crop = pkg_base.SegDataset.ref_crop(image, [20, 10, 250, 224])
    mels = jmel.audio_to_mel_clips(_wave(2.5, 1)) if with_audio else None
    out = [ds.make_sample(image, pkg_tok.img_ref_question(), None, None,
                          ref_image=crop),
           ds.make_sample(image, pkg_tok.img_ref_question(), None, None,
                          ref_bbox=np.asarray([0.1, 0.2, 0.7, 0.9])),
           ds.make_sample(image, pkg_tok.seg_question("the cat"), None, None)]
    if with_audio:
        out.append(ds.make_sample(image, pkg_tok.audio_ref_question(), None,
                                  None, audio_mels=mels))
    return out


@pytest.mark.parametrize("roi", [False, True], ids=["crop", "roi"])
@pytest.mark.parametrize("kinds", [(0, 1, 2, 3), (2, 3), (2,), (1, 2)],
                         ids=["all", "text-audio", "text", "box-text"])
def test_collator_references_match_jax(roi, kinds):
    """The reference keys of the port's prompt-mode batch equal the JAX
    collator's (the JAX one in its prompt mode, train=False); in RoI mode a
    crop is dropped, and without it a box."""
    js = _samples(jbase, jtok, True)
    ts = _samples(tbase, ttok, True)
    want = jcollator.Collator(jtok.AnyRefTokenizer(), TINY, train=False,
                              roi=roi)([js[k] for k in kinds])
    got = tcollator.Collator(ttok.AnyRefTokenizer(), TINY, roi=roi)(
        [ts[k] for k in kinds])
    ref_keys = ("ref_images", "ref_valid", "roi_boxes", "audio_mels",
                "audio_valid")
    assert [k for k in ref_keys if k in got] == \
        [k for k in ref_keys if k in want]
    for k in ref_keys + ("input_ids", "prompt_lens", "clip_images",
                         "sam_images"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["clip_images"].dtype == np.float32


# ---------------------------------------------------------------------------
# the mel front end and the audio tower
# ---------------------------------------------------------------------------
def test_kaldi_fbank_matches_jax():
    clip = _wave(2.0)
    want = np.asarray(jmel.kaldi_fbank(jnp.asarray(clip)))
    got = tmel.kaldi_fbank(torch.from_numpy(clip))
    assert tuple(got.shape) == want.shape == (198, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_TOL, rtol=0)
    np.testing.assert_array_equal(tmel._mel_banks(128, 512, 16000.0),
                                  jmel._mel_banks(128, 512, 16000.0))
    assert tmel.clip_timepoints(5.0) == jmel.clip_timepoints(5.0)


@pytest.mark.parametrize("seconds", [5.0, 1.5, 0.01])
def test_audio_to_mel_clips_matches_jax(seconds):
    """5 s: three clips at 0, 1 and 2 s; 1.5 s: three equal short clips,
    frames zero-padded; 10 ms: shorter than one window, no frames."""
    wav = _wave(seconds)
    want = jmel.audio_to_mel_clips(wav)
    got = tmel.audio_to_mel_clips(wav, device="cpu")
    assert tuple(got.shape) == want.shape == (3, 1, 128, 204)
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_TOL / 9.138,
                               rtol=0)


@pytest.fixture(scope="module")
def audio_trees():
    """{dtype name: (JAX tree, port tree)} of the tiny audio tower."""
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        jp = _perturbed(jaudio.init(jax.random.key(0), TINY.audio, dt), 3)
        out[name] = (jp, tparams.from_numpy(jax.device_get(jp), "cpu"))
    return out


def _mels(n: int = 2) -> np.ndarray:
    return np.stack([jmel.audio_to_mel_clips(_wave(5.0, s))
                     for s in range(1, n + 1)]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_feature_matches_jax(audio_trees, dtype):
    jp, tp = audio_trees[dtype]
    mels = _mels()
    jf, je = jaudio.get_audio_feature(jp, TINY.audio, jnp.asarray(mels))
    tf, te = taudio.get_audio_feature(tp, TINY.audio, torch.from_numpy(mels))
    assert tf.dtype == te.dtype == getattr(torch, dtype)
    assert tuple(tf.shape) == jf.shape == (2, 3, TINY.audio.embed_dim)
    assert tuple(te.shape) == je.shape == (2, 3, TINY.audio.out_embed_dim)
    for got, want in ((tf, jf), (te, je)):
        got, want = _np(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        else:
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-2 * np.abs(want).max())
    # the embedding is L2-normalised and scaled by logit_scale_init
    np.testing.assert_allclose(np.linalg.norm(_np(te), axis=-1),
                               TINY.audio.logit_scale_init, rtol=2e-2)


# ---------------------------------------------------------------------------
# the reference encoders and the splice
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), TINY, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


def test_scatter_placeholder_matches_jax():
    """Row 0: two placeholders for three feature rows; row 1: five
    placeholders for three rows (the last two take row 2); row 2: not
    valid, its placeholders keep their embeddings."""
    rng = np.random.default_rng(0)
    ph = 7
    ids = np.array([[1, ph, 2, ph, 3, 4, 5, 6, 1, 2],
                    [ph, ph, 1, ph, ph, 2, ph, 3, 4, 5],
                    [1, ph, ph, 2, ph, 3, 4, 5, 6, 1]], np.int32)
    emb = rng.standard_normal((3, 10, 8)).astype(np.float32)
    feats = rng.standard_normal((3, 3, 8)).astype(np.float32)
    valid = np.array([True, True, False])
    want = janyref._scatter_placeholder(jnp.asarray(emb), jnp.asarray(ids),
                                        ph, jnp.asarray(feats),
                                        jnp.asarray(valid))
    got = tanyref._scatter_placeholder(
        torch.from_numpy(emb), torch.from_numpy(ids).long(), ph,
        torch.from_numpy(feats), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1, 6].numpy(), feats[1, 2])
    np.testing.assert_array_equal(got[2].numpy(), emb[2])


def test_encode_ref_images_matches_jax(jp, tp):
    px = np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32)
    with path_env("fused"):
        want = janyref.encode_ref_images(jp, TINY, jnp.asarray(px))
    got = tanyref.encode_ref_images(tp, TINY, torch.from_numpy(px),
                                    encoder_path="fused")
    assert tuple(got.shape) == want.shape == (2, 4, TINY.llama.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_ref_pooling_two_stages_in_bf16(monkeypatch):
    """Given the same bf16 CLIP features, the port's 256 -> 16 -> 4 pooling
    equals the reference's bit for bit, and differs from one mean over 64
    patches (the rounding between the stages is part of the result)."""
    feats = np.random.default_rng(1).standard_normal(
        (2, 256, 32)).astype(np.float32)
    jf = jnp.asarray(feats, jnp.bfloat16)
    tf = torch.from_numpy(feats).to(torch.bfloat16)
    monkeypatch.setattr(janyref, "encode_clip_images", lambda *a: jf)
    monkeypatch.setattr(tanyref, "encode_clip_images", lambda *a: tf)
    want = janyref.encode_ref_images(None, TINY, None)
    got = tanyref.encode_ref_images(None, TINY, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    one_mean = tf.reshape(2, 4, 64, 32).mean(2)
    assert not torch.equal(got, one_mean)


def test_encode_roi_matches_jax_exactly(tp, jp):
    """Coordinates on the .5 boundaries round half to even in both (12.5 ->
    12, 37.5 -> 38, ...); outside 0-1 they clamp to 0 and 100."""
    boxes = np.array([[0.125, 0.375, 0.625, 0.875],
                      [-0.1, 0.005, 0.995, 1.2],
                      [0.0, 0.5, 0.015, 1.0]], np.float32)
    boxes = np.concatenate([boxes, np.random.default_rng(0).uniform(
        0, 1, (5, 4)).astype(np.float32)])
    want = janyref.encode_roi(jp, jnp.asarray(boxes))
    got = tanyref.encode_roi(tp, torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    roi = tp["roi_embed"]
    np.testing.assert_array_equal(got[0].numpy(), torch.stack(
        [roi[0, 12], roi[1, 38], roi[2, 62], roi[3, 88]]).numpy())
    np.testing.assert_array_equal(got[1, 0].numpy(), roi[0, 0].numpy())
    np.testing.assert_array_equal(got[1, 3].numpy(), roi[3, 100].numpy())


def test_encode_audio_matches_jax(jp, tp):
    mels = _mels()
    want = janyref.encode_audio(jp, TINY, jnp.asarray(mels))
    got = tanyref.encode_audio(tp, TINY, torch.from_numpy(mels))
    assert tuple(got.shape) == want.shape == (2, 3, TINY.llama.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kind", ["crop", "audio"])
def test_assemble_embeds_with_references_matches_jax(jp, tp, kind):
    """The same features spliced by both packages: bit for bit; row 1 is
    not valid and keeps its placeholders' token embeddings."""
    tt = ttok.AnyRefTokenizer()
    q = ttok.img_ref_question() if kind == "crop" else \
        ttok.audio_ref_question()
    ids = ttok.tokenize_prompt(tt, q)
    ids = np.stack([ids, ids])
    D = TINY.llama.hidden_size
    rng = np.random.default_rng(2)
    clip = rng.standard_normal((2, 256, D)).astype(np.float32)
    feats = rng.standard_normal((2, 4 if kind == "crop" else 3,
                                 D)).astype(np.float32)
    valid = np.array([True, False])
    args = (feats, valid, None, None) if kind == "crop" else \
        (None, None, feats, valid)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    want, wids, _ = janyref.assemble_embeds(jp, TINY, jnp.asarray(ids),
                                            jnp.asarray(clip), *jargs)
    got, gids, _ = tanyref.assemble_embeds(tp, TINY,
                                           torch.from_numpy(ids).long(),
                                           torch.from_numpy(clip), *targs)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    np.testing.assert_array_equal(_np(got), _np(want))
    slot = TINY.tokens.img_ref if kind == "crop" else TINY.tokens.audio_ref
    at = np.nonzero(gids[0].numpy() == slot)[0]
    np.testing.assert_array_equal(_np(got[0, at]),
                                  _np(torch.from_numpy(feats[0]).to(
                                      got.dtype)))
    text, _, _ = tanyref.assemble_embeds(tp, TINY,
                                         torch.from_numpy(ids).long(),
                                         torch.from_numpy(clip))
    np.testing.assert_array_equal(_np(got[1]), _np(text[1]))


# ---------------------------------------------------------------------------
# generate on crop, box and text + audio batches
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def jax_towers(jparams, cfg, path):
    """The port's encode_clip_images and audio get_audio_feature return the
    JAX package's for the same inputs; yields the batch sizes CLIP was
    called with (each call must name ``path``)."""
    calls = []

    def clip(params, cfg_, px, encoder_path="fused"):
        assert encoder_path == path
        calls.append(px.shape[0])
        with path_env(path):
            out = janyref.encode_clip_images(jparams, cfg,
                                             jnp.asarray(_np(px)))
        return torch.from_numpy(np.array(out))

    def audio(params, acfg, mels):
        f, e = jaudio.get_audio_feature(jparams["audio_encoder"], acfg,
                                        jnp.asarray(_np(mels)))
        return torch.from_numpy(np.array(f)), torch.from_numpy(
            np.array(e))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tanyref, "encode_clip_images", clip)
        mp.setattr(taudio, "get_audio_feature", audio)
        yield calls


def _ref_batch(cfg, kind: str) -> dict:
    """A left-padded generate batch of two rows: "crop" (a crop, and a text
    row without one), "box" (two boxes, the second row not valid) or
    "text_audio" (a text row and an audio row)."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = tbase.SegDataset(cfg)
    text = ttok.seg_question("the red cat on the red mat")
    if kind == "crop":
        samples = [ds.make_sample(images[0], ttok.img_ref_question(), None,
                                  None, ref_image=tbase.SegDataset.ref_crop(
                                      images[1], [0, 30, 224, 280])),
                   ds.make_sample(images[1], text, None, None)]
    elif kind == "box":
        samples = [ds.make_sample(images[0], ttok.img_ref_question(), None,
                                  None, ref_bbox=[0.1, 0.2, 0.6, 0.9]),
                   ds.make_sample(images[1], ttok.img_ref_question(), None,
                                  None)]
    else:
        samples = [ds.make_sample(images[0], text, None, None),
                   ds.make_sample(images[1], ttok.audio_ref_question(), None,
                                  None, audio_mels=jmel.audio_to_mel_clips(
                                      _wave(5.0, 4)))]
    batch = tcollator.Collator(ttok.AnyRefTokenizer(), cfg,
                               roi=kind == "box")(samples)
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(batch["prompt_lens"][b])
        ids[b, BUCKET - n:] = batch["input_ids"][b, :n]
    out = {"input_ids": ids}
    for k in ("clip_images", "sam_images", "ref_images", "ref_valid",
              "roi_boxes", "audio_mels", "audio_valid"):
        if k in batch:
            out[k] = batch[k]
    return out


@pytest.fixture(scope="module")
def path_trees(jp):
    """{encoder path: (cfg, JAX tree, port tree)}; the fused config's SAM
    image is 512 pixels, so its tree is its own init."""
    out = {"unfused": (TINY, jp, None)}
    jf = janyref.init(jax.random.key(0), FUSED_CFG, dtype=jnp.float32)
    out["fused"] = (FUSED_CFG, jf, None)
    return {k: (c, j, tparams.from_numpy(jax.device_get(j), "cpu"))
            for k, (c, j, _) in out.items()}


@pytest.mark.parametrize("kind", ["crop", "box", "text_audio"])
@pytest.mark.parametrize("path", ["unfused", "fused"])
def test_generate_references_match_jax(path_trees, path, kind):
    """Greedy ids of the port equal the JAX ids, and the port's speculative
    ids equal them too (prompt-lookup decoding is lossless). The crop batch
    runs CLIP twice (the images, then the crops), both times on ``path``,
    with the JAX towers' output (module docstring)."""
    cfg, jparams, tparams_ = path_trees[path]
    batch = _ref_batch(cfg, kind)
    with path_env(path):
        want = jax.jit(functools.partial(janyref.generate,
                                         max_new_tokens=MNT),
                       static_argnums=(1,))(
            jparams, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    for spec in (False, True):
        with (jax_towers(jparams, cfg, path) if kind == "crop"
              else contextlib.nullcontext()) as calls:
            got = tanyref.generate(tparams_, cfg, batch, max_new_tokens=MNT,
                                   speculative=spec, draft_len=3,
                                   device="cpu", encoder_path=path)
        assert calls in (None, [2, 2])
        np.testing.assert_array_equal(got.output_ids.numpy(),
                                      np.asarray(want.output_ids))
        np.testing.assert_array_equal(got.seg_valid.numpy(),
                                      np.asarray(want.seg_valid))
        if not spec:
            np.testing.assert_allclose(got.low_res_masks.numpy(),
                                       np.asarray(want.low_res_masks),
                                       atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# the multimodal training forward
# ---------------------------------------------------------------------------
def test_train_forward_references_match_jax(jp, tp):
    """A crop, a text and an audio row (the counterpart of
    tests/test_anyref_e2e.py's multimodal step): the loss terms and the
    gradients of the LoRA and dense trainables (audio_projector among them)
    against the JAX package's value_and_grad."""
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (224, 300, 3), np.uint8)
    mask = np.zeros((224, 300), np.uint8)
    mask[40:150, 60:200] = 1
    ds = tbase.SegDataset(TINY)
    ans = ttok.seg_answer("it", itisseg=True)
    samples = [
        ds.make_sample(image, ttok.img_ref_question(), ans, mask[None],
                       ref_image=tbase.SegDataset.ref_crop(image,
                                                           [60, 0, 300, 224])),
        ds.make_sample(image, ttok.seg_question("the box"), ans, mask[None]),
        ds.make_sample(image, ttok.audio_ref_question(), ans, mask[None],
                       audio_mels=jmel.audio_to_mel_clips(_wave(3.0, 2)))]
    batch = tstep.device_batch(tcollator.Collator(
        ttok.AnyRefTokenizer(), TINY, train=True)(samples))
    assert {"ref_images", "audio_mels"} <= set(batch)
    lcfg = jlora.LoraConfig()
    jlp = jlora.init(jax.random.key(1), jp["llama"], lcfg)
    lrng = np.random.default_rng(11)
    for layer in jlp["layers"]:
        for t in layer.values():
            t["b"] = jnp.asarray(0.02 * lrng.standard_normal(t["b"].shape),
                                 jnp.float32)
    dense, frozen = jlora.split_trainable(jp)
    fn = jax.jit(jax.value_and_grad(jstep.loss_fn, argnums=(0, 1),
                                    has_aux=True), static_argnums=(3, 4))
    with path_env("fused"):
        (_, jmetrics), (jg_lora, jg_dense) = fn(
            jlp, dense, frozen, TINY, lcfg,
            {k: jnp.asarray(v) for k, v in batch.items()})
    lora_p = tparams.from_numpy(jax.device_get(jlp), device="cpu")
    tdense, tfrozen = tlora.split_trainable(tp)
    tdense = tstep.tree_map(lambda t: t.detach().clone(), tdense)
    for t in tstep.tree_leaves((lora_p, tdense)):
        t.requires_grad_(True)
    with jax_towers(jp, TINY, "fused") as calls:
        _, metrics, (g_lora, g_dense) = tstep.value_and_grad(
            lora_p, tdense, tfrozen, TINY, tlora.LoraConfig(), batch,
            encoder_path="fused")
    assert calls == [3, 3]
    for k in tstep.METRICS:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-3, err_msg=k)
    jleaves = jax.tree_util.tree_leaves((jg_lora, jg_dense))
    tleaves = tstep.tree_leaves((g_lora, g_dense))
    assert len(jleaves) == len(tleaves)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path((jg_lora, jg_dense))[0]]
    for path, got, want in zip(paths, tleaves, jleaves):
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=path)
    g_proj = _np(g_dense["audio_projector"]["w"])
    np.testing.assert_allclose(g_proj, np.asarray(
        jg_dense["audio_projector"]["w"]), rtol=0,
        atol=2e-2 * np.abs(g_proj).max())
    assert np.abs(g_proj).max() > 0
