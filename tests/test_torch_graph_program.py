"""The Predictor's request program in the form the card captures into one
CUDA graph (anyref_tpu_torch/eval/runner.py): the prefix, the decode loop's
predicate and body over a carry of tensors, and the suffix with the meta
packing, at anyref_tiny() on the CPU, where the loop runs on the host.

No part of it may read the device: under a dispatch mode that refuses every
op whose output a host read decides (``.item()``, ``bool()``, ``nonzero``
and the rest), and every upload of host data, the whole program runs, and
only the host loop's own ``bool(cond)`` stands outside it. The carry loops against the JAX
Predictor's ``lax.while_loop`` programs: ids, [SEG] slots and decode passes
EQUAL, the whole meta array packed as the JAX ``run`` packs it, and the
low-res logits within tests/test_torch_generate.py's atol = rtol = 2e-2."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny as janyref_tiny
from anyref_tpu.eval.runner import Predictor as JPredictor
from anyref_tpu.models import anyref as janyref
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.data.preprocess import crop_box_np
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.ops.mel import audio_to_mel_clips
from anyref_tpu_torch.ops.quant import quantize_llama
from anyref_tpu_torch.tokenizer import (AnyRefTokenizer, audio_ref_question,
                                        img_ref_question, seg_question)
from tests.torch_dispatch_modes import NoDeviceReads
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = anyref_tiny()
MNT = 6
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")
TEXTS = ("the cat", "the red cat on the red mat near the open door")
@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


@pytest.fixture(scope="module")
def images():
    # shortest edge 224: CLIP's resize is the identity (no PIL involved)
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (224, 300, 3), np.uint8),
            rng.integers(0, 256, (280, 224, 3), np.uint8)]


def _batch(images, kind: str, uint8: bool = True, cfg=CFG) -> dict:
    """The Server's collation of two requests: two text prompts, or a
    crop, a box or an audio reference beside a text one."""
    ds = SegDataset(cfg, uint8_images=uint8)
    im = images[0]
    h, w = im.shape[:2]
    text = [ds.make_sample(m, seg_question(t), None, None)
            for m, t in zip(images, TEXTS)]
    ref = {"crop": dict(ref_image=crop_box_np(im, np.asarray(
               [40, 20, 200, 180]))),
           "box": dict(ref_bbox=np.asarray([30, 20, 250, 200], np.float32)
                       / np.asarray([w, h, w, h], np.float32)),
           "audio": dict(audio_mels=audio_to_mel_clips(
               np.random.default_rng(3).standard_normal(16000 * 3)
               .astype(np.float32), device="cpu").numpy())}
    if kind == "text":
        rows = text
    else:
        q = audio_ref_question() if kind == "audio" else img_ref_question()
        rows = [ds.make_sample(im, q, None, None, **ref[kind]), text[1]]
    return Collator(AnyRefTokenizer(), cfg, roi=kind == "box")(rows)


def _tree(int8: bool = False, cfg=CFG):
    p = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                     device="cpu")
    if int8:
        p["llama"] = quantize_llama(p["llama"])
    return p


# the fused encoder path where both fused SAM gates open (a 512-pixel SAM
# image, windows of 8)
CFG512 = dataclasses.replace(CFG, sam=dataclasses.replace(
    CFG.sam, image_size=512, window_size=8))
# (batch kind, rephrase, int8, Predictor arguments)
CASES = {
    "greedy": ("text", False, False, {}),
    "speculative": ("text", False, False, dict(speculative=True,
                                               draft_len=3)),
    "speculative_force_accept": ("text", False, False, dict(
        speculative=True, draft_len=3, max_accept=2, force_accept=True)),
    "int8": ("text", False, True, {}),
    "rephrase": ("text", True, False, {}),
    "rephrase_speculative": ("text", True, False, dict(speculative=True,
                                                       draft_len=3)),
    "crop": ("crop", False, False, {}),
    "audio": ("audio", False, False, {}),
    "box": ("box", False, False, dict(speculative=True, draft_len=3)),
    "fused": ("text", False, False, dict(encoder_path="fused")),
    "fused_block": ("crop", False, False, dict(encoder_path="fused_block")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_reads_nothing_from_the_device(case, images):
    """Prefix, predicate, body and suffix of the Predictor's program under
    NoDeviceReads; the host loop's bool(cond) alone outside it. The
    program's meta equals the Predictor's own result on the same batch."""
    kind, rephrase, int8, kw = CASES[case]
    kw = {"encoder_path": "unfused", **kw}
    cfg = CFG512 if kw["encoder_path"] != "unfused" else CFG
    cfg = cfg.scaled(rephrase_weight=0.1) if rephrase else cfg
    pred = Predictor(_tree(int8, cfg), cfg, max_new_tokens=MNT,
                     device="cpu", **kw)
    batch = _batch(images, kind, cfg=cfg)
    host, _, B = pred._inputs(batch)
    dev = {k: torch.from_numpy(v) for k, v in host.items()}
    passes = 0
    with torch.inference_mode():
        with NoDeviceReads():
            loop, finish = pred._program(dev)
        while True:
            with NoDeviceReads():
                go = loop.cond(loop.carry)
            assert go.dim() == 0 and go.dtype == torch.bool
            if not bool(go):
                break
            with NoDeviceReads():
                loop.body(loop.carry)
            passes += 1
        with NoDeviceReads():
            meta, low = finish(loop.carry)
    (want_meta, want_low), _, _ = pred.predict_async(batch)
    torch.testing.assert_close(meta, want_meta, rtol=0, atol=0)
    torch.testing.assert_close(low, want_low, rtol=0, atol=0)
    assert int(meta[0, -1]) == passes >= 1
    assert meta.dtype == torch.int32 and meta.shape == (B, MNT + 1 + (
        cfg.max_seg_per_sample))


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["greedy", "speculative_force_accept"])
def test_carry_loop_matches_jax_while_loop(speculative, images):
    """The port's Predictor (carry loop on the host) against the JAX
    Predictor's compiled run (lax.while_loop) on the same fp32 weights and
    batch: meta packed identically (ids, [SEG] slots, the pass count on
    every row), masks within the slice tolerance."""
    jcfg = janyref_tiny()
    jp = janyref.init(jax.random.key(0), jcfg, dtype=jnp.float32)
    tp = tparams.from_numpy(jax.device_get(jp), device="cpu")
    kw = dict(speculative=True, draft_len=3, max_accept=2,
              force_accept=True) if speculative else {}
    batch = _batch(images, "text", uint8=False)
    jpred = JPredictor(jp, jcfg, max_new_tokens=MNT, **kw)
    (jmeta, jlow), _, _ = jpred.predict_async(batch)
    tpred = Predictor(tp, CFG, max_new_tokens=MNT, device="cpu",
                      encoder_path="unfused", **kw)
    (meta, low), _, B = tpred.predict_async(batch)
    jmeta = np.asarray(jmeta)
    np.testing.assert_array_equal(meta.numpy(), jmeta)
    assert len(set(jmeta[:, -1].tolist())) == 1 and jmeta[0, -1] >= 1
    np.testing.assert_allclose(low.float().numpy(),
                               np.asarray(jlow, np.float32),
                               atol=2e-2, rtol=2e-2)
    ids, _ = tpred.complete(((meta, low), batch, B))
    np.testing.assert_array_equal(ids, jmeta[:B, :MNT])
    assert tpred.decode_passes_total == int(jmeta[0, -1])


def test_fixed_steps_equals_early_exit(images):
    """run_loop with fixed_steps (the exported program's form, no read at
    all) gives the early exit's ids, states and [SEG] slots; only the step
    count differs."""
    pred = Predictor(_tree(), CFG, max_new_tokens=MNT, device="cpu",
                     encoder_path="unfused")
    host, _, _ = pred._inputs(_batch(images, "text", uint8=False))
    dev = {k: torch.from_numpy(v) for k, v in host.items()}
    out = {}
    with torch.inference_mode():
        for fixed in (None, MNT):
            loop, finish = tanyref.generate_program(
                pred.params, CFG, dev, max_new_tokens=MNT, device="cpu",
                encoder_path="unfused")
            if fixed is None:
                out[fixed] = finish(tanyref.run_loop(loop))
                continue
            with NoDeviceReads():
                out[fixed] = finish(tanyref.run_loop(loop, fixed))
    early, full = out[None], out[MNT]
    for field in ("output_ids", "seg_valid", "low_res_masks",
                  "seg_embeddings"):
        torch.testing.assert_close(getattr(full, field),
                                   getattr(early, field), rtol=0, atol=0)
    assert int(full.decode_passes) == MNT >= int(early.decode_passes)


def test_predictor_counts_the_bytes_it_stages(images):
    """h2d_bytes_total adds, a call, the bytes of the inputs the batch
    uploads (its prompts padded into their bucket, its rows into the batch
    bucket); a handle is the plain (outputs, batch, rows) triple."""
    pred = Predictor(_tree(), CFG, max_new_tokens=2, device="cpu",
                     encoder_path="unfused")
    batch = _batch(images, "text")
    host, _, _ = pred._inputs(batch)
    want = sum(v.nbytes for v in host.values())
    assert want > 0
    for n in (1, 2):
        handle = pred.predict_async(batch)
        assert type(handle) is tuple and len(handle) == 3
        pred.complete(handle)
        assert pred.h2d_bytes_total == n * want
