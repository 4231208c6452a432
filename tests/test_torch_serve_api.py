"""The serving API a benchmark drives, on the CPU at anyref_tiny(): the
Server's reset_stats and its epoch, Request.callback, and the Predictor's
host -> device and device -> host byte counters against the JAX package's
on the same batch; the Server's crop, box, audio and text requests, their
batching (a crop and a box never share a batch, arrival order kept), and
the box reaching encode_roi, where the JAX Server's collator drops it."""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu import tokenizer as jtok
from anyref_tpu.config import anyref_tiny
from anyref_tpu.data import base as jbase
from anyref_tpu.data import collator as jcollator
from anyref_tpu.eval.runner import Predictor as JPredictor
from anyref_tpu.models import anyref as janyref
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.ops.mel import audio_to_mel_clips
from anyref_tpu_torch.serve import Request, Server
from anyref_tpu_torch.tokenizer import (AnyRefTokenizer, audio_ref_question,
                                        img_ref_question, seg_question)

CFG = anyref_tiny()
MNT = 4
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
def tp():
    return tparams.init(CFG, torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (224, 300, 3), np.uint8),
            rng.integers(0, 256, (280, 224, 3), np.uint8)]


def _server(tp):
    return Server(tp, CFG, max_batch=2, max_new_tokens=MNT,
                  preprocess_workers=1, device="cpu", encoder_path="unfused")


def test_reset_stats_zeroes_counters_and_clamps_wait(tp, images):
    """reset_stats zeroes every stage counter and the Predictor's pass and
    byte counters; the first batch after it counts its idle wait from the
    reset, not from the start of the idle stretch."""
    srv = _server(tp)
    try:
        assert "error" not in srv.segment(images[0], TEXTS[0])
        p = srv.predictor
        assert srv.stats["batches"] == 1 and p.h2d_bytes_total > 0
        assert p.d2h_bytes_total > 0 and p.completed_batches == 1
        time.sleep(0.5)                 # the device loop idles
        t_reset = time.time()
        srv.reset_stats()
        assert t_reset <= srv._stats_epoch <= time.time()
        assert all(v == 0 for v in srv.stats.values()), srv.stats
        assert (p.decode_passes_total, p.completed_batches,
                p.h2d_bytes_total, p.d2h_bytes_total) == (0, 0, 0, 0)
        time.sleep(0.1)
        assert "error" not in srv.segment(images[1], TEXTS[1])
        t_done = time.time()
        assert srv.stats["batches"] == 1 and srv.stats["rows"] == 1
        # the wait began at the reset, 0.5 s after the loop went idle
        assert 0 < srv.stats["wait_ms"] < (t_done - t_reset) * 1e3
    finally:
        srv.shutdown()


def test_callback_fires_once(tp, images):
    """Each request's callback runs exactly once, with the result, after
    result() can return it; a callback that raises is logged and the
    loop serves the next request."""
    calls = []
    seen = threading.Event()

    def ok(result):
        calls.append(result)
        seen.set()

    def bad(result):
        raise RuntimeError("callback failure")

    srv = _server(tp)
    try:
        r1 = srv.submit(Request(image=images[0], text=TEXTS[0], callback=ok))
        r2 = srv.submit(Request(image=images[1], text=TEXTS[1],
                                callback=bad))
        res = r1.result(timeout=120)
        assert seen.wait(timeout=120)
        assert "error" not in r2.result(timeout=120)
        r3 = srv.submit(Request(image=images[1], text=TEXTS[1], callback=ok))
        assert "error" not in r3.result(timeout=120)
        deadline = time.time() + 30
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        srv.shutdown()
    assert len(calls) == 2 and calls[0] is res and "mask" in res
    # a finished request is not finished (nor called back) again
    Server._finish(r1, {"error": "late"})
    assert len(calls) == 2 and r1.result() is res


def test_byte_counters_match_jax(jp, images):
    """One batch of two uint8 requests: the bytes the port's Predictor
    uploads and fetches equal the JAX Predictor's count (bf16 masks, one
    [SEG] slot fetched, as the Server asks)."""
    ds = SegDataset(CFG, uint8_images=True)
    batch = Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])
    kw = dict(max_new_tokens=MNT, batch_buckets=(2,),
              mask_fetch_dtype="bfloat16", fetch_segs=1)
    want = JPredictor(jp, CFG, **kw)
    want.predict(batch)
    got = Predictor(tparams.from_numpy(jax.device_get(jp), device="cpu"),
                    CFG, device="cpu", encoder_path="unfused", **kw)
    got.predict(batch)
    assert got.h2d_bytes_total == want.h2d_bytes_total > 0
    assert got.d2h_bytes_total == want.d2h_bytes_total > 0


# ---------------------------------------------------------------------------
# image-crop, RoI-box and audio requests
# ---------------------------------------------------------------------------
ROI = np.asarray([30.0, 20.0, 250.0, 200.0])   # pixel xyxy in images[0]


def _wave(seconds: float = 5.0) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.1 * rng.standard_normal(t.shape)
            + 0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def _requests(images):
    """A crop, an audio, a box and a text request, in that order."""
    crop = SegDataset.ref_crop(images[1], [0, 30, 224, 280])
    return [Request(image=images[0], ref_image=crop),
            Request(image=images[1], audio_waveform=_wave()),
            Request(image=images[0], roi_xyxy=ROI),
            Request(image=images[1], text=TEXTS[1])]


def _recording(srv):
    """Records each batch the Server's Predictor is handed."""
    seen = []
    run = srv.predictor.predict_async

    def predict_async(batch):
        seen.append(batch)
        return run(batch)
    srv.predictor.predict_async = predict_async
    return seen


def _predictor(tp):
    """The Server's Predictor settings."""
    return Predictor(tp, CFG, speculative=True, max_new_tokens=MNT,
                     batch_buckets=(2,), mask_fetch_dtype="bfloat16",
                     fetch_segs=1, device="cpu", encoder_path="unfused")


def _samples(images):
    """The requests of _requests as the Server's preprocess builds them."""
    ds = SegDataset(CFG, uint8_images=True)
    h, w = images[0].shape[:2]
    return [
        ds.make_sample(images[0], img_ref_question(), None, None,
                       ref_image=SegDataset.ref_crop(images[1],
                                                     [0, 30, 224, 280])),
        ds.make_sample(images[1], audio_ref_question(), None, None,
                       audio_mels=audio_to_mel_clips(
                           _wave(), device="cpu").numpy()),
        ds.make_sample(images[0], img_ref_question(), None, None,
                       ref_bbox=(ROI / np.asarray([w, h, w, h])).astype(
                           np.float32)),
        ds.make_sample(images[1], seg_question(TEXTS[1]), None, None)]


def test_server_serves_every_reference_kind(tp, images):
    """Crop, audio, box, text with max_batch 2: two full batches, [crop,
    audio] and [box, text] (the box batch in RoI mode), and each answer's
    ids equal the Predictor's (generate's) on the same batch."""
    srv = Server(tp, CFG, max_batch=2, max_new_tokens=MNT,
                 preprocess_workers=1, fill_wait_ms=30000.0, device="cpu",
                 encoder_path="unfused")
    seen = _recording(srv)
    try:
        reqs = [srv.submit(r) for r in _requests(images)]
        results = [r.result(timeout=300) for r in reqs]
    finally:
        srv.shutdown()
    assert all("error" not in r for r in results), results
    assert srv.stats["batches"] == 2 and srv.stats["rows"] == 4
    assert "ref_images" in seen[0] and "audio_mels" in seen[0]
    assert "roi_boxes" in seen[1] and "ref_images" not in seen[1]
    np.testing.assert_array_equal(seen[0]["audio_valid"], [False, True])
    np.testing.assert_array_equal(seen[1]["ref_valid"], [True, False])
    samples = _samples(images)
    pred = _predictor(tp)
    want = [pred.predict(Collator(AnyRefTokenizer(), CFG)(samples[:2]))[0],
            pred.predict(Collator(AnyRefTokenizer(), CFG,
                                  roi=True)(samples[2:]))[0]]
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res["output_ids"], want[i // 2][i % 2])


def test_server_box_reaches_encode_roi(tp, images):
    """The box request's answer equals the Predictor's given roi_boxes, and
    differs from the same batch without them (the JAX Server's behaviour:
    test_reference_collator_drops_the_box)."""
    srv = Server(tp, CFG, max_batch=2, max_new_tokens=MNT,
                 preprocess_workers=1, device="cpu", encoder_path="unfused")
    try:
        res = srv.submit(Request(image=images[0], roi_xyxy=ROI)).result(
            timeout=300)
    finally:
        srv.shutdown()
    assert "error" not in res
    batch = Collator(AnyRefTokenizer(), CFG, roi=True)(_samples(images)[2:3])
    np.testing.assert_array_equal(batch["ref_valid"], [True])
    pred = _predictor(tp)
    with_box = pred.predict(batch)[0][0]
    no_box = pred.predict({k: v for k, v in batch.items()
                           if k not in ("roi_boxes", "ref_valid")})[0][0]
    np.testing.assert_array_equal(res["output_ids"], with_box)
    assert not np.array_equal(with_box, no_box)


def test_server_keeps_crops_and_boxes_apart_in_order(tp, images):
    """A crop, a box and a crop submitted back to back: three batches in
    arrival order (the box closes the crop's group and opens its own; a
    text request joins the box's)."""
    srv = Server(tp, CFG, max_batch=2, max_new_tokens=MNT,
                 preprocess_workers=1, fill_wait_ms=30000.0, device="cpu",
                 encoder_path="unfused")
    seen = _recording(srv)
    crop = SegDataset.ref_crop(images[1], [0, 30, 224, 280])
    try:
        reqs = [srv.submit(r) for r in (
            Request(image=images[0], ref_image=crop),
            Request(image=images[0], roi_xyxy=ROI),
            Request(image=images[1], text=TEXTS[0]),
            Request(image=images[1], ref_image=crop))]
        results = [r.result(timeout=300) for r in reqs]
    finally:
        srv.shutdown()
    assert all("error" not in r for r in results), results
    kinds = [("ref_images" in b, "roi_boxes" in b,
              [int(n) for n in b["prompt_lens"]]) for b in seen]
    assert [k[:2] for k in kinds] == [(True, False), (False, True),
                                      (True, False)], kinds
    assert [len(k[2]) for k in kinds] == [1, 2, 1]
    assert srv.stats["rows"] == 4


def test_reference_collator_drops_the_box(images):
    """The fault the port's Server repairs, at the JAX package's collator:
    its Server collates with train=False (roi=False), so an RoI sample gets
    ref_valid false and no roi_boxes, and generate never sees the box."""
    h, w = images[0].shape[:2]
    sample = jbase.SegDataset(CFG, uint8_images=True).make_sample(
        images[0], jtok.img_ref_question(), None, None,
        ref_bbox=ROI / np.asarray([w, h, w, h]))
    batch = jcollator.Collator(jtok.AnyRefTokenizer(), CFG,
                               train=False)([sample])
    assert "roi_boxes" not in batch
    assert not batch["ref_valid"].any()
    assert not batch["ref_images"].any()
    ours = Collator(AnyRefTokenizer(), CFG, roi=True)([
        SegDataset(CFG, uint8_images=True).make_sample(
            images[0], img_ref_question(), None, None,
            ref_bbox=ROI / np.asarray([w, h, w, h]))])
    assert ours["ref_valid"].all() and "ref_images" not in ours
    np.testing.assert_allclose(ours["roi_boxes"][0],
                               ROI / np.asarray([w, h, w, h]), rtol=1e-6)
