"""The serving API a benchmark drives, on the CPU at anyref_tiny(): the
Server's reset_stats and its epoch, Request.callback, and the Predictor's
host -> device and device -> host byte counters against the JAX package's
on the same batch."""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.eval.runner import Predictor as JPredictor
from anyref_tpu.models import anyref as janyref
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.serve import Request, Server
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

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
