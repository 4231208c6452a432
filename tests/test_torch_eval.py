"""The port's segmentation eval against the JAX package's, on the CPU: the
metrics, the harnesses' logic and artifacts under one stub predictor, the
harnesses end to end through real Predictors at anyref_tiny, and the eval
CLI.

Tolerances, each with its reason:
- the metrics: 1e-12 (both sides run the same numpy in float64);
- the stub harnesses: equal result dicts, byte-equal PNGs and text files
  (the same masks and ids reach both harnesses);
- end to end: ids equal and cIoU, gIoU, mIoU and F within 1e-3. The
  Predictors run the same weights on the "unfused" path (the JAX side with
  its four switches at 0), whose low-res masks agree within 2e-2 of their
  largest magnitude (tests/test_torch_generate.py); a pixel whose logit is
  that near 0 may flip, and a flip moves an IoU by 1 / union. The AVS
  reader's mel clips differ within tests/test_torch_references.py's limit.
"""

import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny as jtiny
from anyref_tpu.data import coco20i as jcoco20i
from anyref_tpu.data import reason as jreason
from anyref_tpu.data import refcoco as jrefcoco
from anyref_tpu.eval import harnesses as jharn
from anyref_tpu.eval import metrics as jmetrics
from anyref_tpu.eval import referseg as jreferseg
from anyref_tpu.eval import runner as jrunner
from anyref_tpu.models import anyref as janyref
from anyref_tpu.tokenizer import AnyRefTokenizer as JTokenizer
from anyref_tpu_torch import checkpoint
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny as ttiny
from anyref_tpu_torch.data import coco20i as tcoco20i
from anyref_tpu_torch.data import reason as treason
from anyref_tpu_torch.data import refcoco as trefcoco
from anyref_tpu_torch.eval import harnesses as tharn
from anyref_tpu_torch.eval import metrics as tmetrics
from anyref_tpu_torch.eval import referseg as treferseg
from anyref_tpu_torch.eval import runner as trunner
from anyref_tpu_torch.tokenizer import AnyRefTokenizer as TTokenizer
from anyref_tpu_torch.tools import eval as teval_cli

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent
METRIC_TOL = 1e-12
E2E_TOL = 1e-3
# the JAX init of INIT_KEY with lm_head's [SEG] column x SEG_SCALE answers
# [SEG] on some refs and not on others (both branches of the harnesses),
# with no greedy step near a tie (key 0 has a step whose top two logits lie
# 0.003 apart on the port's bf16 activations)
INIT_KEY = 1
SEG_SCALE = 10.0
MNT = 4
BUCKETS = (384,)
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """chip_smoke's data roots at a small size: 4 refCOCO val refs on 2
    images, 2 ReasonSeg images, COCO-20i split 0, one 5-frame AVS video."""
    root = str(tmp_path_factory.mktemp("eval_root"))
    chip_smoke.write_eval_root(root, (48, 64), 2)
    return root


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersection_and_union_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for K in (2, 5):
        out = rng.integers(0, K, (37, 29))
        tgt = rng.integers(0, K, (37, 29))
        tgt[rng.random(tgt.shape) < 0.1] = 255
        got = tmetrics.intersection_and_union(out, tgt, K, 255)
        want = jmetrics.intersection_and_union(out, tgt, K, 255)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=0, atol=METRIC_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_iou_matches_jax(seed):
    """Frames with and without an object; a no-object frame scores the
    background's agreement."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (6, 20, 24)).astype(np.float32)
    target = (rng.random((6, 20, 24)) > 0.6).astype(np.float32)
    target[[1, 4]] = 0
    got = tmetrics.mask_iou(logits, target)
    assert abs(got - jmetrics.mask_iou(logits, target)) <= METRIC_TOL
    empty = np.zeros((1, 20, 24), np.float32)
    assert abs(tmetrics.mask_iou(np.full_like(empty, -10.0), empty)
               - jmetrics.mask_iou(np.full_like(empty, -10.0), empty)) \
        <= METRIC_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f_measure_matches_jax(seed):
    """Empty-GT frames are skipped; all empty scores 0."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (5, 16, 18)).astype(np.float32)
    gt = (rng.random((5, 16, 18)) > 0.5).astype(np.float32)
    gt[2] = 0
    got = tmetrics.f_measure(logits, gt)
    assert 0 < got <= 1
    assert abs(got - jmetrics.f_measure(logits, gt)) <= METRIC_TOL
    zero = np.zeros_like(gt)
    assert tmetrics.f_measure(logits, zero) == \
        jmetrics.f_measure(logits, zero) == 0.0


def test_average_meter_matches_jax():
    """Sums, counts and averages; all_reduce in one process leaves them."""
    rng = np.random.default_rng(3)
    got, want = tmetrics.AverageMeter("a"), jmetrics.AverageMeter("a")
    for _ in range(5):
        v, n = rng.random(2), int(rng.integers(1, 4))
        got.update(v, n)
        want.update(v, n)
    got.all_reduce()
    want.all_reduce()
    np.testing.assert_array_equal(got.sum, want.sum)
    assert got.count == want.count
    np.testing.assert_array_equal(got.avg, want.avg)
    got.reset()
    assert got.sum == 0.0 and got.count == 0 and got.avg == 0.0


# ---------------------------------------------------------------------------
# the harnesses' logic under a stub predictor
# ---------------------------------------------------------------------------
class StubPredictor:
    """Masks and ids from a seed and each row's metadata, so that both
    packages' harnesses get the same answers: a third of the rows emit no
    [SEG] (None), the rest logits of the image's size."""

    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.device = "cpu"
        self.seed = seed

    def predict(self, batch):
        ids, masks = [], []
        for m in batch["_meta"]:
            key = f"{self.seed}|{m['file_name']}|{m.get('sentence')}"
            rng = np.random.default_rng(zlib.crc32(key.encode()))
            # byte tokens of printable ASCII (no newline: exp_gen.txt has a
            # line an answer), then an EOS (2) the harness drops
            row = rng.integers(3 + 32, 3 + 127, MNT + 2).astype(np.int32)
            row[rng.integers(0, MNT + 2)] = 2
            ids.append(row)
            h, w = int(m["height"]), int(m["width"])
            masks.append(None if rng.random() < 1 / 3 else
                         rng.normal(0.3, 2.0, (1, h, w)).astype(np.float32))
        return np.stack(ids), masks


def _tree(root):
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _readers(root, name):
    """(port reader, JAX reader) of one harness's data."""
    if name == "refcoco":
        return (trefcoco.RefCocoVal(root, "refcoco", "val"),
                jrefcoco.RefCocoVal(root, "refcoco", "val"))
    if name == "reason":
        return (treason.ReasonSeg(os.path.join(root, "reason"), "val"),
                jreason.ReasonSeg(os.path.join(root, "reason"), "val"))
    args = (os.path.join(root, "coco/train2017"),
            os.path.join(root, "coco/annotations/instances_train2017.json"),
            os.path.join(root, "samples_0.05_0.25.json"),
            os.path.join(root, "coco_20i/lists/coco/fss_list"))
    return (tcoco20i.Coco20i(*args, split=0, seed=1),
            jcoco20i.Coco20i(*args, split=0, seed=1))


@pytest.mark.parametrize("name,qualitative,workers", [
    ("refcoco", True, 4), ("refcoco", False, 0), ("reason", True, 4),
    ("coco20i", True, 0)])
def test_stub_evaluate_segmentation_matches_jax(eval_root, tmp_path, name,
                                                qualitative, workers):
    """The same answers through both packages' evaluate_segmentation: equal
    result dicts, and byte-equal pred_masks/*.png (with the qualitative
    _gt, _orig and _ref dumps), exp_gen.txt and result.txt."""
    out = {}
    for pkg, reader, tok, cfg, harness in (
            ("torch", _readers(eval_root, name)[0], TTokenizer(), ttiny(),
             treferseg),
            ("jax", _readers(eval_root, name)[1], JTokenizer(), jtiny(),
             jreferseg)):
        reader.cfg = cfg
        out[pkg] = harness.evaluate_segmentation(
            StubPredictor(cfg), reader, tok, out_dir=str(tmp_path / pkg),
            save_masks=True, save_qualitative=qualitative,
            num_workers=workers, progress=False)
    assert out["torch"] == out["jax"]
    assert out["torch"]["n"] > 0
    got, want = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert got == want
    pngs = [k for k in got if k.endswith(".png")]
    assert len(pngs) == out["torch"]["n"] * (
        (4 if name == "coco20i" else 3) if qualitative else 1)
    if qualitative:
        assert got["exp_gen.txt"].count(b"\n") == out["torch"]["n"]


def test_stub_evaluate_segmentation_limit_matches_jax(eval_root, tmp_path):
    treader, jreader = _readers(eval_root, "refcoco")
    treader.cfg, jreader.cfg = ttiny(), jtiny()
    got = treferseg.evaluate_segmentation(
        StubPredictor(ttiny()), treader, TTokenizer(), str(tmp_path / "t"),
        limit=2, progress=False)
    want = jreferseg.evaluate_segmentation(
        StubPredictor(jtiny()), jreader, JTokenizer(), str(tmp_path / "j"),
        limit=2, progress=False)
    assert got == want and got["n"] == 2
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


@pytest.mark.parametrize("task", ["object", "multi"])
def test_stub_evaluate_avs_matches_jax(eval_root, tmp_path, task):
    """mIoU over frames and F over the whole 5-frame group; the AVS reader's
    mel front end runs on the Predictor's device."""
    seen = []

    class Watch(StubPredictor):
        def predict(self, batch):
            seen.append(batch["audio_mels"].shape)
            return super().predict(batch)

    got = tharn.evaluate_avs(Watch(ttiny()), TTokenizer(), eval_root, task,
                             "test", str(tmp_path / "t"))
    want = jharn.evaluate_avs(StubPredictor(jtiny()), JTokenizer(),
                              eval_root, task, "test", str(tmp_path / "j"))
    assert got == want
    assert got["n"] == 5 and 0 < got["fscore"] <= 1
    assert seen == [(1, 3, 1, 128, 204)] * 5
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    # a limit cuts the group: no F-measure, as in the JAX harness
    assert tharn.evaluate_avs(StubPredictor(ttiny()), TTokenizer(),
                              eval_root, task, "test", str(tmp_path / "t"),
                              limit=3) == \
        jharn.evaluate_avs(StubPredictor(jtiny()), JTokenizer(), eval_root,
                           task, "test", str(tmp_path / "j"), limit=3)


# ---------------------------------------------------------------------------
# end to end at anyref_tiny
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port tree): the JAX init of INIT_KEY with lm_head's [SEG]
    column x SEG_SCALE, bridged by params.from_numpy."""
    cfg = jtiny()
    jp = janyref.init(jax.random.key(INIT_KEY), cfg, dtype=jnp.float32)
    lm = jp["llama"]["lm_head"]
    jp["llama"]["lm_head"] = lm.at[:, cfg.tokens.seg].multiply(SEG_SCALE)
    return jp, tparams.from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture
def unfused(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


def _predictors(weights):
    jp, tp = weights
    record = chip_smoke.RecordingPredictor
    return (record(jrunner.Predictor(jp, jtiny(), max_new_tokens=MNT,
                                     prompt_buckets=BUCKETS)),
            record(trunner.Predictor(tp, ttiny(), max_new_tokens=MNT,
                                     prompt_buckets=BUCKETS, device="cpu",
                                     encoder_path="unfused")))


def _same_calls(jrec, trec):
    """Equal ids, and a non-empty mask among the port's answers."""
    assert len(jrec.calls) == len(trec.calls) > 0
    for (ji, jm), (ti, tm) in zip(jrec.calls, trec.calls):
        np.testing.assert_array_equal(ti, ji)
        assert [m is None for m in tm] == [m is None for m in jm]
    assert chip_smoke.mask_stats(trec.calls)[0] > 0


def test_evaluate_referseg_matches_jax(weights, unfused, eval_root,
                                       tmp_path):
    jrec, trec = _predictors(weights)
    want = jreferseg.evaluate_referseg(jrec, JTokenizer(), eval_root,
                                       "refcoco_val", str(tmp_path / "j"))
    got = treferseg.evaluate_referseg(trec, TTokenizer(), eval_root,
                                      "refcoco_val", str(tmp_path / "t"))
    _same_calls(jrec, trec)
    g, w = got["refcoco_val"], want["refcoco_val"]
    assert g["n"] == w["n"] == 4
    for k in ("ciou", "giou"):
        assert abs(g[k] - w[k]) <= E2E_TOL, (k, g, w)
    assert (tmp_path / "t" / "refcoco" / "val" / "result.txt").exists()


def test_evaluate_avs_matches_jax(weights, unfused, eval_root, tmp_path):
    jrec, trec = _predictors(weights)
    want = jharn.evaluate_avs(jrec, JTokenizer(), eval_root, "object",
                              "test", str(tmp_path / "j"))
    got = tharn.evaluate_avs(trec, TTokenizer(), eval_root, "object",
                             "test", str(tmp_path / "t"))
    _same_calls(jrec, trec)
    assert got["n"] == want["n"] == 5
    for k in ("miou", "fscore"):
        assert abs(got[k] - want[k]) <= E2E_TOL, (k, got, want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_help():
    r = subprocess.run([sys.executable, "-m", "anyref_tpu_torch.tools.eval",
                        "--help"], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "{referseg,reason,coco20i,avs,refer_inv}" in r.stdout
    for flag in ("--ckpt", "--tokenizer", "--device", "--encoder_path",
                 "--limit", "--max_new_tokens", "--preset", "--inv_dataset",
                 "--roi"):
        assert flag in r.stdout


def test_cli_referseg_matches_in_process(eval_root, tmp_path, capsys):
    """--preset tiny --device cpu --limit 1 on a saved tiny checkpoint
    prints what evaluate_referseg gives in process on the same weights at
    the CLI's referseg rephrase weight, 0.1."""
    cfg = ttiny()
    p = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                     device="cpu")
    p["llama"]["lm_head"][:, cfg.tokens.seg] *= chip_smoke.EVAL_TINY_SEG_SCALE
    ckpt = str(tmp_path / "tiny.pt")
    checkpoint.save_params(ckpt, p)
    res = teval_cli.main(["referseg", "--ckpt", ckpt, "--data_root",
                          eval_root, "--out_root", str(tmp_path / "cli"),
                          "--preset", "tiny", "--device", "cpu", "--limit",
                          "1", "--max_new_tokens", "2"])
    printed = capsys.readouterr().out.splitlines()[-1]
    assert printed == repr(res)
    pred = trunner.Predictor(p, cfg.scaled(rephrase_weight=0.1),
                             max_new_tokens=2, device="cpu")
    want = treferseg.evaluate_referseg(pred, TTokenizer(), eval_root,
                                       out_root=str(tmp_path / "in"),
                                       limit=1)
    assert res == want and res["refcoco_val"]["n"] == 1


def test_cli_refuses_cpu_without_gpu(monkeypatch, tmp_path):
    """No --device and no GPU: the CLI raises instead of running on the
    CPU."""
    ckpt = str(tmp_path / "p.pt")
    checkpoint.save_params(ckpt, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval_cli.main(["referseg", "--ckpt", ckpt, "--preset", "tiny"])
