"""The port's demo, export and AVS-refinement CLIs and its runtime utilities
against the JAX package's, on the CPU.

- demo: the JAX CLI (tools/demo.py, its checkpoint loader handed the JAX
  tree) and the port's (``--device cpu --encoder_path unfused``, the JAX
  side under its four "unfused" switches at 0) on the same weights, image
  and text: the same answer, and mask PNGs that differ only where the JAX
  mask logit lies within DEMO_NEAR_ZERO of 0 (fp32; the low-res masks agree
  within 1e-4, tests/test_torch_generate.py). Both refuse a run without a
  reference.
- export: the CLI's artifact gives what export_sam_decoder's does, bit for
  bit (tests/test_torch_export.py holds that against the JAX decoder).
- convert_avs_masks: the JAX CLI (its ViT-H configuration swapped for
  anyref_tiny's SAM, which the port's CLI takes as ``--preset tiny``) and
  the port's on one synthetic AVSBench root and one SAM .pth of the
  reference's layout, both in bf16 as the CLIs convert it: the same
  summary, the same files, and masks that differ only where the JAX logit
  lies within AVS_NEAR_ZERO of 0 relative to its largest magnitude (two
  bf16 encoders that round at other points; test_torch_eval.py's 2e-2).
- utils: Timer, ProgressTimer and Logger as the JAX ones; trace writes a
  Chrome trace holding an annotate region.
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import anyref_tpu.checkpoint as jcheckpoint
import anyref_tpu.eval.runner as jrunner
from anyref_tpu.config import SamConfig as JSamConfig
from anyref_tpu.config import anyref_tiny as jtiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models.sam import predictor as jpredictor
from anyref_tpu.utils import logging as jlogging
from anyref_tpu_torch import checkpoint
from anyref_tpu_torch import export as texport
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch import utils as tutils
from anyref_tpu_torch.config import anyref_tiny as ttiny
from anyref_tpu_torch.ops.resize import postprocess_low_res_np
from anyref_tpu_torch.tools import convert_avs_masks as tavs_cli
from anyref_tpu_torch.tools import demo as tdemo
from anyref_tpu_torch.tools import export as texport_cli

import chip_smoke
from tools import convert_avs_masks as javs_cli
from tools import demo as jdemo

DEMO_NEAR_ZERO = 1e-3
AVS_NEAR_ZERO = 2e-2
# the JAX init of INIT_KEY with lm_head's [SEG] column x SEG_SCALE answers
# [SEG] to the demo's question (tests/test_torch_eval.py's weights)
INIT_KEY = 1
SEG_SCALE = 10.0
MNT = 4
UNFUSED_ENV = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
               "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")


@pytest.fixture
def unfused(monkeypatch):
    for name in UNFUSED_ENV:
        monkeypatch.setenv(name, "0")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX tree, the port's params file of the same weights)."""
    cfg = jtiny()
    jp = janyref.init(jax.random.key(INIT_KEY), cfg, dtype=jnp.float32)
    lm = jp["llama"]["lm_head"]
    jp["llama"]["lm_head"] = lm.at[:, cfg.tokens.seg].multiply(SEG_SCALE)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    checkpoint.save_params(path, tparams.from_numpy(jax.device_get(jp),
                                                    device="cpu"))
    return jp, path


@pytest.fixture(scope="module")
def image_png(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("img") / "img.png")
    chip_smoke.write_image(path, np.random.default_rng(0), 48, 64)
    return path


def _png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def test_demo_cli_text_matches_jax(weights, image_png, unfused, monkeypatch,
                                   tmp_path, capsys):
    jp, ckpt = weights
    calls = []

    class Recording(jrunner.Predictor):
        def predict(self, batch):
            out = super().predict(batch)
            calls.append(out)
            return out

    monkeypatch.setattr(jcheckpoint, "load_params", lambda path: jp)
    monkeypatch.setattr(jrunner, "Predictor", Recording)
    jout, tout = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    argv = ["--ckpt", ckpt, "--image", image_png, "--text", "the cat",
            "--preset", "tiny", "--max_new_tokens", str(MNT)]
    monkeypatch.setattr(sys, "argv", ["demo.py"] + argv + ["--out", jout])
    jdemo.main()
    jprinted = capsys.readouterr().out.splitlines()
    ids, mask = tdemo.main(argv + ["--out", tout, "--device", "cpu",
                                   "--encoder_path", "unfused"])
    tprinted = capsys.readouterr().out.splitlines()
    (jids, jmasks), = calls
    np.testing.assert_array_equal(ids, jids)
    assert tprinted[0] == jprinted[0] and tprinted[0].startswith(
        "model says:")
    assert jmasks[0] is not None, "the weights must answer [SEG]"
    got, want = _png(tout), _png(jout)
    assert got.shape == want.shape == (48, 64) and got.any()
    np.testing.assert_array_equal(got > 0, mask > 0)
    logit = jmasks[0][0]
    flips = (got > 0) != (want > 0)
    assert not (flips & (np.abs(logit) > DEMO_NEAR_ZERO)).any()
    assert tprinted[1] == f"mask -> {tout} ({int(mask.sum())} px)"


def test_demo_cli_requires_a_reference(weights, image_png, monkeypatch):
    _, ckpt = weights
    with pytest.raises(SystemExit):
        tdemo.main(["--ckpt", ckpt, "--image", image_png, "--preset",
                    "tiny", "--device", "cpu"])
    monkeypatch.setattr(jcheckpoint, "load_params", lambda path: {})
    monkeypatch.setattr(sys, "argv", ["demo.py", "--ckpt", ckpt, "--image",
                                      image_png, "--preset", "tiny"])
    with pytest.raises(SystemExit):
        jdemo.main()


def test_export_cli_matches_in_process(weights, tmp_path, capsys):
    _, ckpt = weights
    out = str(tmp_path / "dec.pt2")
    texport_cli.main(["sam-decoder", "--ckpt", ckpt, "--out", out,
                      "--preset", "tiny", "--num_points", "4", "--device",
                      "cpu"])
    assert capsys.readouterr().out.strip() == \
        f"wrote {out} ({os.path.getsize(out)} bytes)"
    sam = checkpoint.load_params(ckpt, device="cpu")["sam"]
    cfg = ttiny().sam
    rng = np.random.default_rng(0)
    g = cfg.embedding_size
    args = (torch.from_numpy(rng.standard_normal(
                (1, cfg.prompt_embed_dim, g, g)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, cfg.image_size, (1, 4, 2))
                             .astype(np.float32)),
            torch.tensor([[1.0, 0.0, 2.0, 3.0]]))
    got = texport.load_exported(out)(*args)
    want = texport.sam_decoder_fn(sam, cfg)(*args)
    assert got[0].shape == (1, 3, 4 * g, 4 * g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_avs_refinement_cli_matches_jax(tmp_path, unfused, monkeypatch,
                                        capsys):
    cfg = ttiny()
    g = torch.Generator().manual_seed(0)
    sd = chip_smoke.reference_state_dicts(
        cfg, lambda *shape: torch.randn(shape, generator=g) * 0.1)["sam"]
    pth = str(tmp_path / "sam_tiny.pth")
    torch.save(sd, pth)
    roots = {}
    for side in ("j", "t"):
        roots[side] = str(tmp_path / side)
        n = chip_smoke.write_avs_refine_root(roots[side], (48, 64))
    calls = []

    class Recording(jpredictor.SamPredictor):
        def predict(self, **kw):
            out = super().predict(**kw)
            calls.append((out, self._input_hw, self._orig_hw))
            return out

    monkeypatch.setattr(JSamConfig, "vit_h", classmethod(
        lambda cls: jtiny().sam))
    monkeypatch.setattr(jpredictor, "SamPredictor", Recording)
    monkeypatch.setattr(sys, "argv", [
        "convert_avs_masks.py", "--sam_ckpt", pth, "--avs_root", roots["j"],
        "--iou_threshold", "0.0"])
    javs_cli.main()
    jprinted = capsys.readouterr().out.splitlines()
    kept = tavs_cli.main(["--sam_ckpt", pth, "--avs_root", roots["t"],
                          "--iou_threshold", "0.0", "--preset", "tiny",
                          "--device", "cpu", "--encoder_path", "unfused"])
    tprinted = capsys.readouterr().out.splitlines()
    assert kept == (n, n) and len(calls) == n
    assert tprinted == [line.replace(roots["j"], roots["t"])
                        for line in jprinted]
    assert tprinted[-1] == f"refined {n}/{n} masks (IoU >= 0.0)"
    out = os.path.join("s4_data", "gt_masks_sam", "train", "dog_barking",
                       "v1")
    names = sorted(os.listdir(os.path.join(roots["j"], out)))
    assert names == sorted(os.listdir(os.path.join(roots["t"], out))) == \
        ["v1_1.png", "v1_2.png"]
    for name, ((masks, _, low), in_hw, orig_hw) in zip(names, calls):
        want = _png(os.path.join(roots["j"], out, name)) > 0
        got = _png(os.path.join(roots["t"], out, name)) > 0
        best = [i for i in range(3) if (masks[i] == want).all()][0]
        logit = postprocess_low_res_np(np.asarray(low, np.float32)[best],
                                       cfg.sam.image_size, in_hw, orig_hw)
        flips = got != want
        assert not (flips & (np.abs(logit) > AVS_NEAR_ZERO *
                             np.abs(logit).max())).any()


def test_timer_progress_and_logger_match_jax(tmp_path, monkeypatch):
    for mod in (tutils, jlogging):
        with mod.Timer("x") as t:
            pass
        assert 0 <= t.elapsed < 1
    monkeypatch.setattr("time.time", lambda: 100.0)
    got = tutils.ProgressTimer(10)
    want = jlogging.ProgressTimer(10)
    monkeypatch.setattr("time.time", lambda: 102.0)
    assert got.update(2) == want.update(2) == "2/10 (1.00/s, eta 0.1 min)"
    monkeypatch.undo()
    buf = io.StringIO()
    monkeypatch.setattr(sys, "stdout", buf)
    log = tutils.Logger(str(tmp_path / "log.txt"))
    print("hello")
    log.flush()
    log.close()
    assert sys.stdout is buf and buf.getvalue() == "hello\n"
    assert (tmp_path / "log.txt").read_text() == "hello\n"


def test_trace_writes_a_chrome_trace(tmp_path):
    @tutils.annotate("decorated_region")
    def work(x):
        return x @ x

    with tutils.trace(str(tmp_path / "tr")) as prof:
        with tutils.annotate("context_region"):
            work(torch.ones(8, 8))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "tr" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"context_region", "decorated_region"} <= names
    assert any(e.key == "context_region" for e in prof.key_averages())
