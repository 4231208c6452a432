"""The port stands alone: importing it (ops/quant.py included) loads neither
JAX (nor optax or orbax) nor the JAX package, its sources (and
chip_smoke.py) import none of them, a train step loads none of them either,
and its entry points refuse to carry on on the CPU when no device was named
and no GPU exists, for a float and an int8 decoder alike."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|orbax|anyref_tpu)(?![\w])"
    r"|import_module\(\s*['\"](?:jax|optax|orbax|anyref_tpu)(?![\w])",
    re.M)
JAX_FAMILY = "('jax', 'jaxlib', 'optax', 'orbax', 'anyref_tpu')"


def test_import_loads_no_jax():
    """Runs in a fresh interpreter: the test process has JAX loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anyref_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    anyref_tpu_torch.__path__, 'anyref_tpu_torch.')]\n"
        "for want in ('ops.quant', 'ops.mel', 'models.imagebind.audio',\n"
        "             'data.rle', 'data.refcoco', 'data.avs',\n"
        "             'eval.referseg', 'eval.harnesses', 'tools.eval',\n"
        "             'eval.scene_graph', 'eval.caption_metrics',\n"
        "             'data.ade', 'data.phrasecut', 'data.registry',\n"
        "             'tools.train', 'tools.build_ref_index',\n"
        "             'models.sam.predictor', 'models.sam.amg', 'export',\n"
        "             'utils.logging', 'utils.profiling', 'tools.demo',\n"
        "             'tools.export', 'tools.convert_avs_masks'):\n"
        "    assert 'anyref_tpu_torch.' + want in names, names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        f"             {JAX_FAMILY})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout


def test_sources_import_no_jax():
    pkg = ROOT / "anyref_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files
           if FORBIDDEN.search(f.read_text())]
    assert not bad
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from anyref_tpu.config import x")
    assert FORBIDDEN.search("import optax")
    assert not FORBIDDEN.search("from anyref_tpu_torch.config import x")


def test_entry_points_refuse_cpu_without_gpu(monkeypatch):
    """No device named and no GPU: every entry point raises instead of
    running on the CPU."""
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch.config import anyref_tiny
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.export import export_sam_decoder
    from anyref_tpu_torch.models import anyref, sam
    from anyref_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator
    from anyref_tpu_torch.models.sam.predictor import SamPredictor
    from anyref_tpu_torch.ops.mel import audio_to_mel_clips
    from anyref_tpu_torch.ops.quant import quantize_llama
    from anyref_tpu_torch.serve import Server
    from anyref_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = anyref_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.init(cfg, torch.Generator())
    p = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                     device="cpu")
    batch = {"input_ids": np.ones((1, 8), np.int32),
             "clip_images": np.zeros((1, 3, 224, 224), np.float32),
             "sam_images": np.zeros((1, 3, 256, 256), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        anyref.generate(p, cfg, batch, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(p, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(p, cfg, preprocess_workers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparams.from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(), p, dataset=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        audio_to_mel_clips(np.zeros(16000, np.float32))
    # an int8 decoder tree, served greedy, is refused the same way
    q = dict(p, llama=quantize_llama(p["llama"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(q, cfg, speculative=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(q, cfg, speculative=False, preprocess_workers=1)
    # SAM alone: its init, the predictor, the generator and the export
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sam.init(cfg.sam, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamPredictor(p["sam"], cfg.sam)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamAutomaticMaskGenerator(p["sam"], cfg.sam)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_sam_decoder(p["sam"], cfg.sam, "unused.pt2")


def test_train_step_loads_no_jax():
    """A tiny train step (make_train_step -> train_forward -> the kernels'
    plain versions and their backward) in a fresh interpreter leaves no JAX,
    optax, orbax or JAX-package module loaded."""
    code = (
        "import sys, numpy as np, torch\n"
        "from anyref_tpu_torch import params\n"
        "from anyref_tpu_torch.config import anyref_tiny\n"
        "from anyref_tpu_torch.data.collator import Collator\n"
        "from anyref_tpu_torch.tokenizer import (AnyRefTokenizer,\n"
        "    seg_answer, seg_question)\n"
        "from anyref_tpu_torch.train import lora, step\n"
        "cfg = anyref_tiny()\n"
        "p = params.init(cfg, torch.Generator().manual_seed(0),\n"
        "                torch.float32, device='cpu')\n"
        "s = {'clip_image': np.zeros((3, 224, 224), np.float32),\n"
        "     'sam_image': np.zeros((3, 256, 256), np.float32),\n"
        "     'sam_resized_size': (256, 256), 'question': seg_question('x'),\n"
        "     'answer': seg_answer('x'), 'gt_masks': np.ones((1, 4, 4))}\n"
        "b = Collator(AnyRefTokenizer(), cfg, train=True)([s])\n"
        "opt = step.make_optimizer()\n"
        "st, fr = step.init_state(torch.Generator().manual_seed(1), p,\n"
        "                         lora.LoraConfig(), opt)\n"
        "fn = step.make_train_step(cfg, lora.LoraConfig(), opt)\n"
        "st, m = fn(st, fr, step.device_batch(b))\n"
        "assert st.step == 1 and np.isfinite(float(m['loss']))\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        f"             {JAX_FAMILY})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


WEIGHT_FAMILY = JAX_FAMILY[:-1] + ", 'safetensors', 'sentencepiece', " \
    "'tokenizers')"


def test_checkpoint_path_loads_no_jax_or_weight_packages(tmp_path):
    """In a fresh interpreter: importing sp, tokenizer, convert, checkpoint
    and the conversion CLI, loading the SentencePiece fixture and reading a
    .safetensors file load none of JAX, the JAX package, safetensors,
    sentencepiece or tokenizers."""
    code = (
        "import sys, torch\n"
        "import chip_smoke\n"
        "from anyref_tpu_torch import checkpoint, convert, sp, tokenizer\n"
        "from anyref_tpu_torch.tools import convert_checkpoint\n"
        "tok = tokenizer.AnyRefTokenizer.from_pretrained(\n"
        "    'tests/fixtures/sp_tokenizer')\n"
        "assert isinstance(tok.base, sp.SentencePieceModel)\n"
        f"path = {str(tmp_path / 'x.safetensors')!r}\n"
        "sd = {'w': torch.arange(6.).reshape(2, 3).bfloat16()}\n"
        "chip_smoke.write_safetensors(torch, path, sd)\n"
        "assert torch.equal(checkpoint._load_torch_state_dict(path)['w'],\n"
        "                   sd['w'])\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        f"             {WEIGHT_FAMILY})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_weight_packages():
    """The port reads .safetensors and SentencePiece models itself; only
    the tokenizer.json branch of from_pretrained imports ``tokenizers``."""
    weights = re.compile(r"^\s*(?:import|from)\s+(?:safetensors|"
                         r"sentencepiece)(?![\w])", re.M)
    tok = re.compile(r"^\s*(?:import|from)\s+tokenizers(?![\w])", re.M)
    pkg = ROOT / "anyref_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert not [str(f) for f in files if weights.search(f.read_text())]
    assert [f.name for f in files if tok.search(f.read_text())] == \
        ["tokenizer.py"]


def test_checkpoint_entry_points_refuse_cpu_without_gpu(monkeypatch,
                                                        tmp_path):
    """No device named and no GPU: assemble_pretrained, load_params, the
    conversions and the CLI raise instead of running on the CPU."""
    from anyref_tpu_torch import checkpoint, convert
    from anyref_tpu_torch.config import anyref_tiny
    from anyref_tpu_torch.tools import convert_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = anyref_tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.assemble_pretrained(cfg)
    path = str(tmp_path / "p.pt")
    checkpoint.save_params(path, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_params(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.convert_mm_projector(
            {"mm_projector.weight": np.zeros((4, 2), np.float32)},
            device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_checkpoint.main(["--out", str(tmp_path / "o.pt"),
                                 "--preset", "tiny"])
    assert checkpoint.load_params(path, device="cpu")["w"].device.type == \
        "cpu"
