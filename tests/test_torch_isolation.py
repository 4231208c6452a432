"""The port stands alone: importing it loads neither JAX nor the JAX package,
its sources (and chip_smoke.py) import neither, and its entry points refuse
to carry on on the CPU when no device was named and no GPU exists."""

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
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|anyref_tpu)(?![\w])"
    r"|import_module\(\s*['\"](?:jax|anyref_tpu)(?![\w])", re.M)


def test_import_loads_no_jax():
    """Runs in a fresh interpreter: the test process has JAX loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import anyref_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    anyref_tpu_torch.__path__, 'anyref_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'anyref_tpu'))\n"
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
    assert not FORBIDDEN.search("from anyref_tpu_torch.config import x")


def test_entry_points_refuse_cpu_without_gpu(monkeypatch):
    """No device named and no GPU: every entry point raises instead of
    running on the CPU."""
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch.config import anyref_tiny
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.models import anyref
    from anyref_tpu_torch.serve import Server

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
