"""The port's torch.export artifact of the SAM mask decoder against the JAX
package's exportable decoder (anyref_tpu/export.py sam_decoder_fn), on the
CPU.

The same weights (the JAX init, bridged by params.from_numpy) and numpy
prompts from a seed, with every label of the ONNX wrapper's interface: -1
padding, 0 negative, 1 positive, 2 / 3 box corners. Tolerances: 1e-5
between the port and the JAX function (fp32, the same ops in other orders,
tests/test_export.py's own limit for its artifact), and bit equality
between the loaded artifact and the unexported port function (one program
traced from it).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu import export as jexport
from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import sam as jsam
from anyref_tpu_torch import export as texport
from anyref_tpu_torch import params as tparams

SAM = anyref_tiny().sam
TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jp = jsam.init(jax.random.key(0), SAM, dtype=jnp.float32)
    return jp, tparams.from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """(num_points, multimask) -> the .pt2 file, each exported once."""
    root = tmp_path_factory.mktemp("export")
    paths = {}

    def get(num_points=5, multimask=True):
        key = (num_points, multimask)
        if key not in paths:
            paths[key] = str(root / f"dec-{num_points}-{int(multimask)}.pt2")
            texport.export_sam_decoder(weights[1], SAM, paths[key],
                                       num_points=num_points,
                                       multimask=multimask, device="cpu")
        return paths[key]

    return get


def _prompts(num_points: int, seed: int):
    rng = np.random.default_rng(seed)
    g = SAM.embedding_size
    emb = rng.standard_normal((1, SAM.prompt_embed_dim, g, g)).astype(
        np.float32)
    coords = rng.uniform(0, SAM.image_size, (1, num_points, 2)).astype(
        np.float32)
    labels = np.resize(np.asarray([1, 2, 3, -1, 0], np.float32),
                       (1, num_points))
    return emb, coords, labels


@pytest.mark.parametrize("num_points,multimask", [(5, True), (5, False),
                                                  (7, True)])
def test_exported_decoder_matches_jax(weights, exported, num_points,
                                      multimask):
    jp, tp = weights
    loaded = texport.load_exported(exported(num_points, multimask))
    live = texport.sam_decoder_fn(tp, SAM, multimask)
    reference = jax.jit(jexport.sam_decoder_fn(jp, SAM, multimask))
    K = 3 if multimask else 1
    g4 = 4 * SAM.embedding_size
    for seed in (0, 1):
        emb, coords, labels = _prompts(num_points, seed)
        want = reference(jnp.asarray(emb), jnp.asarray(coords),
                         jnp.asarray(labels))
        args = [torch.from_numpy(a) for a in (emb, coords, labels)]
        got = loaded(*args)
        unexported = live(*args)
        assert got[0].shape == (1, K, g4, g4) and got[1].shape == (1, K)
        for a, b, c in zip(got, want, unexported):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                       rtol=TOL)
            assert torch.equal(a, c)


def test_export_carries_weights_as_buffers(weights, exported):
    """Every prompt-encoder and mask-decoder leaf is a buffer of the
    program (its state dict), not a constant folded into the graph: a
    changed buffer changes the output."""
    _, tp = weights
    program = torch.export.load(exported())
    n_leaves = len(list(texport._leaves(
        {"prompt_encoder": tp["prompt_encoder"],
         "mask_decoder": tp["mask_decoder"]})))
    assert len(program.state_dict) == n_leaves
    assert not program.constants
    module = program.module()
    args = [torch.from_numpy(a) for a in _prompts(5, 2)]
    before = module(*args)[1].clone()
    getattr(module, "mask_decoder__iou_token").add_(1.0)
    assert not torch.equal(module(*args)[1], before)


def test_artifact_runs_without_the_model_code(exported, tmp_path):
    """A fresh interpreter loads and runs the artifact with torch alone:
    the port is not imported."""
    path = exported()
    args = [torch.from_numpy(a) for a in _prompts(5, 3)]
    torch.save(args, str(tmp_path / "args.pt"))
    want = texport.load_exported(path)(*args)
    code = (
        "import sys, torch\n"
        f"m = torch.export.load({path!r}).module()\n"
        f"args = torch.load({str(tmp_path / 'args.pt')!r})\n"
        "low, iou = m(*args)\n"
        f"torch.save((low, iou), {str(tmp_path / 'out.pt')!r})\n"
        "assert not [n for n in sys.modules if n.startswith('anyref')]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = torch.load(str(tmp_path / "out.pt"))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
