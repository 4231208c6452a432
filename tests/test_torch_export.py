"""The port's torch.export artifacts against the JAX package, on the CPU:
the SAM mask decoder against its exportable decoder (anyref_tpu/export.py
sam_decoder_fn), and the greedy generate step (export_generate, and the
CLI's ``generate``) against its live generate.

The same weights (the JAX init, bridged by params.from_numpy) and numpy
prompts from a seed, with every label of the ONNX wrapper's interface: -1
padding, 0 negative, 1 positive, 2 / 3 box corners. Tolerances: 1e-5
between the port and the JAX function (fp32, the same ops in other orders,
tests/test_export.py's own limit for its artifact), and bit equality
between the loaded artifact and the unexported port function (one program
traced from it).

The generate artifact at anyref_tiny(), on "unfused" and, at a 512-pixel
SAM with windows of 8 (both fused SAM gates open), on "fused", each side
with the JAX switches of that path: ids and [SEG] slots equal to the JAX
live generate's, low-res masks within 2e-2 of the largest magnitude (the
decoder runs bf16 activations, tests/test_torch_generate.py), and every
output bit-equal to the port's eager generate, on two prompts: lm_head's
[SEG] and EOS columns are scaled so that both answer [SEG] (at output 2 and
at 0) and then EOS, well before max_new_tokens, so the fixed-step program
runs its steps past the early exit. The same against the JAX live generate
on the "unfused" tree's decoder quantised by quantize_llama (the int8 path
of the program).
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu import export as jexport
from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import sam as jsam
from anyref_tpu.ops import quant as jquant
from anyref_tpu_torch import checkpoint as tcheckpoint
from anyref_tpu_torch import export as texport
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.ops.quant import is_quantized
from anyref_tpu_torch.tokenizer import EOS_ID, AnyRefTokenizer, seg_question
from anyref_tpu_torch.tools import export as texport_cli
from tests.torch_one_thread import one_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# export_generate
# ---------------------------------------------------------------------------
TINY = anyref_tiny()
JAX_SWITCHES = {
    "unfused": {"ANYREF_FUSED_WINDOW_BLOCK": "0",
                "ANYREF_FUSED_GLOBAL_BLOCK": "0",
                "ANYREF_QKV_WINDOW_KERNEL": "0", "ANYREF_QKV_MHA_KERNEL": "0"},
    "fused": {"ANYREF_FUSED_WINDOW_BLOCK": "1",
              "ANYREF_FUSED_GLOBAL_BLOCK": "1", "ANYREF_FUSED_SPLIT": "1",
              "ANYREF_QKV_MHA_KERNEL": "1", "ANYREF_QKV_WINDOW_KERNEL": "0"}}
ROOT = pathlib.Path(__file__).resolve().parent.parent
GEN_CFG = {"unfused": TINY,
           "fused": dataclasses.replace(TINY, sam=dataclasses.replace(
               TINY.sam, image_size=512, window_size=8))}
PROMPT_LEN = 257
GEN_MNT = 6
SEG_SCALE, EOS_SCALE = 3.0, 3.5
MASK_TOL = 2e-2
TEXTS = ("the cat", "the red cat on the red mat near the open door")


def _gen_prompts(cfg):
    """Two batch-1 inputs, each prompt left-padded into PROMPT_LEN."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = SegDataset(cfg)
    fb = Collator(AnyRefTokenizer(), cfg)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])
    out = []
    for b in range(2):
        n = int(fb["prompt_lens"][b])
        ids = np.zeros((1, PROMPT_LEN), np.int32)
        ids[0, PROMPT_LEN - n:] = fb["input_ids"][b, :n]
        out.append((ids, fb["clip_images"][b:b + 1],
                    fb["sam_images"][b:b + 1]))
    return out


@pytest.fixture(scope="module")
def gen_case(tmp_path_factory):
    """encoder path or "int8" -> (path, cfg, port params, artifact,
    prompts, the JAX live generate's outputs on each prompt, the loaded
    program), each made once, the JAX side traced under the path's
    switches."""
    cases = {}

    def get(path):
        if path not in cases:
            cases[path] = _gen_case(path, tmp_path_factory)
        return cases[path]

    return get


def _gen_case(key, tmp_path_factory):
    """``key``: an encoder path, or "int8" (the decoder of the "unfused"
    case quantised by the JAX quantize_llama, then crossed)."""
    path = "unfused" if key == "int8" else key
    cfg = GEN_CFG[path]
    with pytest.MonkeyPatch.context() as mp:
        for name, value in JAX_SWITCHES[path].items():
            mp.setenv(name, value)
        jp = janyref.init(jax.random.key(0), cfg, dtype=jnp.float32)
        lm = jp["llama"]["lm_head"]
        lm = lm.at[:, cfg.tokens.seg].multiply(SEG_SCALE)
        jp["llama"]["lm_head"] = lm.at[:, EOS_ID].multiply(EOS_SCALE)
        if key == "int8":
            jp["llama"] = jquant.quantize_llama(jp["llama"])
        prompts = _gen_prompts(cfg)
        live = jax.jit(functools.partial(janyref.generate,
                                         max_new_tokens=GEN_MNT),
                       static_argnums=(1,))
        want = []
        for ids, clip, sam in prompts:
            o = live(jp, cfg, {"input_ids": jnp.asarray(ids),
                               "clip_images": jnp.asarray(clip),
                               "sam_images": jnp.asarray(sam)})
            want.append(tuple(np.asarray(a) for a in (
                o.output_ids, o.low_res_masks, o.seg_valid)))
    tp = tparams.from_numpy(jax.device_get(jp), device="cpu")
    artifact = str(tmp_path_factory.mktemp("gen") / f"generate-{key}.pt2")
    texport.export_generate(tp, cfg, artifact, prompt_len=PROMPT_LEN,
                            max_new_tokens=GEN_MNT, device="cpu",
                            encoder_path=path)
    return path, cfg, tp, artifact, prompts, want, texport.load_exported(
        artifact)


def _as_torch(prompt):
    return tuple(torch.from_numpy(a) for a in prompt)


@pytest.mark.parametrize("case", ["unfused", "fused", "int8"])
def test_exported_generate_matches_jax_and_eager(gen_case, case):
    """The loaded artifact on two prompts: against the JAX live generate
    and bit for bit against the port's eager generate (early exit). The
    int8 program holds quantize_llama's tree (lm_head None beside
    lm_head_q) and runs its products through anyref::int8_matmul."""
    path, cfg, tp, _, prompts, want, program = gen_case(case)
    int8 = case == "int8"
    buffers = dict(program.named_buffers())
    assert is_quantized(tp["llama"]) == int8
    assert ("llama__lm_head" in buffers) == (not int8)
    assert ("llama__lm_head_q__w_q" in buffers) == int8
    assert any("int8_matmul" in str(n.target)
               for n in program.graph.nodes) == int8
    firsts = []
    for prompt, (w_ids, w_masks, w_valid) in zip(prompts, want):
        ids, masks, valid = program(*_as_torch(prompt))
        eager = tanyref.generate(tp, cfg, dict(zip(
            ("input_ids", "clip_images", "sam_images"), prompt)),
            max_new_tokens=GEN_MNT, device="cpu", encoder_path=path)
        assert ids.shape == (1, GEN_MNT) and masks.shape == \
            eager.low_res_masks.shape
        np.testing.assert_array_equal(ids.numpy(), w_ids)
        np.testing.assert_array_equal(valid.numpy(), w_valid)
        np.testing.assert_allclose(masks.numpy(), w_masks, rtol=MASK_TOL,
                                   atol=MASK_TOL * np.abs(w_masks).max())
        assert torch.equal(ids, eager.output_ids)
        assert torch.equal(valid, eager.seg_valid)
        assert torch.equal(masks, eager.low_res_masks)
        row = ids[0].tolist()
        # the answer ends before max_new_tokens: eager stopped early, the
        # program ran every step
        assert EOS_ID in row and eager.decode_passes < GEN_MNT, row
        firsts.append(row.index(cfg.tokens.seg))
        assert bool(valid[0, 0])
    assert firsts == [2, 0]


def test_export_generate_cli_writes_a_loadable_program(gen_case, tmp_path,
                                                       capsys):
    """The CLI's generate choice (unfused: the tiny preset's 256-pixel
    SAM) from a params file: its program gives the export_generate
    program's outputs, bit for bit."""
    *_, tp, _, prompts, _, program = gen_case("unfused")
    ckpt = str(tmp_path / "p.pt")
    tcheckpoint.save_params(ckpt, tp)
    out = str(tmp_path / "g.pt2")
    texport_cli.main(["generate", "--ckpt", ckpt, "--out", out,
                      "--preset", "tiny", "--device", "cpu",
                      "--prompt_len", str(PROMPT_LEN), "--max_new_tokens",
                      str(GEN_MNT), "--encoder_path", "unfused"])
    assert "wrote" in capsys.readouterr().out
    got = texport.load_exported(out)(*_as_torch(prompts[1]))
    want = program(*_as_torch(prompts[1]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_generate_program_runs_in_a_fresh_interpreter(gen_case, tmp_path):
    """A fresh interpreter that imports the port's export module (its op
    registrations) loads and runs the program, and loads no JAX."""
    *_, artifact, prompts, _, program = gen_case("unfused")
    args = _as_torch(prompts[0])
    torch.save(args, str(tmp_path / "args.pt"))
    want = program(*args)
    code = (
        "import sys, torch\n"
        "from anyref_tpu_torch import export\n"
        f"m = export.load_exported({artifact!r})\n"
        f"out = m(*torch.load({str(tmp_path / 'args.pt')!r}))\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'anyref_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr
    for a, b in zip(torch.load(str(tmp_path / "out.pt")), want):
        assert torch.equal(a, b)
