"""Serving the published checkpoint, on the CPU: the port's SentencePiece
reader and AnyRefTokenizer.from_pretrained, the conversion of each reference
layout, the loading of .pth / .bin / .safetensors files, assemble_pretrained,
save_params / load_params and the conversion CLI, against the JAX package.

State dicts are synthetic, in the reference's layouts
(chip_smoke.reference_state_dicts, the same generator the card's phase 6
writes at anyref_7b width), drawn from numpy seeds at anyref_tiny(). The
conversions only move, transpose, stack, pad and cast, so every leaf must be
bit-equal to the JAX tree's (fp32, params.from_numpy of the JAX conversion).
The LoRA merge is an fp32 product of rank 8 computed by two libraries:
atol 1e-6 of the merged weight's largest magnitude, rtol 1e-6."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

import chip_smoke
from anyref_tpu import checkpoint as jckpt
from anyref_tpu import convert as jconvert
from anyref_tpu import sp as jsp
from anyref_tpu import tokenizer as jtok
from anyref_tpu.config import anyref_tiny
from anyref_tpu_torch import checkpoint as tckpt
from anyref_tpu_torch import convert as tconvert
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch import sp as tsp
from anyref_tpu_torch import tokenizer as ttok
from anyref_tpu_torch.tools import convert_checkpoint as tcli
from tests.test_checkpoint_assembly import _tiny_merged_sd
from tests.test_tokenizer_sp import FIXTURE, _bpe_model

CFG = anyref_tiny()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ("the cat", "the q cat", "cat cat the", "tea", "")
# the unigram fixture has no byte pieces: unknown characters become <unk>
FIXTURE_TEXTS = TEXTS + ("the red cat", "  the  red   cat  ",
                         "Can you segment the red cat?")


@pytest.fixture(scope="module")
def sds():
    """The reference layouts at anyref_tiny, fp32 numpy."""
    rng = np.random.default_rng(0)

    def rand(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return chip_smoke.reference_state_dicts(CFG, rand)


def _leaves(got, want, path=""):
    """(path, port tensor, numpy array) pairs of two trees that must have
    the same structure."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [p for k in want for p in _leaves(got[k], want[k],
                                                 f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in _leaves(g, w, f"{path}/{i}")]
    return [(path, got, np.asarray(want))]


def _bit_equal(got, want_jax):
    pairs = _leaves(got, jax.device_get(want_jax))
    assert pairs
    for path, g, w in pairs:
        assert g.dtype == torch.float32 and g.device.type == "cpu", path
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


def _like_init(got, made, path=""):
    """``got`` has params.init's structure, shapes and dtypes."""
    if isinstance(made, dict):
        assert set(got) == set(made), path
        for k in made:
            _like_init(got[k], made[k], f"{path}/{k}")
    elif isinstance(made, list):
        assert len(got) == len(made), path
        for i, (g, m) in enumerate(zip(got, made)):
            _like_init(g, m, f"{path}/{i}")
    else:
        assert tuple(got.shape) == tuple(made.shape), path
        assert got.dtype == made.dtype, path


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["fixture", "bpe_byte_fallback"])
def test_sp_matches_jax(model):
    """Ids and decode equal to the JAX reader's: the in-repo unigram fixture
    and a BPE model with byte fallback (tests/test_tokenizer_sp.py's)."""
    blob = (open(os.path.join(FIXTURE, "tokenizer.model"), "rb").read()
            if model == "fixture" else _bpe_model())
    want, got = jsp.SentencePieceModel.from_bytes(blob), \
        tsp.SentencePieceModel.from_bytes(blob)
    assert got.pieces == want.pieces
    for text in FIXTURE_TEXTS if model == "fixture" else TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids + [10_000]) == want.decode(ids + [10_000])


def test_from_pretrained_matches_jax():
    """The fixture directory (tokenizer.model only) through the port's
    reader: tokenize_conversation's ids and labels and tokenize_prompt's
    ids equal the JAX tokenizer's."""
    got, want = ttok.AnyRefTokenizer.from_pretrained(FIXTURE), \
        jtok.AnyRefTokenizer.from_pretrained(FIXTURE)
    assert isinstance(got.base, tsp.SentencePieceModel)
    for text in ("the red cat", "a cat"):
        q = ttok.seg_question(text)
        a = ttok.seg_answer(text)
        tc = ttok.tokenize_conversation(got, q, a)
        jc = jtok.tokenize_conversation(want, q, a)
        np.testing.assert_array_equal(tc.input_ids, jc.input_ids)
        np.testing.assert_array_equal(tc.labels, jc.labels)
        assert tc.prompt_len == jc.prompt_len
        np.testing.assert_array_equal(ttok.tokenize_prompt(got, q),
                                      jtok.tokenize_prompt(want, q))
    assert got.decode(tc.input_ids) == want.decode(jc.input_ids)


def test_from_pretrained_tokenizer_json_matches_jax(tmp_path):
    """A directory with tokenizer.json (and tokenizer.model) takes the fast
    file through ``tokenizers``, as the JAX tokenizer does."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "the": 3, "red": 4, "cat": 5,
             "?": 6, "Can": 7, "you": 8, "segment": 9, "in": 10}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer.model").write_bytes(_bpe_model())
    got = ttok.AnyRefTokenizer.from_pretrained(str(tmp_path))
    want = jtok.AnyRefTokenizer.from_pretrained(str(tmp_path))
    q = ttok.seg_question("the red cat")
    ids = ttok.tokenize_prompt(got, q)
    np.testing.assert_array_equal(ids, jtok.tokenize_prompt(want, q))
    assert 5 in ids.tolist() and got.decode(ids) == want.decode(ids)


def test_from_pretrained_missing_files(tmp_path, monkeypatch):
    """No tokenizer file: FileNotFoundError. A tokenizer.json without the
    tokenizers package: an ImportError that names the package, not a quiet
    switch to tokenizer.model."""
    with pytest.raises(FileNotFoundError, match="tokenizer.json or "
                                                "tokenizer.model"):
        ttok.AnyRefTokenizer.from_pretrained(str(tmp_path))
    (tmp_path / "tokenizer.json").write_text("{}")
    (tmp_path / "tokenizer.model").write_bytes(_bpe_model())
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="'tokenizers'"):
        ttok.AnyRefTokenizer.from_pretrained(str(tmp_path))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("part", ["sam", "clip", "llama", "mm_projector",
                                  "heads", "audio"])
def test_convert_matches_jax(sds, part):
    """Each convert_* against the JAX one, leaf by leaf, bit-exact in fp32,
    from numpy and from torch tensors alike; the tree is params.init's."""
    f32 = jnp.float32
    sd = sds[part]
    run = {
        "sam": (lambda m, s, **k: m.convert_sam(s, CFG.sam, **k), "sam"),
        "clip": (lambda m, s, **k: m.convert_clip_vision(s, CFG.clip, **k),
                 "clip"),
        "llama": (lambda m, s, **k: m.convert_llama(s, CFG.llama, **k),
                  "llama"),
        "mm_projector": (lambda m, s, **k: m.convert_mm_projector(s, **k),
                         "mm_projector"),
        "heads": (lambda m, s, **k: m.convert_anyref_heads(s, **k), None),
        "audio": (lambda m, s, **k: m.convert_imagebind_audio(
            s, CFG.audio, **k), "audio_encoder"),
    }
    fn, key = run[part]
    want = fn(jconvert, sd, dtype=f32)
    for src in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = fn(tconvert, src, dtype=torch.float32, device="cpu")
        _bit_equal(got, want)
    cfg = CFG.scaled(use_loc_tokens=True)
    made = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")
    if key is None:
        assert set(got) == {"text_hidden_fcs", "loc_embeddings",
                            "audio_projector"}
        for k in got:
            _like_init(got[k], made[k], k)
    else:
        _like_init(got, made[key], key)


def test_convert_reads_bf16_as_it_is(sds):
    """A bf16 source tensor converts without a trip through numpy: fp32
    leaves are its exact widening, bf16 leaves its bits."""
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in sds["llama"].items()}
    got = tconvert.convert_llama(sd, CFG.llama, dtype=torch.bfloat16,
                                 device="cpu")
    w = sd["model.layers.0.self_attn.q_proj.weight"]
    assert got["layers"][0]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["layers"][0]["attn"]["q"]["w"], w.t())
    emb = got["embed_tokens"]
    assert emb.dtype == torch.float32
    n = sd["model.embed_tokens.weight"].shape[0]
    assert torch.equal(emb[:n], sd["model.embed_tokens.weight"].float())
    assert not emb[n:].any()


def test_merge_lora_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    a = rng.standard_normal((8, 32)).astype(np.float32)
    b = rng.standard_normal((48, 8)).astype(np.float32)
    want = jconvert.merge_lora_into(w, a, b, 16, 8)
    got = tconvert.merge_lora_into(*map(torch.from_numpy, (w, a, b)), 16, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _write_adapter(path, sds, modules_to_save=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"lora_alpha": 16, "r": 8}, f)
    asd = dict(sds["adapter"])
    if modules_to_save:
        asd.update(modules_to_save)
    torch.save({k: torch.from_numpy(v) for k, v in asd.items()},
               os.path.join(path, "adapter_model.bin"))


def test_merge_peft_adapter_matches_jax(sds, tmp_path):
    """The CLI's adapter merge against tools/convert_checkpoint.py's: every
    LoRA-adapted weight, and a modules_to_save override copied over."""
    from tools.convert_checkpoint import merge_peft_adapter as jmerge
    extra = {"base_model.model.model.text_hidden_fcs.0.0.modules_to_save."
             "default.weight": np.full((128, 128), 0.5, np.float32)}
    _write_adapter(str(tmp_path), sds, extra)
    base = {**sds["llama"], **sds["heads"]}
    want = jmerge(base, str(tmp_path))
    got = tcli.merge_peft_adapter(
        {k: torch.from_numpy(v) for k, v in base.items()}, str(tmp_path))
    assert set(got) == set(want)
    merged = 0
    for k in want:
        w = np.asarray(want[k])
        if not np.array_equal(w, base.get(k)):
            merged += 1
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    # q and v of both layers, and the override
    assert merged == 2 * CFG.llama.num_layers + 1


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_read_safetensors(tmp_path, dtype):
    """The port's own reader against safetensors.numpy's writer: every
    tensor's bits, shape and dtype, a 0-d and an empty tensor included."""
    import ml_dtypes
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    rng = np.random.default_rng(2)
    sd = {"a.weight": rng.standard_normal((5, 3)).astype(npdt),
          "b": rng.standard_normal((7,)).astype(npdt),
          "scalar": np.array(3.5, npdt), "empty": np.zeros((0, 4), npdt),
          "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
          "i8": np.arange(-3, 4, dtype=np.int8)}
    path = str(tmp_path / "m.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = tckpt._load_torch_state_dict(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        g = got[k]
        assert str(g.dtype) == f"torch.{np.dtype(v.dtype).name}", k
        assert tuple(g.shape) == v.shape, k
        want_bits = v.view(np.uint16) if v.dtype == ml_dtypes.bfloat16 \
            else v
        got_bits = g.view(torch.int16).numpy().view(np.uint16) \
            if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(got_bits, want_bits, err_msg=k)


def test_read_safetensors_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "m.safetensors")
    save_file({"x": np.zeros(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        tckpt._load_torch_state_dict(path)


def test_load_bin_and_hf_dir(tmp_path, sds):
    """.bin / .pth through torch.load(weights_only=True), a "state_dict"
    wrapper unwrapped, bf16 kept; _load_hf_dir merges the weight files and
    warns past a pickle that is not a state dict."""
    sd = {k: torch.from_numpy(v) for k, v in sds["mm_projector"].items()}
    torch.save({"state_dict": sd}, str(tmp_path / "sam.pth"))
    got = tckpt._load_torch_state_dict(str(tmp_path / "sam.pth"))
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    d = tmp_path / "hf"
    d.mkdir()
    torch.save({k: v.bfloat16() for k, v in sd.items()},
               str(d / "mm_projector.bin"))
    save_file({"x": np.ones(2, np.float32)}, str(d / "model.safetensors"))
    (d / "pytorch_model.bin.index.json").write_text("{}")
    torch.save({"not": "weights", "o": object.__new__(json.JSONDecoder)},
               str(d / "extra.bin"))
    torch.save({"a": 1}, str(d / "training_args.bin"))
    got = tckpt._load_hf_dir(str(d))
    assert set(got) == set(sd) | {"x"}
    assert got["model.mm_projector.weight"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def merged_dir(sds, tmp_path_factory):
    """A merged reference checkpoint (LLaMA, mm_projector, the CLIP tower,
    SAM, the heads) as one safetensors shard, a SAM .pth and a PEFT
    adapter."""
    root = tmp_path_factory.mktemp("ckpt")
    (root / "llava").mkdir()
    save_file(chip_smoke.merged_llava(sds),
              str(root / "llava" / "model.safetensors"))
    torch.save({k: torch.from_numpy(v) for k, v in sds["sam"].items()},
               str(root / "sam_vit_h.pth"))
    _write_adapter(str(root / "lora"), sds)
    return root


@pytest.mark.parametrize("layout", ["merged", "test_checkpoint_assembly"])
def test_assemble_pretrained_matches_jax(tmp_path, sds, merged_dir, layout):
    """Every converted part bit-equal to the JAX assemble_pretrained's in
    fp32; the parts no artifact holds drawn by params.init from the seed,
    the tree params.init's."""
    if layout == "merged":
        llava = str(merged_dir / "llava")
        kw = {"sam_ckpt": str(merged_dir / "sam_vit_h.pth")}
        converted = ("llama", "mm_projector", "clip", "sam",
                     "text_hidden_fcs", "audio_projector")
    else:
        llava = str(tmp_path)
        save_file(_tiny_merged_sd(), str(tmp_path / "model.safetensors"))
        kw = {}
        converted = ("llama", "mm_projector", "text_hidden_fcs")
    want = jckpt.assemble_pretrained(CFG, llava_dir=llava, dtype=jnp.float32,
                                     **kw)
    got = tckpt.assemble_pretrained(CFG, llava_dir=llava,
                                    dtype=torch.float32, seed=3,
                                    device="cpu", **kw)
    made = tparams.init(CFG, torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")
    assert set(got) == set(want)
    assert list(got)[:len(made)] == list(made)
    for k in made:
        if k in converted:
            _bit_equal(got[k], want[k])
        else:
            _like_init(got[k], made[k], k)
    fresh = [k for k in made if k not in converted]
    again = tparams.init(CFG, torch.Generator().manual_seed(3), torch.float32,
                         device="cpu", parts=fresh)
    for k in fresh:
        for _, g, w in _leaves(got[k], jax.tree.map(lambda t: t.numpy(),
                                                    again[k])):
            np.testing.assert_array_equal(g.numpy(), w)


def test_save_load_params_round_trip(tmp_path):
    """save_params / load_params give the tree back bit for bit, dtypes
    kept: a bf16 tree, and its int8 decoder (int8 leaves, a None
    lm_head)."""
    from anyref_tpu_torch.ops.quant import quantize_llama
    p = tparams.init(CFG, torch.Generator().manual_seed(0), torch.bfloat16,
                     device="cpu")
    p = {**p, "llama_int8": quantize_llama(p["llama"])}
    path = str(tmp_path / "sub" / "params.pt")
    tckpt.save_params(path, p)
    got = tckpt.load_params(path, device="cpu")
    n = 0

    def walk(a, b, where):
        nonlocal n
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                walk(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}/{i}")
        elif a is None:
            assert b is None, where
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), where
            n += 1
    walk(p, got, "")
    assert got["llama_int8"]["lm_head"] is None
    assert got["llama_int8"]["layers"][0]["attn"]["q"]["w_q"].dtype == \
        torch.int8
    assert n > 100


def test_convert_cli_tiny(merged_dir, sds, tmp_path):
    """python -m anyref_tpu_torch.tools.convert_checkpoint --preset tiny
    with a LoRA adapter: its file loads (load_params) to build_params' tree
    bit for bit; the adapted q / v weights are the merged ones (against the
    JAX CLI's merge and conversion), everything else assemble_pretrained's."""
    from tools.convert_checkpoint import merge_peft_adapter as jmerge
    out = str(tmp_path / "anyref_tiny.pt")
    args = ["--out", out, "--preset", "tiny", "--dtype", "float32",
            "--llava_dir", str(merged_dir / "llava"), "--sam_ckpt",
            str(merged_dir / "sam_vit_h.pth"), "--lora_dir",
            str(merged_dir / "lora"), "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m",
                        "anyref_tpu_torch.tools.convert_checkpoint", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    got = tckpt.load_params(out, device="cpu")
    kw = dict(llava_dir=str(merged_dir / "llava"),
              sam_ckpt=str(merged_dir / "sam_vit_h.pth"),
              dtype=torch.float32, device="cpu")
    want = tcli.build_params(CFG, lora_dir=str(merged_dir / "lora"), **kw)
    plain = tckpt.assemble_pretrained(CFG, **kw)
    merged_sd = jmerge(jckpt._load_hf_dir(str(merged_dir / "llava")),
                       str(merged_dir / "lora"))
    jllama = jax.device_get(jconvert.convert_llama(merged_sd, CFG.llama,
                                                   dtype=jnp.float32))
    for path, g, w in _leaves(got, jax.tree.map(lambda t: t.numpy(), want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    for path, g, w in _leaves(got["llama"], jllama):
        adapted = "/attn/q/" in path or "/attn/v/" in path
        if adapted:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    for path, g, w in _leaves(got, jax.tree.map(lambda t: t.numpy(), plain)):
        adapted = path.startswith("/llama/layers") and (
            "/attn/q/" in path or "/attn/v/" in path)
        assert adapted != np.array_equal(g.numpy(), w), path


@pytest.mark.parametrize("entry", ["assemble_pretrained", "cli"])
def test_merged_sam_replaces_sam_ckpt(merged_dir, sds, tmp_path, entry):
    """Where the merged LLaVA directory and --sam_ckpt both hold SAM, the
    merged directory's wins, in assemble_pretrained as in the JAX one and in
    the CLI's build_params: every SAM leaf bit-equal to the JAX assembly's,
    none of them the .pth's."""
    other = {k: torch.from_numpy(-v - 0.5) for k, v in sds["sam"].items()}
    sam_pth = str(tmp_path / "sam_other.pth")
    torch.save(other, sam_pth)
    llava = str(merged_dir / "llava")
    kw = dict(llava_dir=llava, sam_ckpt=sam_pth, dtype=torch.float32,
              device="cpu")
    got = (tckpt.assemble_pretrained(CFG, **kw) if entry ==
           "assemble_pretrained" else tcli.build_params(CFG, **kw))
    want = jckpt.assemble_pretrained(CFG, llava_dir=llava, sam_ckpt=sam_pth,
                                     dtype=jnp.float32)
    _bit_equal(got["sam"], want["sam"])
    from_pth = tconvert.convert_sam(other, CFG.sam, dtype=torch.float32,
                                    device="cpu")
    for path, g, w in _leaves(got["sam"], jax.tree.map(lambda t: t.numpy(),
                                                       from_pth)):
        assert not np.array_equal(g.numpy(), w), path


def test_convert_cli_reads_depth(merged_dir):
    """The CLI's decoder is as deep as the LLaVA state dict, whatever the
    preset says: a preset four layers deeper converts the directory's
    layers, bit-equal to assemble_pretrained at the directory's depth."""
    import dataclasses
    sd = tckpt._load_hf_dir(str(merged_dir / "llava"))
    assert tcli.llama_depth(sd) == CFG.llama.num_layers
    assert tcli.llama_depth({"model.mm_projector.weight": sd[
        "model.mm_projector.weight"]}) is None
    deeper = CFG.scaled(llama=dataclasses.replace(
        CFG.llama, num_layers=CFG.llama.num_layers + 4))
    kw = dict(llava_dir=str(merged_dir / "llava"), dtype=torch.float32,
              device="cpu")
    got = tcli.build_params(deeper, **kw)
    want = tckpt.assemble_pretrained(CFG, **kw)
    assert len(got["llama"]["layers"]) == CFG.llama.num_layers
    for path, g, w in _leaves(got, jax.tree.map(lambda t: t.numpy(), want)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
