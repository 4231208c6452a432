"""The decoder's serving layouts in the port against the JAX package, on the
CPU at anyref_tiny(): ops/common.linear's "w_t" path, llama's
transpose_for_serving / fuse_for_serving / attn_proj, prefill and decode on
the fused layout, the speculative Predictor's in-place conversion (with
rephrase pooling, which projects q and k through attn_proj), the layout's
refusals (int8, quantize_llama, LoRA), and torch.library.opcheck of every
registered op (ops/flash.py OPS).

Weights are the JAX init bridged by params.from_numpy; inputs come from
numpy seeds. Tolerances: linear in fp32 1e-5 and in bf16 one bf16 ulp of
the output (2^-8 relative); the converted trees bit-equal to the JAX ones;
prefill and decode in fp32 2e-5 against the JAX fused layout and the
port's plain layout, as tests/test_fused_serving.py;
generate's ids and [SEG] slots equal, its masks and seg_embeddings within
2e-2 of the largest magnitude (the [SEG] states are bf16), as
tests/test_torch_rephrase.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import llama as jllama
from anyref_tpu.ops import common as jcommon
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.models import llama as tllama
from anyref_tpu_torch.ops import common as tcommon
from anyref_tpu_torch.ops import flash as tflash
from anyref_tpu_torch.ops import quant as tquant
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question
from anyref_tpu_torch.train import lora as tlora

CFG = anyref_tiny().scaled(rephrase_weight=0.1)
LCFG = CFG.llama
MNT = 6
BUCKET = 257
SEG_SCALE = 3.0          # as tests/test_torch_rephrase.py: a non-empty span
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")
TEXTS = ("the cat", "the red cat on the red mat near the open door")


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


@pytest.fixture(scope="module")
def jp():
    p = janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)
    lm = p["llama"]["lm_head"]
    p["llama"]["lm_head"] = lm.at[:, CFG.tokens.seg].multiply(SEG_SCALE)
    return p


@pytest.fixture(scope="module")
def tp(jp):
    return tparams.from_numpy(jax.device_get(jp), device="cpu")


def _jax_copy(tree):
    return jax.tree.map(lambda x: x, tree)


def _port_copy(tree):
    """New containers, the same tensors: a conversion of the copy leaves
    the original tree as it was."""
    if isinstance(tree, dict):
        return {k: _port_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_copy(v) for v in tree]
    return tree


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2.0 ** -8)])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_w_t_matches_jax(dtype, tol, bias):
    """x [2, 5, 24] by a [16, 24] transposed weight: the weight rounded to
    x's dtype, fp32 sums, as the "w" path."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w_t = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = jcommon.linear({"w_t": jnp.asarray(w_t),
                           **({"b": jnp.asarray(b)} if bias else {})}, jx)
    got = tcommon.linear({"w_t": torch.from_numpy(w_t),
                          **({"b": torch.from_numpy(b)} if bias else {})},
                         torch.from_numpy(x).to(getattr(torch, dtype)))
    plain = tcommon.linear({"w": torch.from_numpy(w_t.T.copy()),
                            **({"b": torch.from_numpy(b)} if bias else {})},
                           torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    assert torch.equal(got, plain)


@pytest.mark.parametrize("start", ["plain", "transposed"])
def test_fused_tree_matches_jax(jp, tp, start):
    """fuse_for_serving from the transposed layout or straight from [in,
    out] weights: keys and shapes, idempotence, every leaf bit-equal to the
    JAX conversion crossed by from_numpy, converted in place."""
    jl = _jax_copy(jp["llama"])
    tl = _port_copy(tp["llama"])
    layers = tl["layers"]
    if start == "transposed":
        jl = jllama.transpose_for_serving(jl)
        assert tllama.transpose_for_serving(tl) is tl
        assert all("w_t" in p and "w" not in p for layer in layers
                   for grp in ("attn", "mlp") for p in layer[grp].values())
        assert all(p["w_t"].is_contiguous() for layer in layers
                   for grp in ("attn", "mlp") for p in layer[grp].values())
    want = tparams.from_numpy(jax.device_get(jllama.fuse_for_serving(jl)),
                              device="cpu")
    got = tllama.fuse_for_serving(tl)
    assert got is tl and got["layers"] is layers
    assert tllama.fuse_for_serving(got) is got
    nq = LCFG.num_heads * LCFG.head_dim
    nkv = LCFG.num_kv_heads * LCFG.head_dim
    for layer in got["layers"]:
        assert set(layer["attn"]) == {"qkv", "o"}
        assert set(layer["mlp"]) == {"gate_up", "down"}
        assert layer["attn"]["qkv"]["w_t"].shape == (nq + 2 * nkv,
                                                     LCFG.hidden_size)
        assert layer["mlp"]["gate_up"]["w_t"].shape == (
            2 * LCFG.intermediate_size, LCFG.hidden_size)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for k, t in got_leaves.items():
        assert t.dtype == want_leaves[k].dtype and torch.equal(
            t, want_leaves[k]), k
    # the caller's original tree is untouched (the copy was converted)
    assert "q" in tp["llama"]["layers"][0]["attn"]


def test_attn_proj_gives_each_projection(jp, tp):
    """attn_proj on the fused layout: row blocks of qkv equal to the
    transposed q / k / v, and to the JAX attn_proj crossed; on the plain
    layout the leaf itself."""
    attn = tp["llama"]["layers"][-1]["attn"]
    fused = tllama.fuse_for_serving(_port_copy(tp["llama"]))
    jfused = jllama.fuse_for_serving(_jax_copy(jp["llama"]))
    fa, ja = fused["layers"][-1]["attn"], jfused["layers"][-1]["attn"]
    for name in ("q", "k", "v"):
        assert tllama.attn_proj(attn, name, LCFG) is attn[name]
        got = tllama.attn_proj(fa, name, LCFG)["w_t"]
        assert got.untyped_storage().data_ptr() == \
            fa["qkv"]["w_t"].untyped_storage().data_ptr()     # a view
        assert torch.equal(got, attn[name]["w"].T)
        want = np.asarray(jllama.attn_proj(ja, name, LCFG)["w_t"])
        assert np.array_equal(got.numpy(), want)


def test_prefill_and_decode_on_fused_layout(jp, tp):
    """Prefill of 128 tokens (a length the causal kernels take as they
    are) with a left pad, then a decode step: the port's
    fused layout against the JAX fused layout and against the port's plain
    layout (2e-5: the CPU's GEMM may sum a wider product in another
    order), hidden states and caches."""
    fused = tllama.fuse_for_serving(tllama.transpose_for_serving(
        _port_copy(tp["llama"])))
    jfused = jllama.fuse_for_serving(jllama.transpose_for_serving(
        _jax_copy(jp["llama"])))
    rng = np.random.default_rng(1)
    B, L = 2, 128
    emb = rng.standard_normal((B, L, LCFG.hidden_size)).astype(np.float32)
    step = rng.standard_normal((B, 1, LCFG.hidden_size)).astype(np.float32)
    pad = np.asarray([0, 3], np.int32)
    jc = jllama.init_cache(LCFG, B, L + 8, dtype=jnp.float32)
    jh, jc = jllama.prefill(jfused, LCFG, jnp.asarray(emb), jc,
                           pad_len=jnp.asarray(pad))
    jd, jc = jllama.decode_step(jfused, LCFG, jnp.asarray(step),
                                jnp.int32(L), jc, pad_len=jnp.asarray(pad))
    outs = {}
    for name, tree in (("fused", fused), ("plain", tp["llama"])):
        c = tllama.init_cache(LCFG, B, L + 8, dtype=torch.float32,
                              device="cpu")
        h, c = tllama.prefill(tree, LCFG, torch.from_numpy(emb), c,
                              pad_len=torch.from_numpy(pad).long())
        d, c = tllama.decode_step(tree, LCFG, torch.from_numpy(step), L, c,
                                  pad_len=torch.from_numpy(pad).long())
        outs[name] = (h, d, torch.stack(c.k), torch.stack(c.v))
    for got, want in zip(outs["fused"], (jh, jd, jc.k, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    for a, b in zip(outs["fused"], outs["plain"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5)


def _collated():
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = SegDataset(CFG)
    return Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])


def test_speculative_predictor_converts_and_matches_jax(jp, tp):
    """Predictor(speculative=True) converts the caller's tree in place;
    speculative generate on it at rephrase 0.1 (q and k of the rephrase
    pooling through attn_proj) gives the JAX greedy ids and [SEG] slots,
    and the Predictor's answers are the plain greedy Predictor's."""
    fb = _collated()
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(fb["prompt_lens"][b])
        ids[b, BUCKET - n:] = fb["input_ids"][b, :n]
    batch = {"input_ids": ids, "clip_images": fb["clip_images"],
             "sam_images": fb["sam_images"]}
    want = jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT),
                   static_argnums=(1,))(
        jp, CFG, {k: jnp.asarray(v) for k, v in batch.items()})

    kw = dict(max_new_tokens=MNT, prompt_buckets=(BUCKET,), device="cpu",
              encoder_path="unfused")
    plain_ids, plain_masks = Predictor(tp, CFG, speculative=False,
                                       **kw).predict(fb)
    assert "q" in tp["llama"]["layers"][0]["attn"]
    tree = _port_copy(tp)
    spec = Predictor(tree, CFG, speculative=True, **kw)
    assert spec.params is tree
    for layer in tree["llama"]["layers"]:
        assert set(layer["attn"]) == {"qkv", "o"}
        assert set(layer["mlp"]) == {"gate_up", "down"}
    ids_s, masks_s = spec.predict(fb)
    np.testing.assert_array_equal(ids_s, np.asarray(want.output_ids))
    np.testing.assert_array_equal(ids_s, plain_ids)
    assert any(m is not None for m in masks_s)
    for a, b in zip(masks_s, plain_masks):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=2e-2,
                                       atol=2e-2 * np.abs(b).max())

    got = tanyref.generate(tree, CFG, batch, max_new_tokens=MNT,
                           speculative=True, device="cpu",
                           encoder_path="unfused")
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    ks = chip_smoke.first_seg(got.output_ids.numpy(), CFG.tokens.seg)
    assert any(k is not None and k >= 1 for k in ks), ks
    for field in ("low_res_masks", "seg_embeddings"):
        w = np.asarray(getattr(want, field), np.float32)
        np.testing.assert_allclose(getattr(got, field).float().numpy(), w,
                                   rtol=2e-2, atol=2e-2 * np.abs(w).max(),
                                   err_msg=field)


def test_serving_layout_refusals(tp):
    """int8 with speculative=True still raises (before any conversion);
    quantize_llama and LoRA raise a ValueError naming the layout on a
    transposed or fused tree."""
    q = dict(tp, llama=tquant.quantize_llama(tp["llama"]))
    with pytest.raises(ValueError, match="speculative=False"):
        Predictor(q, CFG, speculative=True, device="cpu")
    assert "w_q" in q["llama"]["layers"][0]["attn"]["q"]
    for convert in (tllama.transpose_for_serving, tllama.fuse_for_serving):
        tree = convert(_port_copy(tp["llama"]))
        with pytest.raises(ValueError, match="serving layout"):
            tquant.quantize_llama(tree)
        with pytest.raises(ValueError, match="serving layout"):
            tlora.init(torch.Generator().manual_seed(0), tree,
                       tlora.LoraConfig())
        adapters = tlora.init(torch.Generator().manual_seed(0), tp["llama"],
                              tlora.LoraConfig())
        with pytest.raises(ValueError, match="serving layout"):
            tlora.apply(tree, adapters, tlora.LoraConfig())


@pytest.mark.parametrize("name", sorted(set(tflash.OPS)
                                         - set(tflash.GROUP_OPS)))
def test_opcheck(name):
    """torch.library.opcheck of each anyref:: op at small CPU shapes
    (chip_smoke.op_cases in fp32): its schema (no aliasing, no undeclared
    mutation), its fake implementation's shapes, dtypes and strides against
    the CPU implementation's, and its trace under AOT dispatch. The ops
    over a group of ranks are opchecked on ranks
    (tests/test_torch_model_program.py)."""
    args = chip_smoke.op_cases(torch, tflash, "cpu", torch.float32)[name]
    op = getattr(torch.ops.anyref, name).default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_every_launch_is_an_op():
    """Fourteen ops, one for each unit that launches: the twelve kernels'
    wrappers, the training attention's forward and backward as two, and
    the all-reduce over a "model" group; each has a CUDA, a CPU and a fake
    implementation."""
    assert len(tflash.OPS) == 14
    for name in tflash.OPS:
        op = getattr(torch.ops.anyref, name).default
        for key in ("CUDA", "CPU", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), key), (name, key)
    wrappers = {k.__name__ for k in tflash.KERNELS}
    assert wrappers - set(tflash.OPS) == {"flash_causal_attention_diff"}
    assert set(tflash.OPS) - wrappers == {"causal_attention_diff_fwd",
                                          "causal_attention_diff_bwd",
                                          "all_reduce"}
    assert set(tflash.GROUP_OPS) == {"all_reduce"}
