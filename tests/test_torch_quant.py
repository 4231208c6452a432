"""The port's int8 weight-only decoder (ops/quant.py, the int8_matmul
kernel's plain version, llama.logits on lm_head_q, generate, Predictor and
Server) against the JAX package's ops/quant.py, on the CPU.

The JAX Pallas kernel runs in interpret mode; quant_linear and the int8
decoder take the JAX package's XLA product on the CPU, which is what the
port's plain version computes (chip_smoke.py holds the CUDA kernel against
the same plain version on the card). The towers run the unfused
configuration on both sides (tests/test_torch_generate.py's switches): the
int8 change is in the decoder only.

Tolerances: 1e-4 in fp32 (the reference's own, tests/test_quant.py: a
product of 256 terms summed in another order) and 1e-2 in bf16 (one
rounding of the output to the other side is one ulp, 2^-8 relative). Token
ids must be equal; masks within the 2e-2 of tests/test_torch_generate.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import llama as jllama
from anyref_tpu.ops import quant as jquant
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.models import llama as tllama
from anyref_tpu_torch.ops import flash as tflash
from anyref_tpu_torch.ops import quant as tquant
from anyref_tpu_torch.serve import Server
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

CFG = anyref_tiny()
MNT = 6
BUCKET = 257
TEXTS = ("the cat", "the red cat on the red mat near the open door")
DTYPES = {"float32": 1e-4, "bfloat16": 1e-2}
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return tparams.from_numpy(np.asarray(a), device="cpu")


# ---------------------------------------------------------------------------
# quantize_int8, the kernel's plain version, quant_linear
# ---------------------------------------------------------------------------
def test_quantize_int8_matches_jax():
    """w_q bit for bit (round half to even included: some entries sit on a
    half step), scale to 1 ulp; a zero column takes the 1e-8 floor."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 640)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    w[:8, 5] = np.array([127, -63.5, 0.5, 1.5, -2.5, 10, 0, 3], np.float32)
    want = jquant.quantize_int8(jnp.asarray(w))
    got = tquant.quantize_int8(torch.from_numpy(w))
    assert got["w_q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(),
                                  np.asarray(want["w_q"]))
    np.testing.assert_array_max_ulp(got["scale"].numpy(),
                                    np.asarray(want["scale"]), maxulp=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,K,N", [(1, 256, 640), (16, 256, 640),
                                      (300, 256, 640), (77, 264, 200),
                                      (2, 256, 640), (5, 264, 200),
                                      (16, 264, 640)])
def test_int8_matmul_plain_matches_pallas(rows, K, N, dtype):
    """The reference's own shapes (tests/test_quant.py): x [rows, 256]
    against w_q [256, 640], the Pallas kernel in interpret mode; the
    ragged shape on which chip_smoke.py holds the kernel's tensor-core body
    (rows > 16) at M, K not multiples of 64 and N % 16 != 0; and shapes of
    the decode body (rows <= 16): a decode step's 2 rows, 5 and 16 rows
    (one and two 8-row blocks of x) with a K tail of 8 rows, N % 16 != 0
    among them."""
    rng = np.random.default_rng(rows)
    w = jnp.asarray(rng.standard_normal((K, N)) * 0.05, jnp.float32)
    q = jquant.quantize_int8(w)
    x = jnp.asarray(rng.standard_normal((rows, K)), jnp.dtype(dtype))
    want = jquant.int8_matmul(x, q["w_q"], q["scale"], interpret=True)
    tx, tw, ts = _t(x), _t(q["w_q"]), _t(q["scale"])
    got = tquant.int8_matmul_plain(tx, tw, ts)
    assert got.dtype == getattr(torch, dtype)
    tol = DTYPES[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # the wrapper on CPU tensors is the plain version and launches nothing
    n0 = tflash.launch_counts()
    torch.testing.assert_close(tquant.int8_matmul(tx, tw, ts), got,
                               rtol=0, atol=0)
    assert tflash.launch_counts() == n0


# the 7B decoder's products at a decode step (q/k/v/o, gate/up, down,
# lm_head), x [M, K] by w_q [K, N]
DECODE_7B = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32128))
H100_SMS = 132
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024


@pytest.mark.parametrize("M,K,N", [(m, k, n) for k, n in DECODE_7B
                                   for m in (1, 2, 16)] + [(16, 264, 200)])
def test_int8_decode_plan_covers_every_weight_once(M, K, N):
    """The launch plan of int8_matmul's M <= 16 body (csrc/int8_matmul.cu
    decode_kernel: block (r, i) of a [S, ceil(N / tn)] grid takes columns
    [tn i, tn (i + 1)) and the K stages [r KT / S, (r + 1) KT / S)): every
    weight (k, n) falls in exactly one block, the K split is a cluster of
    at most 8 blocks each with at least one stage, two blocks fit an SM's
    shared memory (x's boxes ride the ring beside W's), and on the H100's
    132 SMs the 7B shapes give every SM a block in one wave."""
    plan = tflash._int8_decode_plan(M, N, K, H100_SMS)
    S, tn, bk = plan.splits, plan.tn, plan.bk
    tiles, kt = -(-N // tn), -(-K // bk)
    assert 1 <= S <= 8 and S <= kt
    assert plan.blocks == tiles * S
    k_hits = np.zeros(kt * bk, np.int64)
    for r in range(S):
        a, b = r * kt // S, (r + 1) * kt // S
        assert b > a
        k_hits[a * bk:b * bk] += 1
    n_hits = np.zeros(tiles * tn, np.int64)
    for i in range(tiles):
        n_hits[i * tn:(i + 1) * tn] += 1
    np.testing.assert_array_equal(k_hits[:K], 1)
    np.testing.assert_array_equal(n_hits[:N], 1)
    assert (tiles - 1) * tn < N and (kt - 1) * bk < K
    rows = 8 if M <= 8 else 16
    x_box = rows * bk * 2
    assert plan.smem >= tflash._I8_STAGES * (bk * tn + x_box)
    assert plan.smem <= SMEM_PER_BLOCK
    assert 2 * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
    # the four consumer warps' fp32 partials [rows, tn + 8] reuse the ring
    assert 4 * rows * (tn + 8) * 4 <= tflash._I8_STAGES * (bk * tn + x_box)
    if (K, N) in DECODE_7B:
        assert H100_SMS <= plan.blocks <= 2 * H100_SMS


def test_int8_matmul_wrapper_raises_off_cpu():
    """On any device but the CPU the wrapper launches its kernel or
    raises; it never runs the plain version there."""
    meta = torch.device("meta")
    x = torch.ones(2, 64, dtype=torch.bfloat16, device=meta)
    w = torch.ones(64, 32, dtype=torch.int8, device=meta)
    s = torch.ones(32, device=meta)
    with pytest.raises(ValueError):
        tquant.int8_matmul(x, w, s)
    with pytest.raises(ValueError):
        tquant.int8_matmul(torch.ones(2, 64, dtype=torch.bfloat16), w, s)
    assert tquant.int8_matmul in tflash.KERNELS


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quant_linear_with_bias_matches_jax(dtype):
    """The bias is added in y's dtype after the rounding of the product,
    through ops.common.linear's int8 branch."""
    from anyref_tpu.ops.common import linear as jlinear
    from anyref_tpu_torch.ops.common import linear as tlinear
    rng = np.random.default_rng(3)
    q = jquant.quantize_int8(jnp.asarray(
        rng.standard_normal((96, 48)) * 0.1, jnp.float32))
    p = dict(q, b=jnp.asarray(rng.standard_normal(48), jnp.float32))
    x = jnp.asarray(rng.standard_normal((2, 5, 96)), jnp.dtype(dtype))
    want = jlinear(p, x)
    got = tlinear({k: _t(v) for k, v in p.items()}, _t(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 5, 48)
    tol = DTYPES[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the int8 decoder tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jq(jp):
    return dict(jp, llama=jquant.quantize_llama(jp["llama"]))


@pytest.fixture(scope="module")
def tq(jq):
    """The JAX int8 tree bridged: needs from_numpy to carry the None
    lm_head and the int8 leaves."""
    return tparams.from_numpy(jax.device_get(jq), device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x, torch.Tensor))[0]


def test_from_numpy_keeps_none_and_int8():
    tree = {"a": None, "b": [np.arange(4, dtype=np.int8), None],
            "c": {"d": np.ones(2, np.float32)}}
    got = tparams.from_numpy(tree, device="cpu")
    assert got["a"] is None and got["b"][1] is None
    assert got["b"][0].dtype == torch.int8
    assert got["b"][0].tolist() == [0, 1, 2, 3]
    assert got["c"]["d"].dtype == torch.float32


def test_quantize_llama_tree_matches_jax(jp, tq):
    """quantize_llama on the bridged float tree gives the bridged JAX int8
    tree: same keys, shapes and dtypes, equal values, None kept."""
    tp_llama = tparams.from_numpy(jax.device_get(jp["llama"]), device="cpu")
    got = tquant.quantize_llama(tp_llama)
    want = tq["llama"]
    assert got["lm_head"] is None and want["lm_head"] is None
    assert tquant.is_quantized(got) and not tquant.is_quantized(tp_llama)
    assert tp_llama["lm_head"] is not None          # the input is left alone
    gl, wl = _leaves(got), _leaves(want)
    assert [jax.tree_util.keystr(k) for k, _ in gl] == \
        [jax.tree_util.keystr(k) for k, _ in wl]
    assert sorted(got["layers"][0]) == sorted(want["layers"][0])
    for (path, a), (_, b) in zip(gl, wl):
        if b is None:
            assert a is None, jax.tree_util.keystr(path)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, \
            jax.tree_util.keystr(path)
        if a.dtype == torch.int8:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            np.testing.assert_array_max_ulp(a.float().numpy(),
                                            b.float().numpy(), maxulp=1)
    assert got["embed_tokens"].dtype == torch.bfloat16


def test_logits_int8_matches_jax(jq, tq):
    """lm_head_q on bf16 hidden states: the product is rounded to bf16
    before the cast to fp32, as in the reference."""
    h = (np.random.default_rng(4).standard_normal((2, 3, 128))).astype(
        np.float32)
    jh = jnp.asarray(h, jnp.bfloat16)
    want = jllama.logits(jq["llama"], jh)
    got = tllama.logits(tq["llama"], _t(jh))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=1e-2)
    # rounded to bf16 first: every logit is a bf16 value
    assert torch.equal(got, got.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# generate, Predictor, Server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def float_batch():
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = SegDataset(CFG)
    return Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])


def _left_padded(batch):
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(batch["prompt_lens"][b])
        ids[b, BUCKET - n:] = batch["input_ids"][b, :n]
    return {"input_ids": ids, "clip_images": batch["clip_images"],
            "sam_images": batch["sam_images"]}


def _jax_generate(jq, inputs, **kw):
    return jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT,
                                     **kw), static_argnums=(1,))(
        jq, CFG, {k: jnp.asarray(v) for k, v in inputs.items()})


@pytest.fixture(scope="module")
def port_greedy(tq, float_batch):
    return tanyref.generate(tq, CFG, _left_padded(float_batch),
                            max_new_tokens=MNT, device="cpu",
                            encoder_path="unfused")


def test_generate_int8_matches_jax(jq, port_greedy, float_batch):
    """Greedy decode on the int8 decoder (prefill and decode steps through
    int8 products, the int8 lm_head): ids, counts and [SEG] validity equal
    to the JAX ids, masks within 2e-2."""
    want = _jax_generate(jq, _left_padded(float_batch))
    got = port_greedy
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    np.testing.assert_allclose(got.low_res_masks.numpy(),
                               np.asarray(want.low_res_masks),
                               atol=2e-2, rtol=2e-2)


def test_speculative_int8_matches_jax(jq, tq, port_greedy, float_batch):
    """generate(speculative=True) on the int8 tree runs in the reference;
    the port's ids equal the JAX ids (and the greedy ones)."""
    inputs = _left_padded(float_batch)
    want = _jax_generate(jq, inputs, speculative=True, draft_len=3)
    got = tanyref.generate(tq, CFG, inputs, max_new_tokens=MNT,
                           speculative=True, draft_len=3, device="cpu",
                           encoder_path="unfused")
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  port_greedy.output_ids.numpy())


def test_predictor_int8_matches_generate(tq, port_greedy, float_batch):
    pred = Predictor(tq, CFG, max_new_tokens=MNT, prompt_buckets=(BUCKET,),
                     batch_buckets=(2,), speculative=False, device="cpu",
                     encoder_path="unfused")
    ids, masks = pred.predict(float_batch)
    np.testing.assert_array_equal(ids, port_greedy.output_ids.numpy())
    assert len(masks) == 2 and pred.completed_batches == 1


def test_speculative_serving_refuses_int8(tq):
    """The reference's speculative Predictor needs the bf16 serving layout:
    Predictor and Server (speculative by default) refuse an int8 tree with
    speculative serving, and take it greedy."""
    with pytest.raises(ValueError, match="speculative=False"):
        Predictor(tq, CFG, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="speculative=False"):
        Server(tq, CFG, preprocess_workers=1, device="cpu")
    srv = Server(tq, CFG, speculative=False, preprocess_workers=1,
                 device="cpu")
    srv.shutdown()
