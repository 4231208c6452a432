"""Multi-device training in the port (the Trainer over a ("data", "model")
mesh, the tensor-parallel training forward and backward, the rank-sharded
loader, checkpoints across ranks and the training CLI's launch flags)
against the JAX package's single-device step on the global batch.

One step at mesh (D, M) must compute what the JAX single-device step
computes on the global batch: the union of the D data ranks' rows in
data-rank order. The ranks are spawned CPU processes over gloo
(tests/torch_parallel_worker.py ``run_ranks``: a FileStore a run, a 60 s
collective timeout, a limit on each run), one spawn a mesh, every check of
that mesh in it (tests/torch_parallel_train_worker.py). The JAX side runs
the fused configuration of tests/test_torch_train.py, its Pallas kernels in
interpret mode, on the JAX init bridged by params.from_numpy. The global
batches hold rows with different numbers of valid tokens and masks on the
two data ranks, so a mean of the ranks' means would fail.

What each step is held against:
- the loss terms and the gradients of the decoder's trainables (LoRA,
  embed_tokens, lm_head): the JAX single-device step on the global batch;
- every trainable leaf's gradient: the port's single-device step on the
  same global batch (itself held against the JAX step by
  tests/test_torch_train.py). The leaves downstream of the [SEG] states
  (text_hidden_fcs, the mask decoder) follow text_hidden_fcs' ReLU gates
  on the bf16 [SEG] states, a few of which sit within the bf16 rounding of
  the two packages' decoders of zero: on these global batches one or two
  of the 768 gates flip between the packages (on the CPU), moving lin1's
  gradient by up to 25% of its largest element while every loss term
  agrees to 1e-4 (tests/test_torch_train.py's batches happen to flip
  none). The port's single device sums in the same order as one rank up to
  the row-parallel sums, which flip no gate here.

Tolerances, each with its reason:
- loss terms: 1e-3 relative; reduced gradients, gathered: 2e-2 of each
  leaf's largest magnitude (tests/test_torch_train.py's limits: the
  decoder runs bf16 activations on both sides, and the row-parallel sums,
  one rounding falling the other way, are 2^-8 relative);
- the sharded AdamW against the full-tree AdamW on the same whole
  gradient: rtol 1e-5 (atol 1e-7), the same fp32 arithmetic summed in
  another order;
- the autograd collectives' MLP, fp64: 1e-12 relative;
- the Trainer's step-1 loss on 2 ranks against a single rank's on the same
  global batch: 1e-3 relative (the first limit; the rows' order differs at
  (2, 1));
- a checkpoint saved at (1, 2) and resumed at (1, 1) and (2, 1), against
  the uninterrupted (1, 2) run at step 2: the restored state bit-equal to
  the saved one; the Adam moments within 2e-2 (mu) and 4e-2 (nu, the
  square) of each leaf's largest, being sums of gradients; the weights
  within 2.5 x the learning rate of step 2: Adam moves every weight by at
  most about the learning rate whatever the size of its gradient, so two
  runs whose gradients differ by the limit above may move a weight of
  near-zero gradient in opposite directions;
- the CLI's merged.pt on 2 ranks against a single rank's: bit-equal (the
  first step's learning rate is 0, so the gathered tree is the initial
  one).
"""

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from anyref_tpu.config import anyref_tiny
from anyref_tpu.data import loader as jloader
from anyref_tpu.models import anyref as janyref
from anyref_tpu.train import lora as jlora
from anyref_tpu.train import step as jstep
from anyref_tpu_torch import checkpoint as tckpt
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.data.loader import DataLoader
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
from tests import torch_parallel_train_worker as TW
from tests import torch_parallel_worker as W
from tests.torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = anyref_tiny()
SLICE_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "1", "ANYREF_FUSED_GLOBAL_BLOCK": "1",
             "ANYREF_FUSED_SPLIT": "1", "ANYREF_QKV_MHA_KERNEL": "1",
             "ANYREF_QKV_WINDOW_KERNEL": "0"}
LCFG = jlora.LoraConfig()
# two global micro-batches of 4 rows; at D = 2 rows 0-1 go to data rank 0
# and rows 2-3 to data rank 1, which hold other numbers of masks (1 + 1
# against 2 + 1 in the first, 2 + 1 against 1 + 1 in the second) and of
# answer tokens
MICRO = ((("a cat",), ("a dog",), ("the small striped rat near the door",
                                   "a pig"), ("a hen",)),
         (("the old grey goat", "a cow"), ("an owl",), ("a fox",),
          ("a bee",)))
GRAD_TOL, LOSS_TOL = 2e-2, 1e-3
# text_hidden_fcs units whose ReLU gate may differ between a rank and the
# single device, at the kink (see _kink_units): at most 5% of the 128
KINK_UNITS = 6
TRAIN_LR = 1e-3
RUN_LIMIT_S = 240.0


@contextlib.contextmanager
def slice_env():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SLICE_ENV.items():
            mp.setenv(name, value)
        yield


def _sample(ds, rng, i, phrases):
    """A collator-ready sample naming ``phrases``, one rectangle mask and
    one [SEG] each."""
    h, w = ((224, 300), (280, 224))[i % 2]
    masks = np.zeros((len(phrases), h, w), np.uint8)
    for j in range(len(phrases)):
        masks[j, h // 5 + 9 * j:h // 2 + 7 * i, w // 6:w // 2 + 11 * j] = 1
    answer = " and ".join(f"{p}[SEG]" for p in phrases) + "."
    return ds.make_sample(rng.integers(0, 256, (h, w, 3), np.uint8),
                          seg_question(" and ".join(phrases)), answer, masks,
                          file_name=f"{i}.jpg")


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(21)
    ds = SegDataset(CFG)
    return [[_sample(ds, rng, 4 * m + i, p) for i, p in enumerate(rows)]
            for m, rows in enumerate(MICRO)]


@pytest.fixture(scope="module")
def batches(samples):
    """{1: the first global micro-batch, 2: both stacked [2, 4, ...]}."""
    col = Collator(AnyRefTokenizer(), CFG, train=True)
    micro = [col(s) for s in samples]
    return {1: tstep.device_batch(micro[0]),
            2: tstep.stack_microbatches(micro)}


@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tree_file(jp, tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel_train") / "tree.pt"
    torch.save(tparams.from_numpy(jax.device_get(jp), device="cpu"), path)
    return path


@pytest.fixture(scope="module")
def jlora_params(jp):
    """JAX LoRA init with B small and random (B = 0 would zero A's
    gradient and hide a wrong sum over "model")."""
    lp = jlora.init(jax.random.key(1), jp["llama"], LCFG)
    rng = np.random.default_rng(11)
    for layer in lp["layers"]:
        for t in layer.values():
            t["b"] = jnp.asarray(0.02 * rng.standard_normal(t["b"].shape),
                                 jnp.float32)
    return lp


@pytest.fixture(scope="module")
def lora_np(jlora_params):
    return jax.tree.map(np.asarray, jax.device_get(jlora_params))


@pytest.fixture(scope="module")
def jax_ref(jp, jlora_params, batches):
    """The JAX single-device value_and_grad on the global batches:
    {"accum1": first micro-batch, "accum2": the mean over both,
    "rephrase": the first at rephrase_weight 0.1}, each (metrics, (lora
    grads, dense grads)) as numpy."""
    dense, frozen = jlora.split_trainable(jp)
    fn = jax.jit(jax.value_and_grad(jstep.loss_fn, argnums=(0, 1),
                                    has_aux=True), static_argnums=(3, 4))

    def run(cfg, batch):
        with slice_env():
            (_, m), g = fn(jlora_params, dense, frozen, cfg, LCFG,
                           {k: jnp.asarray(v) for k, v in batch.items()})
        return ({k: float(v) for k, v in jax.device_get(m).items()},
                jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jax.device_get(g)))

    micro = [{k: v[i] for k, v in batches[2].items()} for i in range(2)]
    first, second = run(CFG, micro[0]), run(CFG, micro[1])
    accum2 = ({k: (first[0][k] + second[0][k]) / 2 for k in first[0]},
              jax.tree.map(lambda a, b: (a + b) / 2, first[1], second[1]))
    return {"accum1": first, "accum2": accum2,
            "rephrase": run(CFG.scaled(rephrase_weight=0.1), micro[0])}


GRAD_CASES = (("accum1", 1, 0.0, False), ("accum2", 2, 0.0, True))
REPHRASE_CASE = (("rephrase", 1, 0.1, False),)


@pytest.fixture(scope="module")
def adamw_grads(tree_file, lora_np):
    """Two whole (lora, dense) gradient trees from a seed: the first with a
    global norm above the clip of 1.0, the second below it."""
    dense = TW._np(tlora.split_trainable(torch.load(tree_file))[0])
    rng = np.random.default_rng(5)
    return [jax.tree.map(lambda x: (scale * rng.standard_normal(
        x.shape)).astype(np.float32), [lora_np, dense])
        for scale in (1e-2, 1e-5)]


class _Background:
    """A fixture's value made by a thread, so that the test process computes
    its references meanwhile: the first lookup waits for it (and raises
    what it raised)."""

    def __init__(self, fn):
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._future = self._pool.submit(fn)
        self._pool.shutdown(wait=False)

    def __getitem__(self, key):
        return self._future.result()[key]


@pytest.fixture(scope="module")
def runs(tree_file, lora_np, batches, samples, adamw_grads,
         tmp_path_factory):
    """{(data, model): every rank's mesh_task result}, spawned from a
    thread while the JAX and single-device references are computed. (1,
    2) first: its Trainer's checkpoint-1 is what (2, 1) and (1, 1) resume
    from."""
    tmp = tmp_path_factory.mktemp("ranks")
    flat = samples[0]
    common = dict(tree=str(tree_file), lora=lora_np, batches=batches)

    def spawn():
        out = {}
        out[(1, 2)] = W.run_ranks(
            TW.TASK, 2, tmp, timeout=RUN_LIMIT_S, data=1, model=2,
            grad_cases=GRAD_CASES + REPHRASE_CASE,
            adamw=adamw_grads, mlp=True,
            trainers=[("trainer", dict(
                samples=flat, out=str(tmp / "run12"), own_mesh=True,
                mesh_model_axis=2, per_device_batch_size=4, max_steps=2,
                resume=False))], **common)
        resume = tmp / "resume21"
        shutil.copytree(tmp / "run12" / "checkpoint-1",
                        resume / "checkpoint-1")
        out[(2, 1)] = W.run_ranks(
            TW.TASK, 2, tmp, timeout=RUN_LIMIT_S, data=2, model=1,
            grad_cases=GRAD_CASES,
            trainers=[("trainer", dict(samples=flat,
                                       out=str(tmp / "run21"),
                                       per_device_batch_size=2, max_steps=1,
                                       resume=False)),
                      ("resumed", dict(samples=flat, out=str(resume),
                                       per_device_batch_size=2,
                                       max_steps=2))],
            **common)
        out[(2, 2)] = W.run_ranks(TW.TASK, 4, tmp, timeout=RUN_LIMIT_S,
                                  data=2, model=2, grad_cases=GRAD_CASES,
                                  **common)
        out["tmp"] = tmp
        return out

    return _Background(spawn)


def _pairs(got, want, path=""):
    """(path, got leaf, want leaf) of two trees of one structure; None
    positions skipped (numpy or tensor leaves)."""
    if want is None:
        assert got is None, path
        return []
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [p for k in want for p in _pairs(got[k], want[k],
                                                f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in _pairs(g, w, f"{path}/{i}")]
    return [(path, got, want)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# (i) the loader's shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "ordered"])
@pytest.mark.parametrize("index", [0, 1])
def test_loader_shards_match_jax(index, shuffle):
    """The rank's shard at (index, 2), epoch after epoch, and its length,
    equal the JAX loader's; the two shards are disjoint."""
    data = list(range(23))

    def make(cls, i):
        return cls(data, list, batch_size=3, shuffle=shuffle, num_workers=2,
                   seed=3, drop_last=True, process_index=i, process_count=2)
    want, got = make(jloader.DataLoader, index), make(DataLoader, index)
    other = make(DataLoader, 1 - index)
    assert len(got) == len(want) == (4, 3)[index]   # 12 and 11 items
    for _ in range(2):
        mine = list(got)
        assert mine == list(want)
        assert not {x for b in mine for x in b} & {
            x for b in other for x in b}


# ---------------------------------------------------------------------------
# (ii) one step's loss terms and reduced gradients against JAX
# ---------------------------------------------------------------------------
def test_global_batch_splits_unevenly(batches):
    """The data ranks of D = 2 hold different numbers of masks and of
    answer tokens in both micro-batches."""
    b = batches[2]
    for i in range(2):
        masks = b["mask_valid"][i].sum(1)
        tokens = (b["labels"][i] != -100).sum(1)
        assert masks[:2].sum() != masks[2:].sum()
        assert tokens[:2].sum() != tokens[2:].sum()


@pytest.fixture(scope="module")
def port_single(tree_file, lora_np, batches):
    """The port's single-device value_and_grad on the same global batches
    (as jax_ref): {case: (metrics, (lora grads, dense grads))} as numpy."""
    out = {}
    for case, accum, rephrase, remat in GRAD_CASES + REPHRASE_CASE:
        lora_p = tstep.tree_map(lambda t: t.requires_grad_(True),
                                TW._tensors(lora_np))
        dense, frozen = tlora.split_trainable(torch.load(tree_file))
        dense = tstep.tree_map(lambda t: t.detach().clone().requires_grad_(
            True), dense)
        with slice_env(), TW.record_seg_states() as seg:
            _, m, grads = tstep.value_and_grad(
                lora_p, dense, frozen, CFG.scaled(rephrase_weight=rephrase),
                tlora.LoraConfig(), batches[accum], encoder_path="fused",
                remat=remat, grad_accum=accum)
        out[case] = ({k: float(v) for k, v in m.items()}, TW._np(grads),
                     seg)
    return out


@pytest.fixture(scope="module")
def lin1(tree_file):
    p = torch.load(tree_file)["text_hidden_fcs"]["lin1"]
    return p["w"].numpy(), p["b"].numpy()


def _gates(seg, valid, lin1):
    """text_hidden_fcs' ReLU pre-activations [valid slots, units] of the
    [SEG] states of each micro-step, stacked."""
    w, b = lin1
    return np.concatenate([(h @ w + b)[np.asarray(v, bool)]
                           for h, v in zip(seg, valid)])


def _kink_units(seg, want_seg, valid, lin1, what):
    """The units whose ReLU gate differs between two runs on some valid
    [SEG] slot; each must sit at the kink (|pre-activation| within 1e-2 of
    the largest, in both runs) and there may be at most KINK_UNITS. (The
    rephrase case at (1, 2) flips 3 gates at 1e-4 to 1e-3 of the largest:
    its [SEG] states differ from the single device's by one bf16 rounding,
    0.5% of the largest, on the CPU.)"""
    pre, want = _gates(seg, valid, lin1), _gates(want_seg, valid, lin1)
    flip = (pre > 0) != (want > 0)
    units = np.flatnonzero(flip.any(0))
    assert len(units) <= KINK_UNITS, (what, units)
    for a in (pre, want):
        assert (np.abs(a)[flip] <= 1e-2 * np.abs(a).max()).all(), what
    return units


def _decoder_side(path: str) -> bool:
    return path.startswith(("lora/", "dense/llama/"))


def check_against_references(res: dict, seg: list, jax_case, single_case,
                             valid, lin1, what: str):
    """One case of a rank's result (``seg``: the [SEG] states of the global
    batch, each micro-step's joined over the data ranks): the loss terms
    and the decoder's gradients against JAX, every gradient against the
    port's single device (see the module docstring); text_hidden_fcs.lin1
    on the units whose ReLU gates agree with the single device's."""
    jm, (jg_lora, jg_dense) = jax_case
    for k in tstep.METRICS:
        np.testing.assert_allclose(res["metrics"][k], jm[k], rtol=LOSS_TOL,
                                   err_msg=f"{what} {k}")
    if "grads" not in res:
        return
    g_lora, g_dense = res["grads"]
    s_lora, s_dense = single_case[1]
    kink = _kink_units(seg, single_case[2], valid, lin1, what)
    keep = np.setdiff1d(np.arange(lin1[1].shape[0]), kink)
    g_dense = {**g_dense, "text_hidden_fcs": {
        **g_dense["text_hidden_fcs"], "lin1": {
            "w": g_dense["text_hidden_fcs"]["lin1"]["w"][:, keep],
            "b": g_dense["text_hidden_fcs"]["lin1"]["b"][keep]}}}
    s_dense = {**s_dense, "text_hidden_fcs": {
        **s_dense["text_hidden_fcs"], "lin1": {
            "w": s_dense["text_hidden_fcs"]["lin1"]["w"][:, keep],
            "b": s_dense["text_hidden_fcs"]["lin1"]["b"][keep]}}}
    on_jax = [p for p in _pairs(g_lora, jg_lora, "lora")
              + _pairs(g_dense, jg_dense, "dense") if _decoder_side(p[0])]
    on_single = _pairs(g_lora, s_lora, "lora") + _pairs(g_dense, s_dense,
                                                        "dense")
    assert len(on_jax) == len(jax.tree.leaves(jg_lora)) + 2
    assert len(on_single) == len(jax.tree.leaves(jg_lora)) + len(
        jax.tree.leaves(jg_dense))
    for ref, pairs in (("JAX", on_jax), ("the port's single device",
                                         on_single)):
        for path, got, want in pairs:
            assert got.shape == want.shape, path
            np.testing.assert_allclose(
                got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                err_msg=f"{what} {path} against {ref}")
    assert np.abs(g_lora["layers"][0]["q"]["a"]).max() > 0
    assert np.abs(g_dense["sam"]["mask_decoder"]["mask_tokens"]).max() > 0


@pytest.mark.parametrize("case", ["accum1", "accum2"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_reduced_gradients_match_jax_global_batch(runs, jax_ref, port_single,
                                                  batches, lin1, mesh, case):
    """Every rank reports the global batch's loss terms; rank 0's reduced
    gradient, gathered, is the global batch's."""
    accum = 1 if case == "accum1" else 2
    valid = _micro(batches[accum]["mask_valid"], accum)
    for rank, res in enumerate(runs[mesh]):
        check_against_references(
            res[case], _global_seg(runs[mesh], case, mesh), jax_ref[case],
            port_single[case], valid, lin1, f"{mesh} rank {rank} {case}")


def _micro(x, accum):
    return [x] if accum == 1 else list(x)


def _global_seg(ranks, case, mesh):
    """Each micro-step's [SEG] states of the global batch: the data ranks'
    rows (those of model coordinate 0) joined in data-rank order."""
    data, model = mesh
    per_rank = [ranks[d * model][case]["seg"] for d in range(data)]
    return [np.concatenate(parts) for parts in zip(*per_rank)]


# ---------------------------------------------------------------------------
# (iii) the sharded optimizer
# ---------------------------------------------------------------------------
def test_sharded_adamw_matches_full_tree(runs, tree_file, lora_np,
                                         adamw_grads):
    grads = adamw_grads
    norms = [float(np.sqrt(sum(np.sum(np.square(x)) for x in
                               jax.tree.leaves(g)))) for g in grads]
    assert norms[0] > 1.0 > norms[1], norms
    tp = torch.load(tree_file)
    lora_p = TW._tensors(lora_np)
    dense = tlora.split_trainable(tp)[0]
    params = (lora_p, dense)
    opt = tstep.make_optimizer(lr=1e-2, warmup=0, total_steps=3)
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(TW._tensors(g), state, params)
        for p, u in zip(tstep.tree_leaves(params), tstep.tree_leaves(updates)):
            p.add_(u)
    got = runs[(1, 2)][0]["adamw"]
    for name, want in (("params", params), ("mu", state.mu),
                       ("nu", state.nu)):
        pairs = _pairs(got[name], list(want), name)
        assert len(pairs) == len(tstep.tree_leaves(params))
        for path, a, b in pairs:
            np.testing.assert_allclose(a, _f32(b), rtol=1e-5, atol=1e-7,
                                       err_msg=path)


# ---------------------------------------------------------------------------
# (iv) the autograd collectives
# ---------------------------------------------------------------------------
def test_collective_pair_gives_single_rank_mlp_gradients(runs):
    """copy_to_group / reduce_from_group around a column -> row-parallel
    MLP at M = 2: each rank's gradients of the input and of its weight
    blocks are the single rank's (a second sum in the backward would
    double the input's)."""
    for res in runs[(1, 2)]:
        assert max(res["mlp"]) < 1e-12, res["mlp"]


# ---------------------------------------------------------------------------
# (v) rephrase pooling over "model"
# ---------------------------------------------------------------------------
def test_rephrase_gradients_match_jax_at_1x2(runs, jax_ref, port_single,
                                            batches, lin1):
    """rephrase_weight 0.1 at (1, 2): the head mean of the final layer's
    attention row sums the ranks' heads under autograd."""
    res = runs[(1, 2)]
    for rank, r in enumerate(res):
        check_against_references(
            r["rephrase"], _global_seg(res, "rephrase", (1, 2)),
            jax_ref["rephrase"], port_single["rephrase"],
            [batches[1]["mask_valid"]], lin1, f"(1, 2) rank {rank} rephrase")
    # the pooled term reaches the mask losses
    assert res[0]["rephrase"]["metrics"]["bce_loss"] != \
        res[0]["accum1"]["metrics"]["bce_loss"]


# ---------------------------------------------------------------------------
# (vi) the Trainer across ranks, (vii) checkpoints across meshes
# ---------------------------------------------------------------------------
class _Dataset(TW.ListDataset):
    pass


def _single(tree_file, samples, out, **kw):
    tc = TrainConfig(output_dir=str(out), grad_accum_steps=1, warmup_steps=1,
                     save_steps=1, log_steps=1, learning_rate=TRAIN_LR,
                     remat=True, encoder_path="fused",
                     per_device_batch_size=4, **kw)
    with slice_env():
        return Trainer(CFG, tc, torch.load(tree_file),
                       dataset=_Dataset(samples), device="cpu")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def single_run(tree_file, samples, runs):
    """The single-rank Trainer over the same 4 samples, 2 steps."""
    out = runs["tmp"] / "single"
    trainer = _single(tree_file, samples[0], out, max_steps=2, resume=False)
    trainer.train()
    return _records(out / "metrics.jsonl")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_trainer_logs_once_and_matches_single_rank(runs, single_run, mesh):
    ranks = runs[mesh]
    run = runs["tmp"] / ("run12" if mesh == (1, 2) else "run21")
    recs = _records(run / "metrics.jsonl")
    n_steps = 2 if mesh == (1, 2) else 1
    assert [r["step"] for r in recs] == list(range(1, n_steps + 1))
    assert [r["trainer"]["writer"] for r in ranks] == [True, False]
    assert all(r["trainer"]["mesh"] == {"data": mesh[0], "model": mesh[1]}
               for r in ranks)
    # each data rank loads its own shard of per_device_batch_size rows
    assert [r["trainer"]["shard"] for r in ranks] == (
        [(0, 1), (0, 1)] if mesh == (1, 2) else [(0, 2), (1, 2)])
    assert np.isfinite(recs[0]["loss"])
    np.testing.assert_allclose(recs[0]["loss"], single_run[0]["loss"],
                               rtol=LOSS_TOL)
    assert sorted(os.listdir(run)) == [f"checkpoint-{s}" for s in
                                       range(1, n_steps + 1)] + [
        "metrics.jsonl"]


def _close_states(got, want, what):
    """mu, nu and the weights of two train states (see the module
    docstring)."""
    assert got["step"] == want["step"] == 2, what
    for name, rel in (("mu", 2e-2), ("nu", 4e-2)):
        for path, a, b in _pairs(got[name], want[name], name):
            np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(
                b).max() + 1e-30, err_msg=f"{what} {path}")
    lr = tstep.warmup_decay_schedule(TRAIN_LR, 1, 2)(1)
    for name in ("lora", "dense"):
        for path, a, b in _pairs(got[name], want[name], name):
            np.testing.assert_allclose(a, b, rtol=0, atol=2.5 * lr,
                                       err_msg=f"{what} {path}")


def test_checkpoint_resumes_on_other_meshes(runs, tree_file, samples):
    """checkpoint-1 of the (1, 2) run holds whole leaves (the single-device
    format); resumed at (2, 1) and at (1, 1) it restores bit for bit and
    runs step 2 to the (1, 2) run's step-2 state."""
    want = runs[(1, 2)][0]["trainer"]
    saved = tckpt.restore_train_state(str(runs["tmp"] / "run12" /
                                          "checkpoint-1"))
    assert saved["step"] == 1
    lora_shapes = {tuple(t.shape) for t in tstep.tree_leaves(saved["lora"])}
    assert (CFG.llama.num_heads * CFG.llama.head_dim,
            8) in lora_shapes or (8, CFG.llama.num_heads
                                  * CFG.llama.head_dim) in lora_shapes
    assert saved["dense"]["llama"]["lm_head"].shape[1] == \
        CFG.llama.padded_vocab_size

    resumed = runs[(2, 1)][0]["resumed"]
    for path, a, b in _pairs(resumed["start"]["lora"], saved["lora"]):
        np.testing.assert_array_equal(a, _f32(b), err_msg=path)
    _close_states(resumed, want, "(2, 1)")

    out = runs["tmp"] / "resume11"
    shutil.copytree(runs["tmp"] / "run12" / "checkpoint-1",
                    out / "checkpoint-1")
    trainer = _single(tree_file, samples[0], out, max_steps=2)
    assert trainer.state.step == 1
    for path, a, b in _pairs(trainer.state.opt_state.mu,
                             saved["opt_state"]["mu"]):
        assert torch.equal(a, b), path
    with slice_env():
        trainer.train()
    s = trainer.state
    _close_states({"step": s.step, "lora": TW._np(s.lora),
                   "dense": TW._np(s.dense), "mu": TW._np(s.opt_state.mu),
                   "nu": TW._np(s.opt_state.nu)}, want, "(1, 1)")


# ---------------------------------------------------------------------------
# (viii) the training CLI on two ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_root")
    chip_smoke.write_train_root(str(root), (48, 64), 2)
    return str(root)


def _cli(args, root, out_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "anyref_tpu_torch.tools.train", "--preset",
         "tiny", "--device", "cpu", "--train_datasets", "refer_seg_refcoco",
         "--data_root", root, "--output_dir", str(out_dir),
         "--max_steps", "1", "--grad_accum_steps", "1",
         "--per_device_batch_size", "1", "--encoder_path", "unfused",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_cli_two_ranks_write_one_merged_file(train_root, tmp_path):
    """--multihost --coordinator file://... --num_processes 2 --process_id
    i --mesh_model_axis 2 (gloo, the CPU's default) beside a single-rank
    run of the same flags otherwise."""
    store = tmp_path / "store"
    procs = [_cli(["--multihost", "--coordinator", f"file://{store}",
                   "--num_processes", "2", "--process_id", str(i),
                   "--mesh_model_axis", "2"], train_root, tmp_path / "ranks")
             for i in range(2)]
    procs.append(_cli([], train_root, tmp_path / "single"))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    # rank 0 alone writes merged.pt and says so
    assert ["wrote" in o for o in outs[:2]] == [True, False]
    got = tckpt.load_params(str(tmp_path / "ranks" / "merged.pt"),
                            device="cpu")
    want = tckpt.load_params(str(tmp_path / "single" / "merged.pt"),
                             device="cpu")
    pairs = _pairs(got, want)
    assert len(pairs) == len(tstep.tree_leaves(want))
    for path, a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), path
