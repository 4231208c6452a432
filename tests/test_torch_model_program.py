"""Meshes with a "model" axis as compiled programs: the Predictor's request
program and the Trainer's step at (1, 2) and (2, 2) in the form the card
captures on every rank (eval/runner.py, train/step.py, train/trainer.py),
whose sums over "model" go through the all-reduce op of ops/flash.py (on
the card the kernel of csrc/all_reduce.cu, which a CUDA graph holds; here
its plain version, torch.distributed over gloo). At anyref_tiny() on CPU
ranks, one spawn a mesh (tests/torch_model_program_worker.py), from a
thread while this process computes the JAX references.

What each case holds, and against what:
- the op's plain version gives every rank the same bits, those of gloo's
  all_reduce over the group, in fp32 and bf16; opcheck of the op passes on
  every rank;
- make_mesh on the CPU registers the "model" group with the op and sets
  up no device exchange; a "data" group is not the op's; Mesh.close takes
  the group out of the op (its key then raises), and a second make_mesh
  in the process registers one new key, which its close takes out too;
- at (1, 2) the Predictor's program parts (prefix, predicate, decode pass,
  suffix) on a text and a crop key issue no collective but the op's, over
  the "model" group, and read nothing from the device (NoDeviceReads); the
  program's ids equal the JAX package's single-device generate on the same
  padded batch, its low-res logits within
  test_parallel_generate_matches_jax_single_device's 4e-3;
- at (1, 2) and (2, 2) the step program, run part by part, holds only the
  op's sums inside its parts; at (2, 2) the host's data sums (the fp32
  gradient buffer and the metrics) are the only collectives between the
  parts, and the loss counts are staged over the host group first; its
  gradients equal the eager mesh step's (value_and_grad from the host) bit
  for bit and its loss terms within 1e-6;
- step 1's reduced gradients, gathered, against the JAX single-device step
  on the global batch within test_reduced_gradients_match_jax_global_
  batch's limits (tests/test_torch_parallel_train.py
  ``check_against_references``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.models import anyref as janyref
from anyref_tpu.train import step as jstep
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.tokenizer import AnyRefTokenizer
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from tests import torch_model_program_worker as MW
from tests import torch_parallel_train_worker as TW
from tests import torch_parallel_worker as W
from tests.test_torch_graph_program import _batch as serve_batch
from tests.test_torch_parallel_train import (LCFG, MICRO, _Background,
                                             _micro, _sample,
                                             check_against_references,
                                             slice_env)
from tests.test_torch_parallel_train import (jlora_params, jp,  # noqa: F401
                                             lin1, lora_np, tree_file)
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = TW._cfg()
ACCUM = 2
MASK_TOL = 4e-3     # tests/test_torch_parallel.py's
STEP_LOSS_TOL = 1e-6
RUN_LIMIT_S = 240.0
MESHES = ((1, 2), (2, 2))
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (224, 300, 3), np.uint8),
            rng.integers(0, 256, (280, 224, 3), np.uint8)]


@pytest.fixture(scope="module")
def serve_batches(images):
    return {kind: serve_batch(images, kind, uint8=False)
            for kind in ("text", "crop")}


@pytest.fixture(scope="module")
def train_batch():
    """MICRO's two global micro-batches of four rows, stacked."""
    rng = np.random.default_rng(21)
    ds = SegDataset(CFG)
    col = Collator(AnyRefTokenizer(), CFG, train=True)
    return tstep.stack_microbatches([
        col([_sample(ds, rng, 4 * m + i, p) for i, p in enumerate(rows)])
        for m, rows in enumerate(MICRO)])


@pytest.fixture(scope="module", autouse=True)
def runs(tree_file, lora_np, serve_batches, train_batch, tmp_path_factory):
    """{(data, model): every rank's model_program_task result}, spawned
    from a thread at the module's first test (the first lookup waits)."""
    tmp = tmp_path_factory.mktemp("model_ranks")

    def spawn():
        return {(d, m): W.run_ranks(
            MW.TASK, d * m, tmp, timeout=RUN_LIMIT_S, data=d, model=m,
            tree=str(tree_file), lora=lora_np, serve_batches=serve_batches,
            train_batch=train_batch, accum=ACCUM) for d, m in MESHES}

    return _Background(spawn)


@pytest.fixture(scope="module")
def jax_generate(jp, tree_file, serve_batches):  # noqa: F811
    """The JAX single-device greedy generate (unfused configuration) on
    each batch as the port's Predictor pads it: {kind: (ids, low-res)}."""
    pred = Predictor(torch.load(tree_file), CFG, max_new_tokens=MW.MNT,
                     prompt_buckets=(MW.BUCKET,), batch_buckets=(2,),
                     device="cpu", encoder_path="unfused")
    fn = jax.jit(functools.partial(janyref.generate,
                                   max_new_tokens=MW.MNT),
                 static_argnums=(1,))
    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        for name in SLICE_SWITCHES:
            mpatch.setenv(name, "0")
        for kind, batch in serve_batches.items():
            host, _, _ = pred._inputs(batch)
            g = fn(jp, janyref_cfg(), {k: jnp.asarray(v)
                                       for k, v in host.items()})
            out[kind] = (np.asarray(g.output_ids),
                         np.asarray(g.low_res_masks, np.float32))
    return out


def janyref_cfg():
    from anyref_tpu.config import anyref_tiny
    return anyref_tiny()


@pytest.fixture(scope="module")
def jax_step(jp, jlora_params, train_batch):  # noqa: F811
    """The JAX single-device value_and_grad on each global micro-batch,
    averaged over the two: (metrics, (lora grads, dense grads)) as
    numpy."""
    from anyref_tpu.train import lora as jlora
    dense, frozen = jlora.split_trainable(jp)
    fn = jax.jit(jax.value_and_grad(jstep.loss_fn, argnums=(0, 1),
                                    has_aux=True), static_argnums=(3, 4))
    runs_ = []
    for i in range(ACCUM):
        with slice_env():
            (_, m), g = fn(jlora_params, dense, frozen, janyref_cfg(), LCFG,
                           {k: jnp.asarray(v[i])
                            for k, v in train_batch.items()})
        runs_.append(({k: float(v) for k, v in jax.device_get(m).items()},
                      jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jax.device_get(g))))
    return ({k: sum(r[0][k] for r in runs_) / ACCUM for k in runs_[0][0]},
            jax.tree.map(lambda *x: sum(x) / ACCUM, *(r[1] for r in runs_)))


@pytest.fixture(scope="module")
def port_single(tree_file, lora_np, train_batch):  # noqa: F811
    """The port's single-device value_and_grad on the same global batch:
    (metrics, grads, [SEG] states)."""
    lora_p = tstep.tree_map(lambda t: t.requires_grad_(True),
                            TW._tensors(lora_np))
    dense, frozen = tlora.split_trainable(torch.load(tree_file))
    dense = tstep.tree_map(lambda t: t.detach().clone().requires_grad_(
        True), dense)
    with slice_env(), TW.record_seg_states() as seg:
        _, m, grads = tstep.value_and_grad(
            lora_p, dense, frozen, CFG, tlora.LoraConfig(), train_batch,
            encoder_path="fused", remat=False, grad_accum=ACCUM)
    return {k: float(v) for k, v in m.items()}, TW._np(grads), seg


# ---------------------------------------------------------------------------
# the op and the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_plain_all_reduce_equals_gloo_on_every_rank(runs, mesh):
    """Each rank's sum through the op's plain version, in fp32 and bf16,
    bit-equal to gloo's all_reduce over the "model" group, and the same
    bits on the ranks of one group."""
    data, model = mesh
    ranks = runs[mesh]
    for dtype in ("torch.float32", "torch.bfloat16"):
        for rank, res in enumerate(ranks):
            got, want = res["sums"][dtype]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{mesh} {rank} {dtype}")
        for d in range(data):
            first = ranks[d * model]["sums"][dtype][0]
            for m in range(1, model):
                np.testing.assert_array_equal(
                    ranks[d * model + m]["sums"][dtype][0], first)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_all_reduce_opcheck_on_every_rank(runs, mesh):
    """torch.library.opcheck of anyref::all_reduce, run on every rank of
    the mesh at once (an op over a group of ranks): its schema, its fake
    implementation against the CPU implementation, its trace under AOT
    dispatch."""
    for rank, res in enumerate(runs[mesh]):
        assert res["sums"]["opcheck"] == ["SUCCESS"], (mesh, rank)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_make_mesh_on_cpu_sets_up_no_device_exchange(runs, mesh):
    """The "model" group is the op's, with no device exchange; the mesh
    holds none; the "data" group (at (2, 2)) is not the op's."""
    for res in runs[mesh]:
        assert res["exchange"] is None
        assert res["key"] is not None
        assert res["group_exchange"] is None
        assert res["data_key"] is None


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_mesh_close_releases_the_group(runs, mesh):
    """After Mesh.close no group is the op's and the closed key raises; a
    second make_mesh registers one new key, which sums over its group, and
    its close leaves nothing registered."""
    _, model = mesh
    for rank, res in enumerate(runs[mesh]):
        got = res["closing"]
        assert got["after_close"] == [], rank
        assert "closed" in got["stale_key"], rank
        assert got["second_key"] not in (None, res["key"]), rank
        assert got["while_open"] == [got["second_key"]], rank
        assert got["second_sum"] == [float(model)] * 2, rank
        assert got["after_second"] == [], rank


# ---------------------------------------------------------------------------
# serving at (1, 2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["text", "crop"])
def test_model_axis_program_holds_only_the_op(runs, kind):
    """The program parts' only collectives are the op's all-reduces over
    the "model" group (each the gloo all_reduce of its plain version): at
    least two a decoder layer a pass; the parts read nothing."""
    for rank, res in enumerate(runs[(1, 2)]):
        got = res["serving"][kind]
        assert got["passes"] >= 1
        assert set(got["ops"]) == {(0, 1)}, (rank, set(got["ops"]))
        assert got["calls"] == [("all_reduce", (0, 1))] * len(got["ops"])
        assert len(got["ops"]) >= 2 * CFG.llama.num_layers * (
            got["passes"] + 1), (rank, len(got["ops"]))


@pytest.mark.parametrize("kind", ["text", "crop"])
def test_model_axis_program_matches_jax_single_device(runs, jax_generate,
                                                      kind):
    """Both ranks' program outputs are the same bits; their ids equal the
    JAX single-device generate's, their low-res logits within MASK_TOL."""
    want_ids, want_low = jax_generate[kind]
    lead, other = (r["serving"][kind] for r in runs[(1, 2)])
    np.testing.assert_array_equal(other["meta"], lead["meta"])
    np.testing.assert_array_equal(other["low"], lead["low"])
    np.testing.assert_array_equal(lead["meta"][:, :MW.MNT], want_ids)
    np.testing.assert_allclose(lead["low"], want_low, rtol=MASK_TOL,
                               atol=MASK_TOL)


# ---------------------------------------------------------------------------
# training at (1, 2) and (2, 2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_step_parts_hold_only_model_sums(runs, mesh):
    """Part A (prefix, micro-steps, average) and part B (the update: LoRA's
    a summed, the clipping norm) issue only the op's sums over "model";
    at (2, 2) the counts are staged over the host group and the data sums
    of the gradient buffer and the metrics are all that runs between the
    parts; at (1, 2) there is no split."""
    data, model = mesh
    for rank, res in enumerate(runs[mesh]):
        prog = res["training"]
        group = tuple(range(rank - rank % model, rank - rank % model + model))
        for part in ("part_a", "part_b"):
            calls, ops = prog[part]
            assert ops and set(ops) == {group}, (rank, part, set(ops))
            assert calls == [("all_reduce", group)] * len(ops), (rank, part)
        assert prog["split"] == (data > 1)
        calls, ops = prog["between"]
        assert ops == []
        if data > 1:
            peers = tuple(range(rank % model, data * model, model))
            assert prog["staging"] == ([("all_reduce", (0, 1, 2, 3))], [])
            assert calls == [("all_reduce", peers)] * 2, (rank, calls)
        else:
            assert prog["staging"] == ([], []) and calls == []
        assert prog["count"] == 1


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_step_program_equals_eager_mesh_step(runs, mesh):
    """The gradient the program's update read, every leaf bit-equal to the
    eager mesh step's; the loss terms within STEP_LOSS_TOL."""
    for rank, res in enumerate(runs[mesh]):
        prog = res["training"]
        metrics, grads = prog["eager"]
        for k in tstep.METRICS:
            np.testing.assert_allclose(prog["metrics"][k], metrics[k],
                                       rtol=STEP_LOSS_TOL,
                                       err_msg=f"{mesh} rank {rank} {k}")
        got, want = (tstep.tree_leaves(TW._tensors(g))
                     for g in (prog["grads"], grads))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"{mesh} rank {rank}")


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
def test_step_program_gradients_match_jax_global_batch(
        runs, jax_step, port_single, train_batch, lin1, mesh):  # noqa: F811
    """Each rank's loss terms and its gathered gradient, step 1's from the
    initial state, against the JAX single-device step (the decoder's
    trainables) and the port's single device (every leaf) on the global
    batch."""
    data, model = mesh
    ranks = runs[mesh]
    valid = _micro(train_batch["mask_valid"], ACCUM)
    seg = [np.concatenate(parts) for parts in zip(
        *(ranks[d * model]["training"]["seg"] for d in range(data)))]
    for rank, res in enumerate(ranks):
        prog = res["training"]
        check_against_references(
            {"metrics": prog["metrics"], "grads": prog["whole"]}, seg,
            jax_step, port_single, valid, lin1, f"{mesh} rank {rank}")
