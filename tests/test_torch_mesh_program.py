"""Data-parallel meshes as compiled programs: the Predictor's request
program and the Trainer's step on a ("data", 1) mesh, in the form the card
captures on every rank (eval/runner.py, train/step.py, train/trainer.py),
at anyref_tiny() on two CPU ranks over gloo (one spawn shared by the
file's cases: tests/torch_mesh_program_worker.py).

What each case holds, and against what:
- at (2, 1) the Predictor's program parts (prefix, predicate, decode pass,
  suffix) on the text key and on a crop key issue no collective and read
  nothing from the device (tests/torch_dispatch_modes.py's NoDeviceReads,
  the graph-program tests' mode); predict_async issues none either and
  hands back the rank's rows, and complete() gathers them over the host
  group, once;
- at (1, 2) the same parts issue the "model" axis's all-reduces: the
  reason such a mesh stays eager on the card;
- at (2, 1) the Trainer's part A (prefix, micro-steps, average) issues no
  collective and reads nothing, the data sums of the gradients and the
  metrics are the only collectives between part A and part B, and part B
  issues none;
- at (2, 1) the split step's gradients (those its update read) equal
  bit for bit those of the eager mesh step as it was before the split (the
  loss terms' all-reduce of sum and count inside each micro-step, then
  all_reduce_grads over "data"), and its loss terms those of that step
  within 1e-6 relative (the ranks' shares summed against the sums'
  quotient, fp32);
- the Trainer at (2, 1) logs the global batch's losses once, step 1's
  within tests/test_torch_parallel_train.py's 1e-3 of the port's single
  device on the ranks' batches joined;
- the host's loss counts (models/anyref.py ``loss_counts``) equal those
  the device computes inside the losses, on batches with a crop, a box and
  audio;
- predict on both ranks, and a leader Server with a follower (whose
  requests the Server collates into the text batch), give one process's
  ids.
"""

import numpy as np
import pytest
import torch

from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.eval.runner import Predictor
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.ops import losses as tlosses
from anyref_tpu_torch.tokenizer import AnyRefTokenizer
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from tests import torch_mesh_program_worker as MW
from tests import torch_parallel_train_worker as TW
from tests import torch_parallel_worker as W
from tests.test_torch_graph_program import TEXTS as SERVE_TEXTS
from tests.test_torch_graph_program import _batch as serve_batch
from tests.test_torch_parallel_train import _Background, _sample
from tests.test_torch_train_program import _batch as train_batch
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = anyref_tiny()
ACCUM = 2
LOSS_TOL = 1e-3     # tests/test_torch_parallel_train.py's
SPLIT_LOSS_TOL = 1e-6
RUN_LIMIT_S = 240.0
# the global micro-batches of the split step: a row a rank, whose halves
# hold different numbers of masks and answer tokens
MICRO = ((("a cat",), ("the small striped rat near the door", "a pig")),
         (("the old grey goat", "a cow"), ("an owl",)))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (224, 300, 3), np.uint8),
            rng.integers(0, 256, (280, 224, 3), np.uint8)]


@pytest.fixture(scope="module")
def tree_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_program") / "tree.pt"
    torch.save(tparams.init(CFG, torch.Generator().manual_seed(0),
                            torch.float32, device="cpu"), path)
    return path


@pytest.fixture(scope="module")
def lora_np(tree_file):
    """The port's LoRA init with b small and random (b = 0 would zero a's
    gradient)."""
    lp = tlora.init(torch.Generator().manual_seed(1),
                    torch.load(tree_file)["llama"], tlora.LoraConfig())
    rng = np.random.default_rng(11)
    for layer in lp["layers"]:
        for t in layer.values():
            t["b"] = torch.from_numpy(
                0.02 * rng.standard_normal(t["b"].shape).astype(np.float32))
    return TW._np(lp)


@pytest.fixture(scope="module")
def global_batch():
    """Two stacked global micro-batches of MICRO's rows."""
    rng = np.random.default_rng(21)
    ds = SegDataset(CFG)
    col = Collator(AnyRefTokenizer(), CFG, train=True)
    return tstep.stack_microbatches([
        col([_sample(ds, rng, 2 * m + i, p) for i, p in enumerate(rows)])
        for m, rows in enumerate(MICRO)])


@pytest.fixture(scope="module")
def trainer_samples():
    rng = np.random.default_rng(5)
    ds = SegDataset(CFG)
    return [_sample(ds, rng, i, p) for i, p in enumerate(
        (("a cat",), ("the small striped rat", "a pig"), ("a hen",),
         ("the old grey goat",)))]


@pytest.fixture(scope="module")
def batches(images):
    return {kind: serve_batch(images, kind) for kind in ("text", "crop")}


@pytest.fixture(scope="module", autouse=True)
def runs(tree_file, lora_np, images, batches, global_batch, trainer_samples,
         tmp_path_factory):
    """Every rank's result ({"ranks": [...], "tmp": the run's directory}),
    spawned from a thread at the module's first test, so that the cases
    of this process run meanwhile (tests/test_torch_parallel_train.py's
    _Background: the first lookup waits). The Server's requests are the
    text batch's two, twice: the Server collates each pair into that
    batch."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")

    def spawn():
        ranks = W.run_ranks(
            MW.TASK, 2, tmp, timeout=RUN_LIMIT_S, tree=str(tree_file),
            lora=lora_np, serve_batches=batches, serve_images=images * 2,
            serve_texts=SERVE_TEXTS * 2, train_batch=global_batch,
            accum=ACCUM, samples=trainer_samples, out=str(tmp / "trainer"))
        return {"ranks": ranks, "tmp": tmp}

    return _Background(spawn)


@pytest.fixture(scope="module")
def single(batches, tree_file):
    """One process's Predictor on each batch: {kind: (meta, ids)}."""
    pred = Predictor(torch.load(tree_file), CFG, max_new_tokens=MW.MNT,
                     device="cpu", encoder_path="unfused")
    out = {}
    for kind, batch in batches.items():
        handle = pred.predict_async(batch)
        out[kind] = (handle[0][0].numpy(), pred.complete(handle)[0])
    return out


# ---------------------------------------------------------------------------
# the loss counts (in this process, while the ranks run)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["crop", "box", "audio"])
def test_host_counts_equal_device_counts(kind, tree_file, monkeypatch):
    """loss_counts of two stacked micro-steps, each that of its micro-step
    alone; the first's (which holds the crop, box or audio) against the
    counts the losses compute on the device when the batch carries none:
    the LM targets after the image splice and the shift, the valid mask
    slots."""
    seen = []
    inner = tlosses._mean

    def record(total, count, group, global_count=None):
        seen.append(float(count))
        return inner(total, count, group, global_count)
    monkeypatch.setattr(tlosses, "_mean", record)
    stacked = train_batch(kind, 2, rows=1)
    counts = tanyref.loss_counts(CFG, stacked)
    assert counts.shape == (2, len(tanyref.LOSS_COUNTS))
    assert counts.dtype == np.float32
    for i in range(2):
        np.testing.assert_array_equal(
            tanyref.loss_counts(CFG, {k: v[i] for k, v in stacked.items()}),
            counts[i])
    # the first micro-step holds the reference (stack_microbatches)
    micro = {k: v[0] for k, v in stacked.items()}
    ref = {"crop": "ref_valid", "box": "ref_valid",
           "audio": "audio_valid"}[kind]
    assert micro[ref].any()
    with torch.no_grad():
        tanyref.train_forward(torch.load(tree_file), CFG, micro,
                              encoder_path="unfused")
    # lm_cross_entropy, sigmoid_ce_loss, dice_loss, in that order
    assert seen == [counts[0][0], counts[0][1], counts[0][1]], (seen,
                                                                counts[0])
    assert counts[0][0] > 0 and counts[0][1] > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["text", "crop"])
def test_data_mesh_program_holds_no_collective(runs, single, kind):
    """Each rank's program parts run its half of the batch bucket with no
    collective and no read; their meta rows are the single process's rows
    of that half (ids, [SEG] slots)."""
    want = single[kind][0]
    half = want.shape[0] // 2
    for rank, res in enumerate(runs["ranks"]):
        got = res["serving"][kind]
        assert got["program_calls"] == [], (rank, got["program_calls"])
        assert got["passes"] >= 1
        np.testing.assert_array_equal(
            got["meta"][:, :-1], want[rank * half:(rank + 1) * half, :-1],
            err_msg=f"rank {rank}")


@pytest.mark.parametrize("kind", ["text", "crop"])
def test_data_mesh_dispatch_reads_nothing_and_complete_gathers(runs, kind):
    """predict_async issues no collective and its handle holds the rank's
    rows (half of the batch bucket of 2); complete() gathers them once over
    the host group (every rank)."""
    for rank, res in enumerate(runs["ranks"]):
        got = res["serving"][kind]
        assert got["dispatch_calls"] == [], rank
        assert got["handle_rows"] == (1, 1), rank
        assert got["complete_calls"] == [("all_gather_object", (0, 1))], rank


def test_model_axis_program_holds_collectives(runs):
    """At (1, 2) the same parts all-reduce over "model" (every decoder
    layer): on the CPU through the all-reduce op's plain version, gloo's
    all_reduce; on the card the op's kernel, which the program's graph
    holds (tests/test_torch_model_program.py)."""
    for res in runs["ranks"]:
        calls = res["model_axis"]["text"]["program_calls"]
        assert len(calls) >= 2 * CFG.llama.num_layers, len(calls)
        assert set(calls) == {("all_reduce", (0, 1))}


def test_predict_and_server_on_both_ranks_match_one_process(runs,
                                                            single):
    """predict's ids on both ranks are the whole batch's and equal one
    process's; the leader Server with a follower (2 batches in pinned
    pairs, each gathered) answers each request with one process's ids."""
    for kind in single:
        for rank, res in enumerate(runs["ranks"]):
            np.testing.assert_array_equal(res["serving"][kind]["ids"],
                                          single[kind][1],
                                          err_msg=f"{kind} rank {rank}")
    lead, follow = (r["serving"] for r in runs["ranks"])
    assert lead["served_batches"] == follow["served_batches"] == 2
    want = single["text"][1]
    for i, got in enumerate(lead["served"]):
        assert got["error"] is None, got
        np.testing.assert_array_equal(got["output_ids"], want[i % 2],
                                      err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_train_parts_hold_no_collective_but_the_data_sum(runs):
    """The batch's counts staged over the host group before the program;
    part A silent; between the parts the all-reduces over "data" of the
    fp32 gradient buffer (one bucket at tiny) and of the metrics; part B
    silent; the step moved the count."""
    for rank, res in enumerate(runs["ranks"]):
        prog = res["training"]["program"]
        assert prog["split"], rank
        assert prog["staging"] == [("all_reduce", (0, 1))], rank
        assert prog["part_a"] == [], rank
        assert prog["between"] == [("all_reduce", (0, 1))] * 2, rank
        assert prog["part_b"] == [], rank
        assert prog["count"] == 1 and np.isfinite(prog["metrics"]).all()


def test_split_step_gradients_equal_present_mesh_step(runs):
    """The split step program's gradient (the one its update read) and
    loss terms (the ranks' shares summed) against the eager mesh step as
    it was before the split, on the same global batch and LoRA: every
    gradient leaf bit-equal, the loss terms within SPLIT_LOSS_TOL."""
    for rank, res in enumerate(runs["ranks"]):
        prog = res["training"]["program"]
        m_split, g_split = prog["metrics"], prog["grads"]
        m_present, g_present = res["training"]["present"]
        np.testing.assert_allclose(m_split, m_present, rtol=SPLIT_LOSS_TOL,
                                   err_msg=f"rank {rank}")
        pairs = TW_pairs(g_split, g_present)
        assert len(pairs) == len(tstep.tree_leaves(g_present))
        for path, a, b in pairs:
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} "
                                          f"{path}")
        assert np.abs(g_split[0]["layers"][0]["q"]["a"]).max() > 0


def TW_pairs(got, want, path=""):
    """(path, got leaf, want leaf) of two numpy trees; None skipped."""
    if want is None:
        assert got is None, path
        return []
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [p for k in want for p in TW_pairs(got[k], want[k],
                                                  f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in TW_pairs(g, w, f"{path}/{i}")]
    return [(path, got, want)]


def test_trainer_logs_global_losses_of_single_device(runs, tree_file):
    """Rank 0 alone writes metrics.jsonl, a line a step; step 1's loss
    terms (the ranks' shares summed) within LOSS_TOL of the port's single
    device on the ranks' first batches joined in data-rank order (the
    Trainer's initial weights, LoRA's b at zero: its forward alone; the
    later steps' gradients are held by
    test_split_step_gradients_equal_present_mesh_step)."""
    import json
    ranks = runs["ranks"]
    assert [r["training"]["writer"] for r in ranks] == [True, False]
    with open(runs["tmp"] / "trainer" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in recs for k in tstep.METRICS)
    parts = [r["training"]["trainer_batches"][0] for r in ranks]
    joined = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    with torch.no_grad():
        out = tanyref.train_forward(torch.load(tree_file), CFG, joined,
                                    encoder_path="fused")
    for k in tstep.METRICS:
        np.testing.assert_allclose(recs[0][k], float(getattr(out, k)),
                                   rtol=LOSS_TOL, err_msg=k)
