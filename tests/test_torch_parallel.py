"""Multi-device serving in the port (anyref_tpu_torch/parallel, generate,
Predictor and Server across ranks) against the JAX package's mesh on the
conftest's virtual CPU devices.

The spec trees equal the JAX package's; each rank's blocks from
shard_params / shard_batch are bit-equal to the shards of the JAX
NamedSharding on the device at that mesh position. Generate runs in spawned
CPU ranks over gloo (tests/torch_parallel_worker.py: a FileStore a run, a
60 s collective timeout, a time limit on the whole run): at (1, 2), (2, 1)
and (2, 2) its ids equal the JAX single-device generate and its low-res
mask logits agree within the JAX package's own TP test tolerance, 4e-3
(tests/test_multichip.py). The row-parallel products sum fp32 partials and
round once; the reference's compiled program sums in f32 as well. The
multi-rank Server (rank 0) and its follower match a single-rank
Server on the same requests in pinned pairs, the sharded tree keeps its
plain layout, an idle Server keeps its follower past the collective
timeout, and a follower's failure stops the Server at once."""

import functools
import multiprocessing as mp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import llama as jllama
from anyref_tpu.ops import quant as jquant
from anyref_tpu.parallel import mesh as jmesh
from anyref_tpu.parallel import partition as jpart
from anyref_tpu.train import lora as jlora
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.ops import quant as tquant
from anyref_tpu_torch.parallel import mesh as tmesh
from anyref_tpu_torch.parallel import partition as tpart
from anyref_tpu_torch.serve import Server
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question
from anyref_tpu_torch.train import lora as tlora
from tests import torch_parallel_worker as W
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = anyref_tiny()
MNT = 6
BUCKET = 257
MASK_TOL = 4e-3
# the [SEG] embeddings project bf16 states, some of whose roundings the
# row-parallel sums' order moves by an ulp (2^-8 relative): the bf16
# tolerance of tests/test_torch_rephrase.py
STATE_TOL = 2e-2
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")
TEXTS = ("the cat", "the red cat on the red mat near the open door")
MESHES = ((1, 2), (2, 1), (2, 2))
# the collective timeout of the idle-Server test, which sleeps past it
IDLE_TIMEOUT_S = 10.0
# with the JAX init of key 0, prompt 0 answers two tokens, then [SEG]
# (tests/test_torch_rephrase.py)
SEG_SCALE = 3.0


@pytest.fixture(scope="module")
def jp():
    return janyref.init(jax.random.key(0), CFG, dtype=jnp.float32)


def _port_tree(jtree):
    return tparams.from_numpy(jax.device_get(jtree), device="cpu")


@pytest.fixture(scope="module")
def tree_file(jp, tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "tree.pt"
    torch.save(_port_tree(jp), path)
    return path


@pytest.fixture(scope="module")
def batch():
    """Two left-padded prompts of different lengths in BUCKET."""
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    ds = SegDataset(CFG)
    b = Collator(AnyRefTokenizer(), CFG)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, TEXTS)])
    ids = np.zeros((2, BUCKET), np.int32)
    for r in range(2):
        n = int(b["prompt_lens"][r])
        ids[r, BUCKET - n:] = b["input_ids"][r, :n]
    return {"input_ids": ids, "clip_images": b["clip_images"],
            "sam_images": b["sam_images"]}


@pytest.fixture(scope="module")
def jax_single(jp, batch):
    """The JAX single-device greedy generate (unfused configuration)."""
    with pytest.MonkeyPatch.context() as mpatch:
        for name in SLICE_SWITCHES:
            mpatch.setenv(name, "0")
        out = jax.jit(functools.partial(janyref.generate,
                                        max_new_tokens=MNT),
                      static_argnums=(1,))(
            jp, CFG, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"ids": np.asarray(out.output_ids),
            "low_res": np.asarray(out.low_res_masks)}


@pytest.fixture(scope="module")
def ranks(tree_file, batch):
    """{(data, model): every rank's result of generate_task}."""
    out = {}
    for data, model in MESHES:
        out[(data, model)] = W.run_ranks(
            "generate", data * model, tree_file.parent, data=data,
            model=model, tree=str(tree_file), batch=batch, mnt=MNT,
            int8=(data, model) == (1, 2), meter=(data, model) == (1, 2),
            seg_scale=SEG_SCALE if model > 1 else None,
            staged=(data, model) == (2, 1))
    return out


def _spec_tuples(jspec):
    """A JAX spec tree with PartitionSpec leaves as tuples, lists kept."""
    if isinstance(jspec, P):
        return tuple(jspec)
    if isinstance(jspec, dict):
        return {k: _spec_tuples(v) for k, v in jspec.items()}
    if isinstance(jspec, (list, tuple)):
        return [_spec_tuples(v) for v in jspec]
    return jspec


def _layouts(jp):
    """{layout: (JAX tree, port tree)}: [in, out], transposed, fused and
    int8 decoders (each conversion in place on new containers of the same
    leaves)."""
    def copy_llama(tree):
        return jax.tree.map(lambda x: x, tree)

    out = {"plain": copy_llama(jp)}
    t = copy_llama(jp)
    t["llama"] = jllama.transpose_for_serving(t["llama"])
    out["transposed"] = t
    f = copy_llama(jp)
    f["llama"] = jllama.fuse_for_serving(jllama.transpose_for_serving(
        f["llama"]))
    out["fused"] = f
    q = copy_llama(jp)
    q["llama"] = jquant.quantize_llama(q["llama"])
    out["int8"] = q
    return {k: (v, _port_tree(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def layouts(jp):
    return _layouts(jp)


@pytest.mark.parametrize("layout", ["plain", "transposed", "fused", "int8"])
def test_spec_trees_match_jax(layouts, layout):
    jtree, ttree = layouts[layout]
    assert tpart.anyref_spec(ttree, CFG) == _spec_tuples(
        jpart.anyref_spec(jtree, CFG))
    assert tpart.llama_spec(ttree["llama"]) == _spec_tuples(
        jpart.llama_spec(jtree["llama"]))
    batch = {"input_ids": None, "clip_images": None}
    assert tpart.batch_spec(batch) == _spec_tuples(jpart.batch_spec(batch))


def test_lora_spec_matches_jax(jp):
    cfg = jlora.LoraConfig()
    jt = jlora.init(jax.random.key(1), jp["llama"], cfg)
    tt = tlora.init(torch.Generator().manual_seed(1),
                    _port_tree(jp["llama"]), tlora.LoraConfig())
    assert tpart.lora_spec(tt) == _spec_tuples(jpart.lora_spec(jt))


def _bits(x) -> np.ndarray:
    """A leaf's bits as numpy (bf16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _shard_at(arr, device) -> np.ndarray:
    return next(_bits(s.data) for s in arr.addressable_shards
                if s.device == device)


@pytest.mark.parametrize("layout", ["plain", "transposed", "int8"])
@pytest.mark.parametrize("data,model", MESHES)
def test_local_shards_match_named_sharding(jp, layouts, batch, layout, data,
                                           model):
    """Each rank's blocks equal the shard of the JAX NamedSharding on the
    device at its mesh position, bit for bit, for the params and a batch."""
    jtree = layouts[layout][0]
    mesh = jmesh.make_mesh(data, model, devices=jax.devices()[:data * model])
    jsharded = dict(_leaves(jpart.shard_params(jtree, mesh, CFG)))
    jbatch = jpart.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                               mesh)
    for d in range(data):
        for m in range(model):
            tm = tmesh.Mesh({"data": data, "model": model},
                            {"data": d, "model": m}, torch.device("cpu"))
            local = tpart.shard_params(_port_tree(jtree), tm, CFG)
            assert local.mesh is tm
            device = mesh.devices[d, m]
            n = 0
            for path, leaf in _leaves(local):
                want = _shard_at(jsharded[path], device)
                got = _bits(leaf)
                assert got.shape == want.shape, path
                np.testing.assert_array_equal(got, want, err_msg=path)
                n += 1
            assert n == len(jsharded)
            for k, v in tpart.shard_batch(batch, tm).items():
                np.testing.assert_array_equal(_bits(v),
                                              _shard_at(jbatch[k], device))


def test_shard_refuses_what_jax_cannot_place_evenly(jp, layouts, batch):
    tm = tmesh.Mesh({"data": 2, "model": 1}, {"data": 0, "model": 0},
                    torch.device("cpu"))
    odd = {k: v[:1].repeat(3, 0) for k, v in batch.items()}
    with pytest.raises(ValueError, match="does not divide"):
        tpart.shard_batch(odd, tm)
    tm2 = tmesh.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1},
                     torch.device("cpu"))
    with pytest.raises(ValueError, match="fused serving layout"):
        tpart.shard_params(layouts["fused"][1], tm2, CFG)


def test_make_mesh_without_process_group():
    """No process group: the 1 x 1 grid, as JAX on one device; a grid
    that does not cover the ranks raises."""
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.rank == 0 and m.group("model") is None
    assert m.host_group is None
    with pytest.raises(ValueError, match="mesh 1x2 != 1 devices"):
        tmesh.make_mesh(data=1, model=2, device="cpu")


def _assert_matches_jax(results, jax_single, data, what):
    """Rows gathered from the ranks in data order (the model ranks of a
    data rank must agree bit for bit) against the JAX single device."""
    model = len(results) // data
    rows = []
    for d in range(data):
        group = results[d * model:(d + 1) * model]
        for r in group[1:]:
            np.testing.assert_array_equal(r[what]["ids"], group[0][what]["ids"])
            np.testing.assert_array_equal(r[what]["low_res"],
                                          group[0][what]["low_res"])
        rows.append(group[0][what])
    ids = np.concatenate([r["ids"] for r in rows])
    low = np.concatenate([r["low_res"] for r in rows])
    np.testing.assert_array_equal(ids, jax_single["ids"])
    np.testing.assert_allclose(low, jax_single["low_res"], rtol=MASK_TOL,
                               atol=MASK_TOL)


@pytest.mark.parametrize("what", ["greedy", "speculative"])
@pytest.mark.parametrize("data,model", MESHES)
def test_parallel_generate_matches_jax_single_device(ranks, jax_single,
                                                     data, model, what):
    res = ranks[(data, model)]
    assert [r["coords"] for r in res] == [
        {"data": d, "model": m} for d in range(data) for m in range(model)]
    heads = CFG.llama.num_heads * CFG.llama.head_dim // model
    assert all(tuple(r["local_heads"]) == (CFG.llama.hidden_size, heads)
               for r in res)
    _assert_matches_jax(res, jax_single, data, what)


def test_mesh_predictor_counts_each_ranks_staged_bytes(ranks, batch):
    """At (2, 1) each rank uploads its own row of the batch of two, and
    its Predictor's h2d_bytes_total counts those bytes, half the batch's."""
    whole = sum(np.asarray(v).nbytes for v in batch.values())
    assert [r["h2d_bytes"] for r in ranks[(2, 1)]] == [whole // 2] * 2


def test_jax_reference_reduces_row_parallel_in_f32(jp):
    """The port sums the row-parallel partials in fp32 (models/llama.py
    ``_row_parallel``): the reference's compiled prefill on these CPU
    devices, bf16 activations and all, all-reduces in f32 too (its compiler
    widens the bf16 products before the sum). A bf16 sum moved the masks
    further from the JAX single-device generate than MASK_TOL (ROADMAP
    C32)."""
    import re
    from anyref_tpu.ops import flash as jflash
    jm = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    try:
        lp = jpart.shard_params(jp, jm, CFG)["llama"]
        embeds = jnp.zeros((2, 16, CFG.llama.hidden_size), jnp.bfloat16)
        cache = jllama.init_cache(CFG.llama, 2, 16)
        hlo = jax.jit(jllama.prefill, static_argnums=(1,)).lower(
            lp, CFG.llama, embeds, cache).compile().as_text()
    finally:
        jflash.set_kernel_mesh(None)
    types = re.findall(r"= (\w+)\[[^\]]*\][^=]*? all-reduce(?:-start)?\(",
                       hlo)
    # o and down in each layer
    assert len(types) >= 2 * CFG.llama.num_layers, types
    assert set(types) == {"f32"}, types


def test_sharded_int8_matches_single_rank(ranks, tree_file, batch):
    """Greedy and speculative generate on the sharded (replicated) int8
    tree give the single-rank int8 greedy ids."""
    params = torch.load(tree_file)
    params["llama"] = tquant.quantize_llama(params["llama"])
    want = tanyref.generate(params, CFG, batch, max_new_tokens=MNT,
                            device="cpu", encoder_path="unfused")
    for r in ranks[(1, 2)]:
        for what in ("int8", "int8_speculative"):
            np.testing.assert_array_equal(r[what]["ids"],
                                          want.output_ids.numpy())
            np.testing.assert_allclose(r[what]["low_res"],
                                       want.low_res_masks.numpy(),
                                       rtol=MASK_TOL, atol=MASK_TOL)


@pytest.mark.parametrize("what", ["greedy", "speculative"])
@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_parallel_rephrase_matches_single_rank(ranks, tree_file, batch, data,
                                               model, what):
    """Rephrase pooling on a mesh with a "model" axis (the last layer's
    head mean summed over the rank's heads): ids equal the single-rank
    port's (which tests/test_torch_rephrase.py holds against the JAX
    package), the masks within MASK_TOL, the [SEG] embeddings within
    STATE_TOL, and row 0's first [SEG] comes after a pooled span."""
    params = torch.load(tree_file)
    params["llama"]["lm_head"][:, CFG.tokens.seg] *= SEG_SCALE
    cfg = CFG.scaled(rephrase_weight=0.1)
    kw = {"speculative": True, "draft_len": 3} if what == "speculative" \
        else {}
    want = tanyref.generate(params, cfg, batch, max_new_tokens=MNT,
                            device="cpu", encoder_path="unfused", **kw)
    res = ranks[(data, model)]
    for d in range(data):
        for r in res[d * model:(d + 1) * model]:
            got = r[f"rephrase_{what}"]
            rows = slice(d * (2 // data), (d + 1) * (2 // data))
            np.testing.assert_array_equal(got["ids"],
                                          want.output_ids.numpy()[rows])
            for key, w, tol in (
                    ("seg_emb", want.seg_embeddings, STATE_TOL),
                    ("low_res", want.low_res_masks, MASK_TOL)):
                w = w.numpy()[rows]
                np.testing.assert_allclose(got[key], w, rtol=tol,
                                           atol=tol * np.abs(w).max())
    first = [list(row).index(CFG.tokens.seg)
             for row in want.output_ids.numpy()]
    assert first[0] >= 1, first


def test_average_meter_all_reduce_sums_ranks(ranks):
    for r in ranks[(1, 2)]:
        vec_sum, vec_count, s_sum, s_count = r["meter"]
        # rank r adds [1 + r, 2r] x (r + 1) and 0.5 (r + 1) x 1
        np.testing.assert_array_equal(vec_sum, [1.0 + 4.0, 0.0 + 4.0])
        assert vec_count == 3
        assert s_sum == 1.5 and isinstance(s_sum, float) and s_count == 2


def _serve_inputs():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (60, 80, 3), np.uint8) for _ in range(4)]
    texts = ["the cat", "a very long referring expression about a red dog",
             "bird", "the left person"]
    return images, texts


def test_server_across_ranks_matches_single_rank(tree_file):
    """The counterpart of tests/test_serve_tp.py: a leader Server and a
    follower at (1, 2), speculative by default, 4 requests in pinned
    pairs; texts and masks equal a single-rank Server's, and the sharded
    tree keeps the plain layout (no serving-layout conversion)."""
    images, texts = _serve_inputs()
    solo = Server(torch.load(tree_file), CFG, max_batch=2, device="cpu",
                  **W.PIN_PAIRS)
    try:
        want = W.serve_pairs(solo, images, texts)
    finally:
        solo.shutdown()
    leader, follower = W.run_ranks("serve", 2, tree_file.parent,
                                   tree=str(tree_file), images=images,
                                   texts=texts)
    assert leader["layout"] == ["k", "o", "q", "v"]
    assert leader["batches"] == follower["batches"] == 2
    for i, (w, g) in enumerate(zip(want, leader["results"])):
        assert "error" not in w and g["error"] is None, (i, w, g)
        assert g["text"] == w["text"], i
        np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=str(i))


def test_server_outlives_idle_past_collective_timeout(tree_file):
    """A Server idle for longer than the ranks' collective timeout keeps
    its follower: the follower waits for work on the serve group, whose
    timeout is not the collectives'; the second pair is answered."""
    images, texts = _serve_inputs()
    leader, follower = W.run_ranks(
        "serve", 2, tree_file.parent, collective_s=IDLE_TIMEOUT_S,
        tree=str(tree_file), images=images, texts=texts,
        idle_s=IDLE_TIMEOUT_S + 4.0)
    assert leader["batches"] == follower["batches"] == 2
    for i, g in enumerate(leader["results"]):
        assert g["error"] is None and g["text"] is not None, (i, g)


def test_follower_failure_stops_server_at_once(tree_file):
    """A follower whose step fails leaves the ranks' collectives out of
    step: its exception ends follow, and the leader answers that batch
    with an error well inside the collective timeout (the follower's exit
    breaks the leader's pending collective) and then refuses requests."""
    images, texts = _serve_inputs()
    leader, follower = W.run_ranks("serve", 2, tree_file.parent,
                                   tree=str(tree_file), images=images,
                                   texts=texts, fail_at=1)
    assert "injected failure" in follower["error"]
    first, second = leader["results"][:2], leader["results"][2:]
    assert all(g["error"] is None for g in first), first
    assert all(g["error"] is not None for g in second), second
    assert leader["seconds"][1] < W.COLLECTIVE_TIMEOUT_S / 2, leader
    assert leader["late"] == {"error": "server shut down"}
    assert leader["batches"] == 2


def test_predictor_refuses_int8_speculative_only_unsharded(jp, tree_file):
    """The int8 + speculative refusal holds for an unsharded tree; on a
    mesh of several ranks the tree is never converted, so it serves (the
    ranks' speculative int8 generate: test_sharded_int8_matches_single_rank).
    The JAX Predictor: the unsharded int8 tree fails in its conversion, the
    sharded one reaches none."""
    from anyref_tpu.eval.runner import Predictor as JPredictor
    from anyref_tpu.ops import flash as jflash
    from anyref_tpu_torch.eval.runner import Predictor
    jq = dict(jp)
    jq["llama"] = jquant.quantize_llama(jp["llama"])
    with pytest.raises(KeyError, match="w"):
        JPredictor(jax.tree.map(lambda x: x, jq), CFG, speculative=True)
    jm = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    try:
        sharded = jpart.shard_params(jq, jm, CFG)
        JPredictor(sharded, CFG, speculative=True)
        assert "q" in sharded["llama"]["layers"][0]["attn"]
    finally:
        jflash.set_kernel_mesh(None)
    params = torch.load(tree_file)
    params["llama"] = tquant.quantize_llama(params["llama"])
    with pytest.raises(ValueError, match="speculative=False"):
        Predictor(params, CFG, speculative=True, device="cpu")
    two = tmesh.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0},
                     torch.device("cpu"))
    sp = tpart.shard_params(params, two, CFG)
    pred = Predictor(sp, CFG, speculative=True)
    assert pred.mesh is two and pred.device == torch.device("cpu")
    assert "q" in sp["llama"]["layers"][0]["attn"]


def test_racing_builds_compile_once(tmp_path):
    """Two processes that start the g++ RLE build together: one compiles,
    the other waits on the lock and loads the finished library."""
    ctx = mp.get_context("spawn")
    start, out = ctx.Event(), ctx.Queue()
    so = str(tmp_path / "librle.so")
    procs = [ctx.Process(target=W.race_build, args=(so, start, out),
                         daemon=True) for _ in range(2)]
    for p in procs:
        p.start()
    start.set()
    try:
        got = sorted(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert got == [False, True]
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)
