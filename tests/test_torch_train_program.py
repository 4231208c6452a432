"""The Trainer's step in the form the card captures into one CUDA graph
(anyref_tpu_torch/train/step.py ``step_program``, train/trainer.py): the
prefix that zeroes the carry's sums, one micro-step body picked by the
carry's index, the WHILE predicate ``i < grad_accum`` and the suffix with
the clip and AdamW, at anyref_tiny() on the CPU, where the loop runs on the
host.

No part of it may read the device or upload host data: under
tests/test_torch_graph_program.py's dispatch mode (which refuses every op
whose output a host read decides, and every lift of host data into the
program) the whole step runs on text, crop, box and audio batches at
grad_accum 1 and 2; only the host loop's read of the predicate stands
outside it. Three program steps match three steps of the JAX package's
``jax.jit(make_train_step(...), donate_argnums=(0,))`` from the same
weights and batches, within tests/test_torch_train.py's tolerances:

- loss terms: 1e-3 relative (bf16 decoder activations on both sides);
  the learning rate moves the step-3 loss by 0.6%, so a step that skipped
  or mis-scaled its update would fail;
- Adam's first moments, sums of the gradients: the gradients' 2e-2,
  relative to each leaf's L2 norm (the mask-path leaves follow ReLU gates
  on bf16 [SEG] states, and a gate at its kink moves single elements by
  3% of the leaf's largest: tests/test_torch_train.py, ROADMAP C); second
  moments, sums of their squares: 4e-2;
- the trainables: Adam moves an element by at most about lr a step
  whatever its gradient's size, so each element within 2 lr per moving
  step; each leaf's move (p_3 - p_0) with the norm of the JAX move within
  2e-2, and in direction within 0.25 relative L2 (a gradient near 0 may
  take either sign on the two sides, moving that element lr one way or
  the other: the mask path's text_hidden_fcs measured 0.12). The rate,
  1e-4, keeps the two trajectories within the gradients' agreement: at
  1e-2 the sign-like steps part them, and the third step's mask-path
  gradients differ by up to 11%.

The device-side schedule and bias corrections are held to optax's at the
counts around ``warmup`` and ``total_steps``, and a resumed Trainer's next
step to an uninterrupted run's, bit for bit. Decoder remat keeps no
generator state: its gradients equal those of the checkpoint that saves
it, and of no checkpoint, bit for bit, and a layer draws nothing from any
generator.
"""

import contextlib
import json
import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import optax

from anyref_tpu.config import anyref_tiny as janyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.train import lora as jlora
from anyref_tpu.train import step as jstep
from anyref_tpu_torch import checkpoint as tckpt
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import llama as tllama
from anyref_tpu_torch.ops.mel import audio_to_mel_clips
from anyref_tpu_torch.tokenizer import (AnyRefTokenizer, audio_ref_question,
                                        img_ref_question, seg_answer,
                                        seg_question)
from anyref_tpu_torch.train import lora as tlora
from anyref_tpu_torch.train import step as tstep
from anyref_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.torch_dispatch_modes import NoDeviceReads
from tests.torch_one_thread import one_thread  # noqa: F401

CFG = anyref_tiny()
# the fused configuration of tests/test_torch_train.py
SLICE_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "1", "ANYREF_FUSED_GLOBAL_BLOCK": "1",
             "ANYREF_FUSED_SPLIT": "1", "ANYREF_QKV_MHA_KERNEL": "1",
             "ANYREF_QKV_WINDOW_KERNEL": "0"}
PHRASES = ("a cat", "a dog", "a rat", "a pig", "a hen", "a cow")
LR = 1e-4


@contextlib.contextmanager
def slice_env():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SLICE_ENV.items():
            mp.setenv(name, value)
        yield


@pytest.fixture(autouse=True)
def slice_config():
    with slice_env():
        yield


class NoHostData(NoDeviceReads):
    """NoDeviceReads, and torch.from_numpy refused too (an upload of host
    data that the CPU run alone would not show as a copy)."""

    def __enter__(self):
        self._from_numpy = torch.from_numpy

        def refuse(*args, **kwargs):
            raise AssertionError("torch.from_numpy inside the program")
        torch.from_numpy = refuse
        return super().__enter__()

    def __exit__(self, *exc):
        torch.from_numpy = self._from_numpy
        return super().__exit__(*exc)


def _np(x):
    """A float32 numpy copy (the port's leaves change in place)."""
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().float().cpu().numpy())
    return np.asarray(jnp.asarray(x, jnp.float32))


def _image(rng, i):
    h, w = ((224, 300), (280, 224))[i % 2]
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _mask(h, w, i):
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4:h // 2 + i * 9, w // 5:w // 2 + i * 7] = 1
    return mask[None]


def _samples(kind: str, seed: int, n: int = 2) -> list:
    """Training samples (images whose shortest edge is 224: no PIL resize):
    text rows, or a crop, a box or an audio reference in the first row."""
    rng = np.random.default_rng(seed)
    ds = SegDataset(CFG)
    out = []
    for i in range(n):
        im = _image(rng, i + seed)
        h, w = im.shape[:2]
        text = PHRASES[(seed + i) % len(PHRASES)]
        kw = {}
        q = seg_question(text)
        if i == 0 and kind == "crop":
            kw, q = {"ref_image": SegDataset.ref_crop(
                im, [40, 20, 200, 180])}, img_ref_question()
        elif i == 0 and kind == "box":
            kw, q = {"ref_bbox": np.asarray([30, 20, 200, 180], np.float32)
                     / np.asarray([w, h, w, h], np.float32)}, \
                img_ref_question()
        elif i == 0 and kind == "audio":
            kw, q = {"audio_mels": audio_to_mel_clips(
                np.random.default_rng(seed).standard_normal(16000 * 3)
                .astype(np.float32), device="cpu").numpy()}, \
                audio_ref_question()
        out.append(ds.make_sample(im, q, seg_answer(text), _mask(h, w, i),
                                  file_name=f"{i}.jpg", **kw))
    return out


def _batch(kind: str, accum: int, seed: int = 0, rows: int = 2) -> dict:
    """The Trainer's batch of ``rows`` rows a micro-batch: one collated
    batch, or ``accum`` stacked (stack_microbatches: the reference keys of
    the first micro-batch, zeros in the others)."""
    col = Collator(AnyRefTokenizer(), CFG, train=True, roi=kind == "box")
    micro = [col(_samples(kind if i == 0 else "text", seed + 3 * i, rows))
             for i in range(accum)]
    if accum == 1:
        return tstep.device_batch(micro[0])
    return tstep.stack_microbatches(micro)


@pytest.fixture(scope="module")
def tree():
    return tparams.init(CFG, torch.Generator().manual_seed(0), torch.float32,
                        device="cpu")


def _run_program(program: tstep.StepProgram, check=contextlib.nullcontext):
    """prefix, then the body while the WHILE predicate i < accum holds (the
    predicate read on the host, outside ``check``), then the suffix; each
    part inside ``check()``. Returns (metrics, passes)."""
    with check():
        carry = program.prefix()
    passes = 0
    while int(carry["i"]) < program.accum:
        with check():
            carry = program.body(carry)
        passes += 1
    with check():
        metrics = program.suffix(carry)
    return metrics, passes


# ---------------------------------------------------------------------------
# (a) the program reads nothing from the device and uploads nothing
# ---------------------------------------------------------------------------
def _program_step(tree, kind: str, accum: int, check=NoHostData):
    """One step of the program on a one-row batch of ``kind`` (as tensors,
    the program's static inputs) from the seed-1 state, each part inside
    ``check``: (state, the dense leaves before, metrics, passes)."""
    opt = tstep.make_optimizer(lr=LR, warmup=0, total_steps=10)
    state, frozen = tstep.init_state(torch.Generator().manual_seed(1), tree,
                                     tlora.LoraConfig(), opt)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in _batch(kind, accum, rows=1).items()}
    if kind != "text":
        want = {"crop": "ref_images", "box": "roi_boxes",
                "audio": "audio_mels"}[kind]
        assert want in batch
    before = [t.detach().clone() for t in tstep.tree_leaves(state.dense)]
    program = tstep.step_program(CFG, tlora.LoraConfig(), opt, state, frozen,
                                 batch, remat=True, grad_accum=accum,
                                 encoder_path="fused")
    metrics, passes = _run_program(program, check)
    return state, before, metrics, passes


@pytest.fixture(scope="module")
def text_step(tree):
    """_program_step on text at grad_accum 2, shared by the no-read case
    of that key and test_host_step_is_the_program."""
    return _program_step(tree, "text", 2)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("kind", ["text", "crop", "box", "audio"])
def test_step_program_reads_nothing_from_the_device(kind, accum, tree,
                                                    request):
    """Prefix, body and suffix under NoHostData, on the batch as tensors
    (the program's static inputs); the body runs ``accum`` times, the step
    moves the trainables and the count, and its metrics are finite."""
    if (kind, accum) == ("text", 2):
        state, before, metrics, passes = request.getfixturevalue(
            "text_step")
    else:
        state, before, metrics, passes = _program_step(tree, kind, accum)
    assert passes == accum
    assert metrics.shape == (len(tstep.METRICS),)
    assert bool(torch.isfinite(metrics).all())
    assert int(state.opt_state.count) == 1
    assert state.opt_state.count.dtype == torch.int32
    assert any(not torch.equal(a.detach(), b) for a, b in
               zip(tstep.tree_leaves(state.dense), before))


def test_host_step_is_the_program(tree, text_step):
    """make_train_step's step (the host's, the Trainer's on the CPU) runs
    the program: the same metrics and trainables as the parts run by hand
    (the text step of the no-read case, whose mode passes every op
    through), bit for bit, and the state's tensors updated in place."""
    opt = tstep.make_optimizer(lr=LR, warmup=0, total_steps=10)
    state, frozen = tstep.init_state(torch.Generator().manual_seed(1), tree,
                                     tlora.LoraConfig(), opt)
    leaves = tstep.tree_leaves((state.lora, state.dense, state.opt_state))
    new, ma = tstep.make_train_step(CFG, tlora.LoraConfig(), opt,
                                    grad_accum=2)(state, frozen,
                                                  _batch("text", 2, rows=1))
    assert new.step == 1
    assert all(a is b for a, b in zip(
        leaves, tstep.tree_leaves((new.lora, new.dense, new.opt_state))))
    by_hand, _, mb, _ = text_step
    mb = dict(zip(tstep.METRICS, mb))
    for k in tstep.METRICS:
        assert torch.equal(ma[k], mb[k]), k
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(
        leaves, tstep.tree_leaves((by_hand.lora, by_hand.dense,
                                   by_hand.opt_state))))


# ---------------------------------------------------------------------------
# (b) three program steps against the jitted JAX step
# ---------------------------------------------------------------------------
def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_three_steps_match_jitted_jax_step():
    """Warmup 1 (step 1 at lr(0) = 0, steps 2 and 3 move), 2 micro-steps a
    step, remat, the JAX init bridged by params.from_numpy and LoRA's b set
    to small random values (b = 0 would hide A's gradient)."""
    accum, warmup, total = 2, 1, 4
    jp = janyref.init(jax.random.key(0), janyref_tiny(), dtype=jnp.float32)
    jopt = jstep.make_optimizer(lr=LR, warmup=warmup, total_steps=total)
    jstate, jfrozen = jstep.init_state(jax.random.key(1), jp,
                                       jlora.LoraConfig(), jopt)
    rng = np.random.default_rng(11)
    for layer in jstate.lora["layers"]:
        for t in layer.values():
            t["b"] = jnp.asarray(0.02 * rng.standard_normal(t["b"].shape),
                                 jnp.float32)
    host = jax.device_get((jstate.lora, jstate.dense))
    tp = tparams.from_numpy(jax.device_get(jp), device="cpu")
    lora_p = tparams.from_numpy(host[0], device="cpu")
    dense, frozen = tlora.split_trainable(tp)
    dense = tstep.tree_map(lambda t: t.detach().clone(), dense)
    for t in tstep.tree_leaves((lora_p, dense)):
        t.requires_grad_(True)
    topt = tstep.make_optimizer(lr=LR, warmup=warmup, total_steps=total)
    state = tstep.TrainState(0, lora_p, dense, topt.init((lora_p, dense)))
    start = [_np(t) for t in tstep.tree_leaves((lora_p, dense))]

    jfn = jax.jit(jstep.make_train_step(janyref_tiny(), jlora.LoraConfig(),
                                        jopt, remat=True, grad_accum=accum),
                  donate_argnums=(0,))
    for s in range(3):
        batch = _batch("text", accum, seed=10 * s)
        jstate, jm = jfn(jstate, jfrozen,
                         {k: jnp.asarray(v) for k, v in batch.items()})
        program = tstep.step_program(CFG, tlora.LoraConfig(), topt, state,
                                     frozen, batch, remat=True,
                                     grad_accum=accum, encoder_path="fused")
        metrics, _ = _run_program(program)
        for k, got in zip(tstep.METRICS, metrics.tolist()):
            np.testing.assert_allclose(got, float(jm[k]), rtol=1e-3,
                                       err_msg=f"step {s + 1} {k}")
    adam = _adam_state(jstate.opt_state)
    assert int(adam.count) == int(state.opt_state.count) == 3
    jleaves = jax.tree_util.tree_leaves((jstate.lora, jstate.dense))
    tleaves = tstep.tree_leaves((state.lora, state.dense))
    assert len(jleaves) == len(tleaves) == len(start)
    moving = 2
    moved = 0
    for i, (p0, got, want) in enumerate(zip(start, tleaves, jleaves)):
        got, want = _np(got), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * moving,
                                   err_msg=f"leaf {i}")
        d_got, d_want = got - p0, want - p0
        scale = np.linalg.norm(d_want)
        if scale == 0:   # no gradient reaches it (a leaf the batch skips)
            assert not d_got.any(), i
            continue
        moved += 1
        assert abs(np.linalg.norm(d_got) - scale) <= 2e-2 * scale, i
        assert np.linalg.norm(d_got - d_want) <= 0.25 * scale, i
    assert moved >= len(start) - 3
    for name, tol in (("mu", 2e-2), ("nu", 4e-2)):
        jm_leaves = jax.tree_util.tree_leaves(getattr(adam, name))
        tm_leaves = tstep.tree_leaves(getattr(state.opt_state, name))
        assert len(jm_leaves) == len(tm_leaves)
        for i, (got, want) in enumerate(zip(tm_leaves, jm_leaves)):
            want = np.asarray(want, np.float32)
            assert np.linalg.norm(_np(got) - want) <= tol * np.linalg.norm(
                want), f"{name} leaf {i}"


# ---------------------------------------------------------------------------
# (c) the schedule and the bias corrections on the device against optax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(200, 10_000), (1, 3), (0, 5)])
def test_device_schedule_and_bias_corrections_match_optax(warmup, total):
    """At the counts around ``warmup`` and ``total_steps`` (and 0, 1), both
    fp32 0-d tensors computed from an int32 count tensor: the learning rate
    within one fp32 ulp of the peak rate from optax's (XLA multiplies by
    the reciprocal where optax divides, and fuses the multiply-add: near
    the ends of a ramp, where the sum cancels, the two differ in the last
    bits of the peak's precision), and 1 - b ** count within one fp32 ulp
    of optax's (XLA's power is not correctly rounded)."""
    counts = sorted({c for c in (0, 1, warmup - 2, warmup - 1, warmup,
                                 warmup + 1, warmup + 2, total - 2,
                                 total - 1, total, total + 1, total + 2)
                     if c >= 0})
    want_lr = optax.join_schedules([
        optax.linear_schedule(0.0, 5e-5, warmup),
        optax.linear_schedule(5e-5, 0.0, total - warmup)], [warmup])
    got_lr = tstep.warmup_decay_schedule(5e-5, warmup, total)
    for c in counts:
        count = torch.tensor(c, dtype=torch.int32)
        got = got_lr(count)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.float32(jax.jit(want_lr)(jnp.int32(c)))
        assert abs(float(got) - float(want)) <= 2.0 ** -23 * 5e-5, (
            c, float(got), float(want))
        for decay in (tstep.B1, tstep.B2):
            got = (1 - tstep._decay_power(decay, count + 1)).numpy()
            want = np.asarray(jax.jit(lambda n: 1 - decay ** n)(
                jnp.int32(c + 1)))
            assert got.dtype == np.float32
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


# ---------------------------------------------------------------------------
# (d) a resumed Trainer's next step equals an uninterrupted run's
# ---------------------------------------------------------------------------
class _Same:
    """``n`` copies of one sample: every shuffle gives the same batches, so
    a resumed run meets the batch the uninterrupted run met."""

    def __init__(self, n=2):
        self.item = _samples("text", 5, 1)[0]
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.item


def test_resumed_trainer_matches_uninterrupted(tmp_path, tree):
    """Three steps in one run that saves after its second, against that
    checkpoint and a third step in a resumed Trainer: the trainables, the
    moments, the count and the third step's losses equal bit for bit. The
    resumed Trainer keeps its own tensors (the restored leaves are copied
    into them)."""
    def config(out, steps, save):
        return TrainConfig(output_dir=str(out), per_device_batch_size=1,
                           grad_accum_steps=2, max_steps=steps,
                           warmup_steps=1, save_steps=save, log_steps=1,
                           learning_rate=LR, resume=True, remat=True)

    whole = Trainer(CFG, config(tmp_path / "a", 3, 2), tree,
                    dataset=_Same(), device="cpu")
    assert whole.step_fn == whole._host_step and whole.programs == {}
    end = whole.train()
    # the checkpoint keeps its format: the count saved as an int
    saved = tckpt.restore_train_state(str(tmp_path / "a" / "checkpoint-2"))
    assert type(saved["opt_state"]["count"]) is int
    assert saved["opt_state"]["count"] == 2
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "checkpoint-2",
                    tmp_path / "b" / "checkpoint-2")
    resumed = Trainer(CFG, config(tmp_path / "b", 3, 100), tree,
                      dataset=_Same(), device="cpu")
    assert resumed.state.step == 2
    held = tstep.tree_leaves((resumed.state.lora, resumed.state.dense,
                              resumed.state.opt_state))
    got = resumed.train()
    assert all(a is b for a, b in zip(held, tstep.tree_leaves(
        (got.lora, got.dense, got.opt_state))))
    assert got.step == end.step == 3
    assert int(got.opt_state.count) == 3
    for a, b in zip(tstep.tree_leaves((got.lora, got.dense, got.opt_state)),
                    tstep.tree_leaves((end.lora, end.dense, end.opt_state))):
        assert torch.equal(a.detach(), b.detach())

    def last(path):
        with open(path / "metrics.jsonl") as f:
            rec = [json.loads(line) for line in f][-1]
        return {k: rec[k] for k in tstep.METRICS} | {"step": rec["step"]}
    assert last(tmp_path / "a") == last(tmp_path / "b")


# ---------------------------------------------------------------------------
# (e) decoder remat keeps no generator state
# ---------------------------------------------------------------------------
class NoDraws(TorchDispatchMode):
    """Raises on any op that draws from a random generator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise AssertionError(f"{func} draws from a generator")
        return func(*args, **(kwargs or {}))


def test_decoder_remat_keeps_no_rng_state(tree, monkeypatch):
    """llama.forward's layer gradients (every decoder weight and the input
    embeddings) with the remat of the port (preserve_rng_state=False),
    with a checkpoint that saves and restores the generators' state, and
    without checkpointing: equal bit for bit. No op of the forward or the
    backward draws from a generator, and the CPU generator's state is
    unchanged."""
    lcfg = CFG.llama
    g = torch.Generator().manual_seed(3)
    embeds = torch.randn(2, 24, lcfg.hidden_size, generator=g).to(
        torch.bfloat16)
    params = tstep.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                            tree["llama"])
    weights = tstep.tree_leaves(params["layers"])
    cot = torch.randn(2, 24, lcfg.hidden_size, generator=g)
    real = torch.utils.checkpoint.checkpoint

    def run(remat: bool):
        x = embeds.clone().requires_grad_(True)
        out = tllama.forward(params, lcfg, x, remat=remat)
        grads = torch.autograd.grad((out.float() * cot).sum(),
                                    [x, *weights], allow_unused=True)
        return [gr for gr in grads if gr is not None]

    rng = torch.get_rng_state()
    with NoDraws():
        port = run(True)
    assert torch.equal(torch.get_rng_state(), rng)
    plain = run(False)
    monkeypatch.setattr(tllama, "checkpoint", lambda *a, **kw: real(
        *a, **{**kw, "preserve_rng_state": True}))
    saving = run(True)
    assert len(port) == len(plain) == len(saving) == len(weights) + 1
    for a, b, c in zip(port, plain, saving):
        assert torch.equal(a, b) and torch.equal(a, c)
