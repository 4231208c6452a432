"""The port's two other encoder paths against the JAX package, on the CPU:
"unfused_qkv" (the reference's default off its accelerator, window
attention read off the fused QKV by flash_relpos_attention_qkv) and
"fused_block" (a window layer as one fused_window_block).

The JAX side runs each path's switches (config.ENCODER_PATHS), set with
monkeypatch.setenv, its Pallas kernels in interpret mode; the port's
wrappers take their plain versions on CPU tensors (chip_smoke.py holds the
CUDA kernels against the same plain versions on the card).

"unfused_qkv" runs at anyref_tiny(), whose 16 x 16 global layer takes the
QKV-direct kernel (64 <= L < 1024) and whose 4 x 4 windows do not;
"fused_block" at anyref_tiny() with a 512-pixel SAM image and windows of 8,
where the fused gates open (tests/test_torch_fused.py's configuration).

Tolerances: those of tests/test_torch_fused.py, 3e-4 in fp32 and 2e-2 in
bf16; windows compared on their valid rows (pad rows hold path-dependent
values that are never read); token ids equal, masks within 2e-2.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import anyref as janyref
from anyref_tpu.models import sam as jsam
from anyref_tpu.models.sam import image_encoder as jenc
from anyref_tpu.ops import flash as jflash
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import ENCODER_PATHS, check_encoder_path
from anyref_tpu_torch.data.base import SegDataset
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.models import anyref as tanyref
from anyref_tpu_torch.models import clip_vit as tclip
from anyref_tpu_torch.models import sam as tsam
from anyref_tpu_torch.ops import flash as tflash
from anyref_tpu_torch.tokenizer import AnyRefTokenizer, seg_question

TINY = anyref_tiny()
CFG_512 = dataclasses.replace(TINY, sam=dataclasses.replace(
    TINY.sam, image_size=512, window_size=8))
SWITCHES = {
    "unfused_qkv": {"ANYREF_FUSED_WINDOW_BLOCK": "0",
                    "ANYREF_FUSED_GLOBAL_BLOCK": "0",
                    "ANYREF_QKV_WINDOW_KERNEL": "1",
                    "ANYREF_QKV_MHA_KERNEL": "1"},
    "fused_block": {"ANYREF_FUSED_WINDOW_BLOCK": "1",
                    "ANYREF_FUSED_GLOBAL_BLOCK": "1",
                    "ANYREF_FUSED_SPLIT": "0",
                    "ANYREF_QKV_MHA_KERNEL": "1",
                    "ANYREF_QKV_WINDOW_KERNEL": "0"},
}
CONFIGS = {"unfused_qkv": TINY, "fused_block": CFG_512}
DTYPES = {"float32": 3e-4, "bfloat16": 2e-2}
MNT = 6
BUCKET = 257


def _switch(monkeypatch, path):
    for name, value in SWITCHES[path].items():
        monkeypatch.setenv(name, value)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return tparams.from_numpy(np.asarray(a), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _lin(rng, i, o, dtype):
    return {"w": (rng.standard_normal((i, o)) * i ** -0.5).astype(dtype),
            "b": (0.02 * rng.standard_normal(o)).astype(dtype)}


def _ln(rng, d, dtype):
    return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(dtype),
            "bias": (0.05 * rng.standard_normal(d)).astype(dtype)}


# ---------------------------------------------------------------------------
# each new wrapper's plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ws,nh,hd", [(8, 4, 32), (14, 2, 80), (16, 2, 32),
                                      (20, 2, 32)])
def test_relpos_attention_qkv_plain_matches_pallas(ws, nh, hd, dtype):
    """Windows of 8 (L 64, 4 heads of 32) and of 14 with SAM-H's heads of
    80 (L 196), three windows; a 16 x 16 grid (L 256, the most the window
    kernel takes: anyref_tiny's global layer) and a 20 x 20 one (L 400, the
    flash core's side of the split by length)."""
    B, C = 3, nh * hd
    rng = np.random.default_rng(ws)
    dt = jnp.dtype(dtype)
    qkv = (rng.standard_normal((B, ws * ws, 3 * C)) * 0.5).astype(dt)
    rel_h, rel_w = ((0.1 * rng.standard_normal((2 * ws - 1, hd))).astype(dt)
                    for _ in range(2))
    th = jenc._get_rel_pos_table(ws, jnp.asarray(rel_h))
    tw = jenc._get_rel_pos_table(ws, jnp.asarray(rel_w))
    want = jflash.flash_relpos_attention_qkv(jnp.asarray(qkv), th, tw,
                                             (ws, ws), nh, interpret=True)
    n0 = tflash.launch_counts()
    got = tflash.flash_relpos_attention_qkv(_t(qkv), _t(th), _t(tw),
                                            (ws, ws), nh)
    assert tflash.launch_counts() == n0
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, ws * ws, C)
    _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_window_block_plain_matches_pallas(dtype):
    """C 128, 4 heads of 32, MLP 512, windows of 8 on one 20 x 20 grid:
    padded to 24, so the right and bottom windows overhang, and 9 windows,
    an odd count the reference pads to its two-window step."""
    ws, nh, C, H, W = 8, 4, 128, 20, 20
    hd = C // nh
    rng = np.random.default_rng(11)
    dt = jnp.dtype(dtype)
    p = {"norm1": _ln(rng, C, dt), "qkv": _lin(rng, C, 3 * C, dt),
         "proj": _lin(rng, C, C, dt), "norm2": _ln(rng, C, dt),
         "lin1": _lin(rng, C, 4 * C, dt), "lin2": _lin(rng, 4 * C, C, dt),
         "rel_pos_h": (0.1 * rng.standard_normal((2 * ws - 1, hd))).astype(dt),
         "rel_pos_w": (0.1 * rng.standard_normal((2 * ws - 1, hd))).astype(dt)}
    x = (rng.standard_normal((1, H, W, C)) * 0.5).astype(dt)
    xw, pad_hw = jenc._window_partition(jnp.asarray(x), ws)
    xw = xw.reshape(-1, ws * ws, C)
    assert xw.shape[0] == 9
    mask = np.asarray(jenc._window_partition(
        jnp.ones((1, H, W, 1), jnp.float32), ws)[0]).reshape(-1, ws * ws, 1)
    nwc = pad_hw[1] // ws
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = tparams.from_numpy(p, device="cpu")
    tht = jenc._get_rel_pos_table(ws, jp["rel_pos_h"]).reshape(ws * ws, -1)
    twt = jenc._get_rel_pos_table(ws, jp["rel_pos_w"]).reshape(ws * ws, -1)
    want = jflash.fused_window_block(
        xw, jp["norm1"], jp["qkv"], tht, twt, jp["proj"], jp["norm2"],
        jp["lin1"], jp["lin2"], (ws, ws), nh, (H, W), nwc, 1e-6,
        interpret=True)
    got = tflash.fused_window_block(
        _t(xw), tp["norm1"], tp["qkv"], _t(tht), _t(twt), tp["proj"],
        tp["norm2"], tp["lin1"], tp["lin2"], (ws, ws), nh, (H, W), nwc,
        1e-6)
    assert got.dtype == getattr(torch, dtype) and got.shape == xw.shape
    _close(_np(got) * mask, _np(want) * mask, DTYPES[dtype])


def test_new_wrappers_take_plain_only_for_cpu_tensors():
    """On any other device than the CPU the two new SAM wrappers launch
    their kernels or raise."""
    C, meta = 64, torch.device("meta")
    lin = {"w": torch.ones(C, C, device=meta), "b": torch.zeros(C)}
    ln = {"scale": torch.ones(C), "bias": torch.zeros(C)}
    tab = torch.zeros(8, 8, C // 2)
    with pytest.raises(ValueError):
        tflash.flash_relpos_attention_qkv(
            torch.ones(2, 64, 3 * C, device=meta), tab, tab, (8, 8), 2)
    with pytest.raises(ValueError):
        tflash.fused_window_block(torch.ones(4, 64, C, device=meta), ln,
                                  lin, tab, tab, lin, ln, lin, lin, (8, 8),
                                  2, (8, 8), 1, 1e-6)


def test_encoder_paths_are_the_four_configurations():
    assert set(ENCODER_PATHS) == {"fused", "fused_block", "unfused_qkv",
                                  "unfused"}
    for path in ENCODER_PATHS:
        assert check_encoder_path(path) == path
    for bad in ("", "fused_split", "FUSED", "qkv"):
        with pytest.raises(ValueError):
            check_encoder_path(bad)


# ---------------------------------------------------------------------------
# the towers and generate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees():
    """path -> (JAX tree, bridged tree), each made once per module."""
    made = {}

    def get(path):
        if path not in made:
            made[path] = _trees(path)
        return made[path]
    return get


def _trees(path):
    """The JAX init at the path's config with random rel-pos tables, biases
    and LayerNorms in the SAM encoder (the init leaves them zero or one,
    which would hide a misplaced bias), and the same tree bridged."""
    cfg = CONFIGS[path]
    p = janyref.init(jax.random.key(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)

    def perturb(kp, a):
        name = jax.tree_util.keystr(kp)
        if ("rel_pos" in name or name.endswith("['b']")
                or name.endswith("['bias']") or name.endswith("['scale']")):
            return a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a
    enc = jax.tree_util.tree_map_with_path(perturb, p["sam"]["image_encoder"])
    p["sam"] = dict(p["sam"], image_encoder=enc)
    return p, tparams.from_numpy(jax.device_get(p), device="cpu")


@pytest.mark.parametrize("path", list(SWITCHES))
def test_sam_encoder_matches_jax(path, trees, monkeypatch):
    _switch(monkeypatch, path)
    cfg = CONFIGS[path]
    jp, tp = trees(path)
    x = np.random.default_rng(2).standard_normal(
        (2, 3, cfg.sam.image_size, cfg.sam.image_size)).astype(np.float32)
    want = jsam.encode_image(jp["sam"], jnp.asarray(x), cfg.sam)
    got = tsam.encode_image(tp["sam"], torch.from_numpy(x), cfg.sam,
                            encoder_path=path)
    g = cfg.sam.embedding_size
    assert got.shape == (2, cfg.sam.prompt_embed_dim, g, g)
    _close(got, want, DTYPES["float32"])


@pytest.mark.parametrize("cfg_name,path,want", [
    # anyref_tiny: windows of 4 (L 16) split into heads, the 16 x 16 global
    # layer off the fused QKV
    ("tiny", "unfused_qkv", {"flash_relpos_attention": 1,
                             "flash_relpos_attention_qkv": 1}),
    # windows of 8 (L 64) off the fused QKV, the 32 x 32 global layer
    # (L 1024) split into heads
    ("512", "unfused_qkv", {"flash_relpos_attention": 1,
                            "flash_relpos_attention_qkv": 1}),
    ("512", "fused_block", {"fused_window_block": 1, "fused_global_tail": 1}),
    ("512", "fused", {"fused_window_attn": 1, "fused_mlp_stream": 1,
                      "fused_global_tail": 1}),
    ("512", "unfused", {"flash_relpos_attention": 2}),
])
def test_paths_take_their_kernels(cfg_name, path, want, monkeypatch):
    """One encode of each tower calls each SAM wrapper the expected number
    of times on each path, and every other one never; CLIP takes the
    QKV-direct wrapper on every path but "unfused"."""
    names = ("flash_relpos_attention", "flash_relpos_attention_qkv",
             "fused_window_attn", "fused_mlp_stream", "fused_window_block",
             "fused_global_tail", "flash_attention_qkv")
    counts = dict.fromkeys(names, 0)

    def counted(name):
        fn = getattr(tflash, name)

        def wrapper(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapper
    for name in names:
        monkeypatch.setattr(tflash, name, counted(name))
    cfg = TINY if cfg_name == "tiny" else CFG_512
    tp = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                      device="cpu")
    s, c = cfg.sam, cfg.clip
    tsam.encode_image(tp["sam"], torch.zeros(1, 3, s.image_size,
                                             s.image_size), s,
                      encoder_path=path)
    tclip.apply_patch_features(tp["clip"], torch.zeros(1, 3, 224, 224), c,
                               encoder_path=path)
    n_clip = 0 if path == "unfused" else c.num_layers + c.select_layer + 1
    assert counts == dict(dict.fromkeys(names, 0), **want,
                          flash_attention_qkv=n_clip)


@pytest.mark.parametrize("path", list(SWITCHES))
def test_generate_matches_jax(path, trees, monkeypatch):
    """Greedy generate on the path: ids and [SEG] validity equal to the JAX
    ids, masks within 2e-2."""
    _switch(monkeypatch, path)
    cfg = CONFIGS[path]
    jp, tp = trees(path)
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (224, 300, 3), np.uint8),
              rng.integers(0, 256, (280, 224, 3), np.uint8)]
    texts = ("the cat", "the red cat on the red mat near the open door")
    ds = SegDataset(cfg)
    batch = Collator(AnyRefTokenizer(), cfg)(
        [ds.make_sample(im, seg_question(t), None, None)
         for im, t in zip(images, texts)])
    ids = np.zeros((2, BUCKET), np.int32)
    for b in range(2):
        n = int(batch["prompt_lens"][b])
        ids[b, BUCKET - n:] = batch["input_ids"][b, :n]
    inputs = {"input_ids": ids, "clip_images": batch["clip_images"],
              "sam_images": batch["sam_images"]}
    want = jax.jit(functools.partial(janyref.generate, max_new_tokens=MNT),
                   static_argnums=(1,))(
        jp, cfg, {k: jnp.asarray(v) for k, v in inputs.items()})
    got = tanyref.generate(tp, cfg, inputs, max_new_tokens=MNT,
                           device="cpu", encoder_path=path)
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    np.testing.assert_allclose(got.low_res_masks.numpy(),
                               np.asarray(want.low_res_masks),
                               atol=2e-2, rtol=2e-2)
