"""SAM's own prompts in the port against the JAX package, on the CPU:
sam_normalize_pad / preprocess, the point, box and mask prompts of the
prompt encoder, SamPredictor and the automatic mask generator.

The same weights (the JAX init, bridged by params.from_numpy) and numpy
inputs from a seed run through both packages in fp32. The JAX side runs
the configuration of the port's encoder path: "unfused" (its four
switches at 0) at anyref_tiny's SAM, and "fused" (tests/test_torch_fused.py's
switches and its 512-pixel SAM with windows of 8, where both fused gates
open; the Pallas kernels in interpret mode).

Tolerances, each with its reason:
- preprocess and the prompt embeddings: 1e-5 (the same fp32 ops; the
  Fourier encoding's sin / cos of arguments up to ~2 pi x 3 agree to a few
  fp32 ulps);
- the predictor's iou and low-res logits: 1e-4 on "unfused" (two encoder
  layers and the two-way transformer summed in other orders, as
  tests/test_torch_modules.py), 3e-4 on "fused" (test_torch_fused.py's);
- a mask bit may differ only where the JAX logit at that pixel lies within
  MASK_NEAR_ZERO of 0 (the logits agree within the limits above);
- the generator's scores within SCORE_TOL = 1e-4. Its records are compared
  in order: under the seed and thresholds below no two kept scores lie
  within MARGIN = 2 x SCORE_TOL of each other, and no score, stability
  score or box IoU within MARGIN of its threshold (the test asserts that
  margin), so the order, the filters and NMS cannot flip on a rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny
from anyref_tpu.models import sam as jsam
from anyref_tpu.models.sam import amg as jamg
from anyref_tpu.models.sam import predictor as jpredictor
from anyref_tpu.models.sam import prompt_encoder as jpe
from anyref_tpu.ops import resize as jresize
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.data import rle as trle
from anyref_tpu_torch.models import sam as tsam
from anyref_tpu_torch.models.sam import amg as tamg
from anyref_tpu_torch.models.sam import predictor as tpredictor
from anyref_tpu_torch.models.sam import prompt_encoder as tpe
from anyref_tpu_torch.ops import resize as tresize

SAM = anyref_tiny().sam
SAM512 = dataclasses.replace(SAM, image_size=512, window_size=8)
EMB_TOL = 1e-5
PATH_TOL = {"unfused": 1e-4, "fused": 3e-4}
MASK_NEAR_ZERO = 1e-3
UNFUSED_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "0",
               "ANYREF_FUSED_GLOBAL_BLOCK": "0",
               "ANYREF_QKV_WINDOW_KERNEL": "0", "ANYREF_QKV_MHA_KERNEL": "0"}
FUSED_ENV = {"ANYREF_FUSED_WINDOW_BLOCK": "1",
             "ANYREF_FUSED_GLOBAL_BLOCK": "1", "ANYREF_FUSED_SPLIT": "1",
             "ANYREF_QKV_MHA_KERNEL": "1", "ANYREF_QKV_WINDOW_KERNEL": "0"}
# a non-square image: the resized frame leaves a bottom pad
IMAGE_HW = (48, 80)
POINTS = np.asarray([[20.0, 20.0], [50.0, 30.0]])
LABELS = np.asarray([1, 0])
BOX = np.asarray([10.0, 5.0, 60.0, 40.0])
PROMPTS = {"box": dict(box=BOX),
           "points": dict(point_coords=POINTS, point_labels=LABELS),
           "points_box": dict(point_coords=POINTS, point_labels=LABELS,
                              box=BOX)}
# the generator: 4 points a side in chunks of 6 (the last chunk of 4 is
# zero-padded), the mask decoder's last hypernetwork layer scaled so that
# random weights give logits of O(10) and the stability score spreads
AMG_HYPER_SCALE = 30.0
AMG_KW = dict(points_per_side=4, points_per_batch=6,
              stability_score_offset=1.0)
AMG_THRESHOLDS = {
    "keep_all": dict(pred_iou_thresh=-10.0, stability_score_thresh=0.0,
                     box_nms_thresh=1.0),
    "filtered": dict(pred_iou_thresh=-0.5, stability_score_thresh=0.45,
                     box_nms_thresh=0.7),
}
SCORE_TOL = 1e-4
MARGIN = 2 * SCORE_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _image(seed=0, hw=IMAGE_HW):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


@pytest.fixture(scope="module")
def weights():
    """{sam config: (JAX SAM tree, port tree)}, the JAX init of key 0."""
    out = {}
    for cfg in (SAM, SAM512):
        jp = jsam.init(jax.random.key(0), cfg, dtype=jnp.float32)
        out[cfg.image_size] = (jp, tparams.from_numpy(jax.device_get(jp),
                                                      device="cpu"))
    return out


def test_sam_normalize_pad_and_preprocess():
    x = np.random.default_rng(1).uniform(0, 255, (2, 3, 40, 64)).astype(
        np.float32)
    want = jsam.preprocess(jnp.asarray(x), SAM)
    got = tsam.preprocess(torch.from_numpy(x), SAM)
    assert got.shape == (2, 3, SAM.image_size, SAM.image_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=EMB_TOL, rtol=0)
    assert not got[..., 40:, :].any() and not got[..., 64:].any()
    want = jresize.sam_normalize_pad(jnp.asarray(x[0]), 72, (1.0, 2.0, 3.0),
                                     (4.0, 5.0, 6.0))
    got = tresize.sam_normalize_pad(torch.from_numpy(x[0]), 72,
                                    (1.0, 2.0, 3.0), (4.0, 5.0, 6.0))
    np.testing.assert_allclose(_np(got), _np(want), atol=EMB_TOL, rtol=0)


@pytest.mark.parametrize("pad", [True, False])
def test_embed_points_matches_jax(weights, pad):
    jp, tp = weights[SAM.image_size]
    rng = np.random.default_rng(2)
    coords = rng.uniform(0, SAM.image_size, (3, 4, 2)).astype(np.float32)
    labels = np.asarray([[1, 0, -1, 1], [0, 0, 1, -1], [-1, 1, 0, 0]],
                        np.float32)
    want = jpe.embed_points(jp["prompt_encoder"], SAM, jnp.asarray(coords),
                            jnp.asarray(labels), pad=pad)
    got = tpe.embed_points(tp["prompt_encoder"], SAM,
                           torch.from_numpy(coords),
                           torch.from_numpy(labels), pad=pad)
    assert got.shape == (3, 4 + pad, SAM.prompt_embed_dim)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=EMB_TOL, rtol=0)


def test_embed_boxes_matches_jax(weights):
    jp, tp = weights[SAM.image_size]
    boxes = np.random.default_rng(3).uniform(
        0, SAM.image_size, (3, 4)).astype(np.float32)
    want = jpe.embed_boxes(jp["prompt_encoder"], SAM, jnp.asarray(boxes))
    got = tpe.embed_boxes(tp["prompt_encoder"], SAM, torch.from_numpy(boxes))
    assert got.shape == (3, 2, SAM.prompt_embed_dim)
    np.testing.assert_allclose(_np(got), _np(want), atol=EMB_TOL, rtol=0)


def test_embed_masks_matches_jax(weights):
    jp, tp = weights[SAM.image_size]
    g = SAM.embedding_size
    m = np.random.default_rng(4).standard_normal(
        (2, 1, 4 * g, 4 * g)).astype(np.float32)
    want = jpe.embed_masks(jp["prompt_encoder"], jnp.asarray(m))
    got = tpe.embed_masks(tp["prompt_encoder"], torch.from_numpy(m))
    assert got.shape == (2, SAM.prompt_embed_dim, g, g)
    np.testing.assert_allclose(_np(got), _np(want), atol=EMB_TOL, rtol=0)


def assert_masks_near(got: np.ndarray, logits: np.ndarray):
    """Boolean masks ``got`` equal ``logits > 0`` except where the logit
    lies within MASK_NEAR_ZERO of 0."""
    assert got.shape == logits.shape and got.dtype == bool
    flips = got != (logits > 0)
    assert not (flips & (np.abs(logits) > MASK_NEAR_ZERO)).any(), \
        np.abs(logits[flips]).max()


@pytest.fixture(scope="module")
def predictors(weights):
    """{path: (JAX predictor, port predictor)}, set_image done once on the
    same image, each JAX side under its path's switches."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for path, cfg, env in (("unfused", SAM, UNFUSED_ENV),
                               ("fused", SAM512, FUSED_ENV)):
            for k, v in env.items():
                mp.setenv(k, v)
            jp, tp = weights[cfg.image_size]
            j = jpredictor.SamPredictor(jp, cfg)
            j.set_image(_image())
            t = tpredictor.SamPredictor(tp, cfg, encoder_path=path,
                                        device="cpu")
            t.set_image(_image())
            out[path] = (j, t)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("path,prompt,multimask", [
    ("unfused", "box", True), ("unfused", "box", False),
    ("unfused", "points", True), ("unfused", "points", False),
    ("unfused", "points_box", True), ("unfused", "points_box", False),
    ("fused", "points", True), ("fused", "points_box", False)])
def test_predictor_matches_jax(predictors, monkeypatch, path, prompt,
                               multimask):
    for k, v in (UNFUSED_ENV if path == "unfused" else FUSED_ENV).items():
        monkeypatch.setenv(k, v)
    j, t = predictors[path]
    jm, ji, jl = j.predict(multimask_output=multimask, **PROMPTS[prompt])
    tm, ti, tl = t.predict(multimask_output=multimask, **PROMPTS[prompt])
    K = 3 if multimask else 1
    g4 = 4 * t.cfg.embedding_size
    assert tm.shape == (K, *IMAGE_HW) and ti.shape == (K,)
    assert tl.shape == (K, g4, g4)
    tol = PATH_TOL[path]
    np.testing.assert_allclose(ti, _np(ji), atol=tol, rtol=tol)
    np.testing.assert_allclose(tl, _np(jl), atol=tol, rtol=tol)
    logits = tresize.postprocess_low_res_np(
        _np(jl), t.cfg.image_size, t._input_hw, IMAGE_HW)
    assert_masks_near(tm, logits)


def test_predictor_refuses_without_image_or_prompt(weights):
    _, tp = weights[SAM.image_size]
    t = tpredictor.SamPredictor(tp, SAM, encoder_path="unfused",
                                device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        t.predict(box=BOX)
    t.set_image(_image())
    with pytest.raises(ValueError):
        t.predict()


def test_build_point_grid_and_box_nms_match_jax():
    for n in (1, 4, 32):
        np.testing.assert_array_equal(tamg.build_point_grid(n),
                                      jamg.build_point_grid(n))
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, (40, 2))
    wh = rng.uniform(5, 60, (40, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.permutation(40) / 40.0
    for thresh in (0.0, 0.3, 0.7, 1.0):
        keep = tamg.box_nms(boxes, scores, thresh)
        assert keep == jamg.box_nms(boxes, scores, thresh)
    three = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                       np.float64)
    assert tamg.box_nms(three, np.asarray([0.9, 0.8, 0.7]), 0.5) == [0, 2]


@pytest.mark.parametrize("valid_hw", [(38, 64), (64, 27), (64, 64)])
def test_stability_score_counts_only_the_image(valid_hw):
    """A non-square image: logits in the pad beyond valid_hw (rows, cols)
    are huge and must not count."""
    rng = np.random.default_rng(6)
    low = rng.standard_normal((2, 3, 64, 64)).astype(np.float32) * 3
    low[..., valid_hw[0]:, :] = 50.0
    low[..., :, valid_hw[1]:] = 50.0
    want = jamg._stability_score(jnp.asarray(low),
                                 jnp.asarray(valid_hw, jnp.int32), 0.0, 1.0)
    got = tamg._stability_score(torch.from_numpy(low), valid_hw, 0.0, 1.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-7, rtol=0)
    inner = low[..., :valid_hw[0], :valid_hw[1]]
    np.testing.assert_allclose(
        _np(got), (inner > 1).sum((-2, -1)) / (inner > -1).sum((-2, -1)),
        atol=1e-7, rtol=0)


AMG_IMAGE_SEED = 7


def _set(gen, thresholds: dict, nms_thresh=None):
    """Set a generator's thresholds (host attributes of both packages'
    generators: its device functions stay compiled)."""
    gen.pred_iou_thresh = thresholds["pred_iou_thresh"]
    gen.st_thresh = thresholds["stability_score_thresh"]
    gen.nms_thresh = thresholds["box_nms_thresh"] if nms_thresh is None \
        else nms_thresh
    return gen


@pytest.fixture(scope="module")
def generators(weights):
    """(JAX generator, port generator, {(point x, y): ([3, H, W] JAX logits
    at the original size, [3] JAX ious)} for every grid point) with the
    last hypernetwork layer x AMG_HYPER_SCALE, the JAX side compiled under
    the "unfused" switches."""
    jp, _ = weights[SAM.image_size]
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    hm = jp["mask_decoder"]["hyper_mlps"][2]
    hm["w"] = hm["w"] * AMG_HYPER_SCALE
    tp = tparams.from_numpy(jax.device_get(jp), device="cpu")
    image = _image(AMG_IMAGE_SEED)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in UNFUSED_ENV.items():
            mp.setenv(k, v)
        jgen = jamg.SamAutomaticMaskGenerator(jp, SAM, **AMG_KW)
        h, w = image.shape[:2]
        nh, nw = jresize.get_preprocess_shape(h, w, SAM.image_size)
        x = jresize.resize_bilinear_np(
            image.astype(np.float32).transpose(2, 0, 1), nh, nw)
        emb = jgen._encode(jp, jsam.preprocess(jnp.asarray(x)[None], SAM))
        coords = jgen.grid * np.asarray([nw, nh])
        low, iou = jgen._decode(jp, embedding=emb,
                                coords=jnp.asarray(coords, jnp.float32))
    ref = {}
    for j, c in enumerate(coords):
        key = (float(c[0] * w / nw), float(c[1] * h / nh))
        ref[key] = (jresize.postprocess_masks_np(_np(low)[j], (nh, nw),
                                                 (h, w)), _np(iou)[j])
    tgen = tamg.SamAutomaticMaskGenerator(tp, SAM, encoder_path="unfused",
                                          device="cpu", **AMG_KW)
    return jgen, tgen, ref


@pytest.mark.parametrize("thresholds", sorted(AMG_THRESHOLDS))
def test_generate_matches_jax(generators, thresholds):
    jgen, tgen, ref = generators
    kw = AMG_THRESHOLDS[thresholds]
    image = _image(AMG_IMAGE_SEED)
    want = _set(jgen, kw).generate(image)
    timings = {}
    got = _set(tgen, kw).generate(image, timings=timings)
    assert set(timings) == {"encode_s", "decode_s", "stability_s", "host_s"}
    assert len(got) == len(want) >= 1
    scores = sorted(r["predicted_iou"] for r in want)
    assert len(want) == 1 or min(np.diff(scores)) > MARGIN
    for r in want:
        assert abs(r["predicted_iou"] - kw["pred_iou_thresh"]) > MARGIN
        assert abs(r["stability_score"] - kw["stability_score_thresh"]) > \
            MARGIN
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["point_coords"] == w["point_coords"]
        assert g["bbox"] == w["bbox"] and g["area"] == w["area"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= SCORE_TOL
        assert abs(g["stability_score"] - w["stability_score"]) <= SCORE_TOL
        logits, iou = ref[tuple(g["point_coords"][0])]
        m = int(np.argmin(np.abs(iou - w["predicted_iou"])))
        assert_masks_near(trle.decode(g["segmentation"]).astype(bool),
                          logits[m])
    # NMS's input: the records that pass the filters, none of whose box
    # IoUs lies within MARGIN of the NMS threshold (keep_all's threshold
    # of 1 suppresses nothing: an IoU is never above 1)
    thresh = kw["box_nms_thresh"]
    passed = _set(jgen, kw, nms_thresh=1.0).generate(image)
    if thresholds == "filtered":
        # the filters dropped masks, and NMS dropped more
        assert len(want) < len(passed) < 3 * len(ref)
    else:
        assert len(want) == len(passed) == 3 * len(ref)
    boxes = np.asarray([[b[0], b[1], b[0] + b[2], b[1] + b[3]]
                        for b in (r["bbox"] for r in passed)])
    for i in range(len(boxes)):
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / np.maximum(area[i] + area - inter, 1e-9)
        assert thresh == 1.0 or not (np.abs(iou - thresh) <= MARGIN).any()
