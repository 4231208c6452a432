"""The port's eval data layer against the JAX package's, on the CPU: the
COCO RLE codec (data/rle.py over csrc/rle.cpp), the REFER indexes and
every segmentation reader, field by field on the same files and seeds.

The readers run over tests/test_datasets.py's ``data_root`` fixture, with
a gRefCOCO split (a multi-target and two no-target refs) added to it, and
over chip_smoke.write_eval_root's AVSBench test splits (one 5-frame video
each, the layout the AVS harness scores). Arrays and strings are equal;
the AVS mel clips agree within tests/test_torch_references.py's limit (the
two fp32 FFTs round differently: 2e-3 on the log-mel, / 9.138 after the
clips' normalisation)."""

import json
import os
import pathlib
import wave

import numpy as np
import pytest

from anyref_tpu.config import anyref_tiny as jtiny
from anyref_tpu.data import avs as javs
from anyref_tpu.data import base as jbase
from anyref_tpu.data import categories as jcat
from anyref_tpu.data import coco as jcoco
from anyref_tpu.data import coco20i as jcoco20i
from anyref_tpu.data import reason as jreason
from anyref_tpu.data import refcoco as jrefcoco
from anyref_tpu.data import refer as jrefer
from anyref_tpu.data import rle as jrle
from anyref_tpu_torch.config import anyref_tiny as ttiny
from anyref_tpu_torch.data import avs as tavs
from anyref_tpu_torch.data import base as tbase
from anyref_tpu_torch.data import categories as tcat
from anyref_tpu_torch.data import coco as tcoco
from anyref_tpu_torch.data import coco20i as tcoco20i
from anyref_tpu_torch.data import reason as treason
from anyref_tpu_torch.data import refcoco as trefcoco
from anyref_tpu_torch.data import refer as trefer
from anyref_tpu_torch.data import rle as trle
from anyref_tpu_torch.ops import mel as tmel

import chip_smoke

from .test_datasets import data_root  # noqa: F401  (fixture reuse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MEL_TOL = 2e-3 / 9.138


def _same(a, b, where=""):
    """Equal values: arrays in dtype, shape and every element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_sample(got, want):
    assert set(got) == set(want)
    for k in got:
        if k == "audio_mels":
            assert got[k].shape == want[k].shape == (3, 1, 128, 204)
            np.testing.assert_allclose(got[k], want[k], atol=MEL_TOL, rtol=0)
        else:
            _same(got[k], want[k], k)


def _same_reader(got, want, n=None):
    """Every item of two readers (both given the tiny preset's sizes), in
    index order, so that their seeded draws come in the same order."""
    got.cfg, want.cfg = ttiny(), jtiny()
    assert len(got) == len(want) > 0
    for i in range(n or len(got)):
        _same_sample(got[i], want[i])


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------
def _native_snapshot():
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns, p.read_bytes())
            for p in sorted((ROOT / "native").iterdir())}


def test_rle_both_sides_native():
    """The JAX codec loaded its library (else it would run its numpy
    paths), and the port's runs the library it built in its own build
    directory."""
    assert jrle._load(), "the JAX package's native RLE did not build"
    path = pathlib.Path(trle.native())
    assert path == trle.library_path() and path.exists()
    assert path.parent == ROOT / "anyref_tpu_torch" / "build"


def test_rle_build_writes_nothing_into_native(tmp_path):
    """A build of the port's library (into a fresh directory, as the loader
    builds into anyref_tpu_torch/build) and the loader itself leave the
    JAX package's native/ directory as it was."""
    jrle._load()
    before = _native_snapshot()
    so = trle.compile_library(trle.SOURCE, tmp_path / "librle.so")
    assert so.exists() and so.stat().st_size > 0
    assert not list(tmp_path.glob("*.tmp"))
    trle.native()
    assert _native_snapshot() == before


def test_rle_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" int rle_encode( {\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error: "):
        trle.compile_library(src, tmp_path / "broken.so")
    assert not (tmp_path / "broken.so").exists()
    assert not list(tmp_path.glob("*.tmp"))


def _masks(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(5, 60, 2)
    out = [(rng.random((h, w)) > p).astype(np.uint8) for p in (0.3, 0.7, 0.97)]
    out += [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    edge = np.zeros((h, w), np.uint8)
    edge[0, 0] = edge[-1, -1] = 1
    return out + [edge]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_codec_matches_jax(seed):
    """encode, decode, area, to_bbox, merge and the string codec bit for
    bit on seeded masks (empty, full and corner-only among them)."""
    masks = _masks(seed)
    for m in masks:
        got, want = trle.encode(m), jrle.encode(m)
        _same(got, want)
        np.testing.assert_array_equal(trle.decode(got), m)
        _same(trle.decode(want), jrle.decode(want))
        assert trle.area(got) == jrle.area(want) == int(m.sum())
        _same(trle.to_bbox(got), jrle.to_bbox(want))
        s = trle.counts_to_string(got["counts"])
        assert s == jrle.counts_to_string(want["counts"])
        _same(trle.string_to_counts(s), jrle.string_to_counts(s))
        _same(trle.string_to_counts(s.decode()), got["counts"])
        _same(trle.decode({"size": got["size"], "counts": s}), m)
    encs = [trle.encode(m) for m in masks]
    _same(trle.merge(encs), jrle.merge([jrle.encode(m) for m in masks]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_native_matches_numpy_versions(seed):
    """The port's native codec against its own numpy versions, the plain
    reference it keeps."""
    masks = _masks(seed)
    for m in masks:
        got = trle.encode(m)
        _same(got, trle._encode_np(m))
        _same(trle.decode(got), trle._decode_np(got))
        _same(trle.to_bbox(got), trle._to_bbox_np(got).astype(np.float64))
        s = trle.counts_to_string(got["counts"])
        assert s == trle._counts_to_string_np(got["counts"])
        _same(trle._string_to_counts_np(s), got["counts"])
    encs = [trle.encode(m) for m in masks]
    _same(trle.decode(trle.merge(encs)),
          trle._decode_np(trle._merge_np(encs)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_polygons_match_jax(seed):
    """Polygon fills (pycocotools' rule, not PIL's) and the three
    annotation forms, a multi-part polygon among them."""
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    polys = [chip_smoke.star_polygon(rng, h, w, f) for f in (0.05, 0.2, 0.4)]
    polys.append([0.0, 0.0, 63.5, 0.0, 63.5, 47.5, 0.2, 30.0])
    polys.append([10.5, 10.5, 20.5, 10.5, 15.5, 10.5])     # degenerate
    _same(trle.from_polygons(polys, h, w), jrle.from_polygons(polys, h, w))
    multi = polys[:2]
    m = trle.annotation_to_mask(multi, h, w)
    _same(m, jrle.annotation_to_mask(multi, h, w))
    assert m.sum() > 0
    enc = trle.encode(m)
    for seg in ({"size": [h, w], "counts": enc["counts"].tolist()},
                {"size": [h, w],
                 "counts": trle.counts_to_string(enc["counts"]).decode()}):
        _same(trle.annotation_to_mask(seg, h, w),
              jrle.annotation_to_mask(seg, h, w))
        np.testing.assert_array_equal(trle.annotation_to_mask(seg, h, w), m)


def test_rle_truncated_string_raises_like_jax():
    s = trle.counts_to_string([3, 70000, 5])[:-1] + b"P"  # continuation set
    for mod in (trle, jrle):
        with pytest.raises(ValueError, match="truncated"):
            mod.string_to_counts(s)
    with pytest.raises(ValueError):
        trle.merge([])


# ---------------------------------------------------------------------------
# indexes and readers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def refer_root(data_root):  # noqa: F811
    """data_root with a gRefCOCO split: a two-target ref, a no-target ref
    of ann_id [-1], one of [] and a single int ann_id."""
    base = os.path.join(data_root, "grefcoco")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(data_root, "refcoco", "instances.json")) as f:
        coco = json.load(f)
    with open(os.path.join(base, "instances.json"), "w") as f:
        json.dump(coco, f)
    refs = []
    for rid, (iid, aid) in enumerate([(1, [1, 2]), (2, [-1]), (3, []),
                                      (3, 5)]):
        sents = [{"sent": f"  The Object {rid} ", "sent_id": 2 * rid},
                 {"sent": f"thing number {rid}", "sent_id": 2 * rid + 1}]
        refs.append({"ref_id": rid, "ann_id": aid, "image_id": iid,
                     "category_id": 1, "split": "val", "sentences": sents,
                     "file_name": f"{iid:012d}.jpg",
                     "sent_ids": [2 * rid, 2 * rid + 1]})
    with open(os.path.join(base, "grefs(unc).json"), "w") as f:
        json.dump(refs, f)
    return data_root


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """chip_smoke's data roots at a small size: the AVSBench test splits,
    one 5-frame video each."""
    root = str(tmp_path_factory.mktemp("eval_root"))
    chip_smoke.write_eval_root(root, (48, 64), 2)
    return root


def test_categories_are_the_jax_tables():
    assert tcat.COCO_THING_CLASSES == jcat.COCO_THING_CLASSES
    assert tcat.ADE_INSTANCE_CLASSES == jcat.ADE_INSTANCE_CLASSES
    assert tcat.ADE_SEMANTIC_CLASSES == jcat.ADE_SEMANTIC_CLASSES
    for split in range(4):
        assert tcoco20i.coco20i_split_ids(split) == \
            jcoco20i.coco20i_split_ids(split)


@pytest.mark.parametrize("dataset", ["refcoco", "grefcoco"])
def test_refer_indexes_match_jax(refer_root, dataset):
    got = trefer.open_refer(refer_root, dataset)
    want = jrefer.open_refer(refer_root, dataset)
    assert type(got).__name__ == type(want).__name__
    for split in ("", "train", "val"):
        ids = got.getRefIds(split=split)
        assert ids == want.getRefIds(split=split)
        assert got.getImgIds(ids) == want.getImgIds(ids)
        _same(got.loadRefs(ids), want.loadRefs(ids))
    assert got.getImgIds() == want.getImgIds()
    assert got.getImgIds(0) == want.getImgIds(0)
    _same(got.loadImgs([1, 2]), want.loadImgs([1, 2]))
    for ref in got.refs_list:
        _same(got.get_mask(ref), want.get_mask(ref), str(ref["ref_id"]))
    for aid, ann in got.coco.anns.items():
        _same(got.coco.ann_to_mask(ann), want.coco.ann_to_mask(ann))
        assert got.coco.get_ann_ids(ann["image_id"]) == \
            want.coco.get_ann_ids(ann["image_id"])
    if dataset == "grefcoco":
        flags = [got.is_no_target(r) for r in got.refs_list]
        assert flags == [want.is_no_target(r) for r in want.refs_list] == \
            [False, True, True, False]
        assert got.get_mask(got.refs_list[1]).sum() == 0


def test_refcoco_val_matches_jax(refer_root):
    _same_reader(trefcoco.RefCocoVal(refer_root, "refcoco", "val"),
                 jrefcoco.RefCocoVal(refer_root, "refcoco", "val"))


@pytest.mark.parametrize("seed,all_sentences,datasets", [
    (0, False, "refcoco"), (5, False, "refcoco"), (1, True, "refcoco"),
    (2, False, "grefcoco"), (3, False, "refcoco,grefcoco")])
def test_refcoco_train_matches_jax(refer_root, seed, all_sentences,
                                   datasets):
    """The seeded sentence and pair draws, and gRefCOCO's no-target refs
    answered "there is no ..." without a mask."""
    split = "val" if "grefcoco" in datasets else "train"
    got = trefcoco.RefCocoTrain(refer_root, datasets, split=split,
                                all_sentences=all_sentences, seed=seed)
    want = jrefcoco.RefCocoTrain(refer_root, datasets, split=split,
                                 all_sentences=all_sentences, seed=seed)
    for _ in range(2):      # a second pass continues the draws
        _same_reader(got, want)
    if datasets == "grefcoco":
        answers = [got[i]["answer"] for i in range(len(got))]
        assert any(a.startswith("there is no") for a in answers), answers


@pytest.mark.parametrize("roi,no_mask", [(False, False), (True, False),
                                         (False, True)])
def test_refcoco_inverse_matches_jax(refer_root, roi, no_mask):
    kw = dict(split="train", roi=roi, no_mask=no_mask, seed=4)
    _same_reader(trefcoco.RefCocoInverse(refer_root, "refcoco", **kw),
                 jrefcoco.RefCocoInverse(refer_root, "refcoco", **kw))


@pytest.mark.parametrize("roi", [False, True])
def test_refcoco_val_inverse_matches_jax(refer_root, roi):
    _same_reader(
        trefcoco.RefCocoValInverse(refer_root, "refcoco", "val", roi=roi),
        jrefcoco.RefCocoValInverse(refer_root, "refcoco", "val", roi=roi))


def test_get_mask_from_json_matches_jax(tmp_path):
    """Targets fill 1, ignore regions 255 over them, shapes of fewer than
    three points skipped; a string text is one sentence."""
    rng = np.random.default_rng(0)
    shapes = [{"label": "ignore", "points": np.reshape(
                  chip_smoke.star_polygon(rng, 40, 50, 0.1), (-1, 2)).tolist()},
              {"label": "target", "points": np.reshape(
                  chip_smoke.star_polygon(rng, 40, 50, 0.4), (-1, 2)).tolist()},
              {"label": "target", "points": [[1, 1], [5, 5]]},
              {"points": [[30, 2], [48, 2], [48, 20]]}]
    path = tmp_path / "a.json"
    path.write_text(json.dumps({"text": "a sentence", "is_sentence": True,
                                "shapes": shapes}))
    got = treason.get_mask_from_json(str(path), 40, 50)
    _same(got, jreason.get_mask_from_json(str(path), 40, 50))
    assert set(np.unique(got[0])) == {0, 1, 255}
    assert got[1:] == (["a sentence"], True)


@pytest.mark.parametrize("split", ["train", "val"])
def test_reason_seg_matches_jax(data_root, split):  # noqa: F811
    root = os.path.join(data_root, "reason")
    for only1 in (False, True):
        _same_reader(treason.ReasonSeg(root, split, only1=only1, seed=1),
                     jreason.ReasonSeg(root, split, only1=only1, seed=1))


def _coco_paths(root):
    return (os.path.join(root, "coco/train2017"),
            os.path.join(root, "coco/annotations/instances_train2017.json"))


def test_coco_instances_match_jax(data_root):  # noqa: F811
    for area in (None, 0.2):
        got = tcoco.CocoInstances(*_coco_paths(data_root), filter_area=area)
        want = jcoco.CocoInstances(*_coco_paths(data_root), filter_area=area)
        assert got.ids == want.ids
        for i in range(len(got)):
            _same(got.load(i), want.load(i), str(i))


@pytest.mark.parametrize("kw", [
    dict(filter_area=None, seed=0),
    dict(filter_area=None, use_loc_tokens=True, sampled_class_num=2, seed=1),
    dict(filter_area=0.01, unexist_prob=0.5, seed=2),
    dict(filter_area=None, overfit=True, seed=3)])
def test_coco_instance_seg_matches_jax(data_root, kw):  # noqa: F811
    _same_reader(tcoco.CocoInstanceSeg(*_coco_paths(data_root), **kw),
                 jcoco.CocoInstanceSeg(*_coco_paths(data_root), **kw), n=4)


@pytest.mark.parametrize("itisseg", [False, True])
def test_coco_semantic_seg_matches_jax(data_root, itisseg):  # noqa: F811
    kw = dict(filter_area=None, itisseg=itisseg, seed=2)
    got = tcoco.CocoSemanticSeg(*_coco_paths(data_root), **kw)
    want = jcoco.CocoSemanticSeg(*_coco_paths(data_root), **kw)
    _same_reader(got, want)
    _same(got.semantic_record(0), want.semantic_record(0))


def test_build_ref_index_matches_jax(data_root, tmp_path):  # noqa: F811
    for thr in ((0.1, 0.4), (0.01, 0.1)):
        got = tcoco.build_ref_index(*_coco_paths(data_root),
                                    str(tmp_path / "t.json"), *thr)
        want = jcoco.build_ref_index(*_coco_paths(data_root),
                                     str(tmp_path / "j.json"), *thr)
        assert got == want
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
    assert got


@pytest.mark.parametrize("apply_mask_prob", [0.0, 1.0])
def test_coco_image_ref_seg_matches_jax(data_root, apply_mask_prob):  # noqa: F811
    index = os.path.join(data_root, "samples_0.05_0.25.json")
    kw = dict(apply_mask_prob=apply_mask_prob, person_keep_frac=0.5, seed=3)
    _same_reader(tcoco.CocoImageRefSeg(*_coco_paths(data_root), index, **kw),
                 jcoco.CocoImageRefSeg(*_coco_paths(data_root), index, **kw))


@pytest.mark.parametrize("apply_mask", [False, True])
def test_coco20i_matches_jax(data_root, apply_mask):  # noqa: F811
    """Split 0's list, the last split class of each image (the reference's
    overwrite rule), a reference crop from the index."""
    args = (*_coco_paths(data_root),
            os.path.join(data_root, "samples_0.05_0.25.json"),
            os.path.join(data_root, "coco_20i/lists/coco/fss_list"))
    kw = dict(split=0, mode="val", apply_mask=apply_mask, seed=6)
    got, want = tcoco20i.Coco20i(*args, **kw), jcoco20i.Coco20i(*args, **kw)
    _same_reader(got, want)
    assert "orig_ref_img" in got[0]


def test_avs_object_matches_jax(eval_root):
    """S4's 5-frame test video; the multi-modality prompt names the
    class."""
    root = os.path.join(eval_root, "avsbench/Single-source")
    for kw in ({}, dict(multi_modality=True, itisseg=True,
                        convert_classname=False)):
        got = tavs.AVSObject(root, "test", device="cpu", **kw)
        assert len(got) == 5
        _same_reader(got, javs.AVSObject(root, "test", **kw))


def test_avs_object_train_frame_matches_jax(data_root):  # noqa: F811
    """The fixture's one train frame. Its audio is a pure tone at 0.61 of
    full scale, where the port's mel front end strays from the JAX one by
    up to 3.8e-4 (after the clips' normalisation) in a few dozen of 78,336
    values, in the bands far from the tone, whose power is near the FFTs'
    rounding: above MEL_TOL. So the mel clips are held to the port's own
    front end on the file the reader read; every other field to JAX's."""
    import torch
    root = os.path.join(data_root, "avsbench/Single-source")
    got = tavs.AVSObject(root, "train", device="cpu")
    want = javs.AVSObject(root, "train")
    got.cfg, want.cfg = ttiny(), jtiny()
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    wav = os.path.join(root, "s4_data/audio_wav/train/cat_meowing/v1.wav")
    mels = tmel.audio_to_mel_clips(tavs.load_wav(wav), device="cpu")
    assert torch.equal(torch.from_numpy(g.pop("audio_mels")), mels)
    w.pop("audio_mels")
    _same_sample(g, w)


def test_avs_multi_matches_jax(eval_root):
    root = os.path.join(eval_root, "avsbench/Multi-sources")
    got = tavs.AVSMulti(root, "test", device="cpu")
    assert len(got) == 5
    _same_reader(got, javs.AVSMulti(root, "test"))
    assert got[2]["gt_masks"].sum() == 0        # the frame with no object


def test_avs_reader_refuses_cpu_without_being_told(eval_root, monkeypatch):
    """The reader's mel front end follows the port's device rule."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tavs.AVSMulti(os.path.join(eval_root, "avsbench/Multi-sources"),
                       "test")
    ds.cfg = ttiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds[0]


@pytest.mark.parametrize("width,channels,rate", [(2, 1, 16000), (2, 2, 8000),
                                                 (1, 1, 22050), (4, 2, 16000)])
def test_load_wav_matches_jax(tmp_path, width, channels, rate):
    rng = np.random.default_rng(width * channels)
    n = rate // 3
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max, (n, channels), dtype=dtype)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(data.tobytes())
    _same(tavs.load_wav(path), javs.load_wav(path))


def test_bad_sample_retry_matches_jax():
    """A bad sample (None or a missing file) moves to an index drawn from
    the reader's Random(0), up to 32 tries; without retry_bad, one."""
    def reader(base):
        class Flaky(base.SegDataset):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.tried = []

            def __len__(self):
                return 50

            def _get(self, index):
                self.tried.append(index)
                if index % 7 == 3:
                    return {"index": index}
                if index % 2:
                    raise FileNotFoundError(index)
                return None
        return Flaky

    got, want = reader(tbase)(), reader(jbase)()
    for i in (0, 3, 8, 20):
        assert got[i] == want[i]
    assert got.tried == want.tried and len(got.tried) > 4
    for r in (reader(tbase)(retry_bad=False), reader(jbase)(retry_bad=False)):
        with pytest.raises(RuntimeError, match="no valid sample"):
            r[0]
        assert r.tried == [0]


def test_load_image_rgb_matches_jax(data_root, eval_root):  # noqa: F811
    for path in (os.path.join(data_root, "coco/train2017/000000000001.jpg"),
                 os.path.join(eval_root, "avsbench/Multi-sources/ms3_data/"
                              "visual_frames/m1/m1_1.png")):
        _same(tbase.load_image_rgb(path), jbase.load_image_rgb(path))
    mask = os.path.join(eval_root, "avsbench/Multi-sources/ms3_data/"
                        "gt_masks/m1/m1_1.png")
    _same(tavs.load_mask_png(mask), javs.load_mask_png(mask))
