"""The port's training data path against the JAX package's, on the CPU: the
ADE20K and PhraseCut readers, the dataset registry, the Trainer building
its own mix, the training CLI and the reference-index CLI.

The readers run over tests/test_datasets.py's ``data_root`` fixture and
over chip_smoke.write_train_root's layouts (several ADE20K classes and
instances, refCOCO train refs), each item of a fresh port reader against
the same item of a fresh JAX reader, in index order and in one thread: the
readers draw from ``random.Random(seed)`` inside ``_get``, so only the
order of reads fixes the draws (the Trainer's loader threads do not).
Arrays and strings are equal; the AVS mel clips agree within
tests/test_torch_eval_data.py's limit."""

import json
import os
import pathlib
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from anyref_tpu.config import anyref_tiny as jtiny
from anyref_tpu.data import ade as jade
from anyref_tpu.data import phrasecut as jphrasecut
from anyref_tpu.data import registry as jregistry
from anyref_tpu.train import step as jstep
from anyref_tpu_torch import checkpoint
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny as ttiny
from anyref_tpu_torch.data import ade as tade
from anyref_tpu_torch.data import phrasecut as tphrasecut
from anyref_tpu_torch.data import registry as tregistry
from anyref_tpu_torch.data.collator import Collator
from anyref_tpu_torch.tokenizer import AnyRefTokenizer
from anyref_tpu_torch.tools import build_ref_index as tindex_cli
from anyref_tpu_torch.tools import train as ttrain_cli
from anyref_tpu_torch.train import step as tstep
from anyref_tpu_torch.train.trainer import TrainConfig, Trainer

import chip_smoke

from .test_datasets import data_root  # noqa: F401  (fixture reuse)
from .test_torch_eval_data import _same, _same_reader, _same_sample

ROOT = pathlib.Path(__file__).resolve().parent.parent
MIX = ("refer_seg_refcoco,coco_instance,ade_instance,ade_semantic,reason,"
       "refer_seg_inv_refcoco")
# every name the JAX registry knows, and a mix
REGISTRY_NAMES = ("coco_instance", "coco_inv", "ade_instance",
                  "ade_semantic", "refer_seg", "grefcoco", "refer_seg_inv",
                  "refer_seg_inv_refcoco", "refer_seg_refcoco+", "reason",
                  "avs_object", "avs_multi", MIX)


def _ade_dirs(root):
    base = os.path.join(root, "ADEChallengeData2016")
    return [os.path.join(base, d, "training") for d in
            ("images", "annotations_instance", "annotations")]


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """chip_smoke.write_train_root at a small size, with the other refer
    families (refcoco+, refcocog, refclef, gRefCOCO) made from its refCOCO
    refs and the AVSBench train splits from write_eval_root's test video,
    so that every registry name finds its files."""
    root = tmp_path_factory.mktemp("train_root")
    chip_smoke.write_train_root(str(root), (48, 64), 2)
    ref = root / "refcoco"
    with open(ref / "refs(unc).p", "rb") as f:
        refs = pickle.load(f)
    for name, pickle_name in (("refcoco+", "refs(unc).p"),
                              ("refcocog", "refs(umd).p"),
                              ("refclef", "refs(unc).p")):
        (root / name).mkdir()
        shutil.copy(ref / "instances.json", root / name / "instances.json")
        shutil.copy(ref / "refs(unc).p", root / name / pickle_name)
    shutil.copytree(root / "coco" / "train2017", root / "saiapr_tc-12")
    (root / "grefcoco").mkdir()
    shutil.copy(ref / "instances.json", root / "grefcoco" / "instances.json")
    grefs = [dict(r, ann_id=[r["ann_id"]] if i else [-1])
             for i, r in enumerate(refs)]
    with open(root / "grefcoco" / "grefs(unc).json", "w") as f:
        json.dump(grefs, f)

    ev = tmp_path_factory.mktemp("avs")
    chip_smoke.write_eval_root(str(ev), (48, 64), 1)
    s4 = ev / "avsbench" / "Single-source" / "s4_data"
    for sub in s4.iterdir():
        (sub / "test").rename(sub / "train")
    for sub, name in (("Single-source", "s4_meta_data.csv"),
                      ("Multi-sources", "ms3_meta_data.csv")):
        csv = ev / "avsbench" / sub / name
        csv.write_text(csv.read_text().replace("test", "train"))
    shutil.copytree(ev / "avsbench", root / "avsbench")
    return str(root)


@pytest.fixture(params=["fixture", "train_root"])
def ade_root(request, data_root, train_root):  # noqa: F811
    return data_root if request.param == "fixture" else train_root


# ---------------------------------------------------------------------------
# ADE20K and PhraseCut
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(filter_area=None, seed=3),
    dict(sampled_class_num=2, max_instances=2, seed=1),
    dict(filter_area=0.05, seed=2)])
def test_ade_instance_matches_jax(ade_root, kw):
    images, inst, _ = _ade_dirs(ade_root)
    got = tade.AdeInstanceSeg(images, inst, **kw)
    want = jade.AdeInstanceSeg(images, inst, **kw)
    assert (got.images, got.labels) == (want.images, want.labels)
    for _ in range(2):      # a second pass continues the draws
        _same_reader(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(itisseg=True, seed=4),
                                dict(filter_area=None, seed=5)])
def test_ade_semantic_matches_jax(ade_root, kw):
    images, _, sem = _ade_dirs(ade_root)
    got = tade.AdeSemanticSeg(images, sem, **kw)
    want = jade.AdeSemanticSeg(images, sem, **kw)
    for _ in range(2):
        _same_reader(got, want)


def test_ade_lists_only_labelled_images(train_root, tmp_path):
    """A .jpg without its .png, and a file that is not a .jpg, are left
    out, in both packages."""
    images, inst, _ = _ade_dirs(train_root)
    img_dir = tmp_path / "images"
    shutil.copytree(images, img_dir)
    shutil.copy(img_dir / "ADE_train_00000001.jpg", img_dir / "extra.jpg")
    (img_dir / "notes.txt").write_text("x")
    got = tade._list_images(str(img_dir), inst)
    assert got == jade._list_images(str(img_dir), inst)
    assert [os.path.basename(p) for p in got[0]] == \
        ["ADE_train_00000001.jpg", "ADE_train_00000002.jpg"]


@pytest.fixture(scope="module")
def phrasecut_root(tmp_path_factory):
    """tests/test_amg_phrasecut.py::test_phrasecut's layout with a train
    and a val task file: a one-polygon task (the test's own), a task of two
    polygon groups, and one with only a degenerate polygon (a bad sample,
    which a train reader replaces by a random index)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("phrasecut")
    base = root / "VGPhraseCut_v0"
    (base / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for image_id in (123, 124):
        Image.fromarray(rng.integers(0, 255, (60, 80, 3), np.uint8)).save(
            base / "images" / f"{image_id}.jpg")
    tasks = [{"task_id": "t0", "image_id": 123,
              "phrase": "red apple on table",
              "Polygons": [[[[10, 10], [40, 10], [40, 30], [10, 30]]]]},
             {"task_id": "t1", "image_id": 124, "phrase": " Two Dogs ",
              "Polygons": [[[[5, 5], [30, 8], [20, 40]]],
                           [[[50, 20], [75, 25], [70, 55], [45, 50]]]]},
             {"task_id": "t2", "image_id": 123, "phrase": "a line",
              "Polygons": [[[[1, 1], [5, 5]]]]}]
    for split, order in (("train", (0, 1, 2)), ("val", (1, 0))):
        with open(base / f"refer_{split}.json", "w") as f:
            json.dump([tasks[i] for i in order], f)
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
def test_phrasecut_matches_jax(phrasecut_root, split):
    for kw in (dict(seed=1), dict(itisseg=True, min_mask_frac=0.2, seed=2)):
        got = tphrasecut.PhraseCut(phrasecut_root, split, **kw)
        want = jphrasecut.PhraseCut(phrasecut_root, split, **kw)
        _same_reader(got, want)
        if split == "val":
            assert got[0]["answer"] is None
        if split == "train" and "itisseg" in kw:
            assert got[0]["answer"] == "it is [SEG]."


def test_phrasecut_on_write_train_root(train_root):
    got = tphrasecut.PhraseCut(train_root, "train", seed=3)
    _same_reader(got, jphrasecut.PhraseCut(train_root, "train", seed=3))
    assert got[1]["gt_masks"].sum() > 0


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class _Items:
    def __init__(self, tag, n):
        self.tag, self.n = tag, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        return (self.tag, i)


def test_concat_dataset_matches_jax():
    """Offsets, lengths and every index, an empty dataset among them; an
    index past either end raises IndexError in both."""
    parts = [("a", 3), ("b", 0), ("c", 2), ("d", 1)]
    got = tregistry.ConcatDataset([_Items(*p) for p in parts])
    want = jregistry.ConcatDataset([_Items(*p) for p in parts])
    assert (got.offsets, len(got)) == (want.offsets, len(want)) == \
        ([0, 3, 3, 5], 6)
    assert [got[i] for i in range(6)] == [want[i] for i in range(6)] == \
        [("a", 0), ("a", 1), ("a", 2), ("c", 0), ("c", 1), ("d", 0)]
    for i in (-1, 6):
        for ds in (got, want):
            with pytest.raises(IndexError):
                ds[i]


def _flat(ds):
    return ds.datasets if isinstance(ds, (tregistry.ConcatDataset,
                                          jregistry.ConcatDataset)) else [ds]


@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_build_train_datasets_matches_jax(train_root, name):
    """Each name builds the JAX registry's readers (type, length and every
    item, with cfg set); the AVS readers' mel front end runs on the CPU
    here (the port's device argument)."""
    kw = dict(itisseg=name == "ade_semantic", roi=name == "refer_seg_inv",
              no_mask=name == "refer_seg_inv_refcoco")
    got = tregistry.build_train_datasets(name, train_root, ttiny(),
                                         device="cpu", **kw)
    want = jregistry.build_train_datasets(name, train_root, jtiny(), **kw)
    assert type(got).__name__ == type(want).__name__
    assert [(type(d).__name__, len(d)) for d in _flat(got)] == \
        [(type(d).__name__, len(d)) for d in _flat(want)]
    assert all(d.cfg == ttiny() for d in _flat(got))
    assert len(got) == len(want) > 0
    if name.startswith("avs"):
        assert all(d.device == "cpu" for d in _flat(got))
    for i in range(len(got)):
        _same_sample(got[i], want[i])


def test_build_train_datasets_unknown_name_raises_like_jax(train_root):
    for mod, cfg in ((tregistry, ttiny()), (jregistry, jtiny())):
        with pytest.raises(ValueError, match="unknown dataset 'phrasecut'"):
            mod.build_train_datasets("reason, phrasecut", train_root, cfg)


def test_build_train_datasets_ref_index_file(train_root, tmp_path):
    """coco_inv reads the index named by ref_index_file."""
    index = str(tmp_path / "index.json")
    shutil.copy(os.path.join(train_root, "samples_0.05_0.25.json"), index)
    got = tregistry.build_train_datasets("coco_inv", train_root, ttiny(),
                                         ref_index_file=index)
    want = jregistry.build_train_datasets("coco_inv", train_root, jtiny(),
                                          ref_index_file=index)
    _same_reader(got, want)


# ---------------------------------------------------------------------------
# micro-batches, the Trainer and the CLIs
# ---------------------------------------------------------------------------
def _batches(train_root, names, roi=False, bs=2):
    ds = tregistry.build_train_datasets(names, train_root, ttiny(),
                                        roi=roi)
    col = Collator(AnyRefTokenizer(), ttiny(), train=True, roi=roi)
    return [col([ds[i] for i in range(j, j + bs)])
            for j in range(0, len(ds) - bs + 1, bs)]


def test_stack_microbatches_matches_jax_on_equal_keys(train_root):
    batches = _batches(train_root, "refer_seg_refcoco,ade_instance")
    got = tstep.stack_microbatches(batches)
    want = jstep.stack_microbatches(batches)
    assert list(got) == list(want)
    _same(got, {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("roi", [False, True])
def test_stack_microbatches_fills_a_missing_reference(train_root, roi):
    """A micro-batch with a crop (or a box) beside one without: the
    reference keys are the collated ones where present and zeros, not
    valid, elsewhere, whichever comes first. (The JAX function takes the
    first micro-batch's keys: it drops the crop in one order and raises
    KeyError in the other.)"""
    text, = _batches(train_root, "refer_seg_refcoco")
    ref, = _batches(train_root, "refer_seg_inv_refcoco", roi=roi)
    key = "roi_boxes" if roi else "ref_images"
    assert key in ref and key not in text
    for order in ((ref, text), (text, ref)):
        got = tstep.stack_microbatches(list(order))
        i = order.index(ref)
        for k in ref:
            if k.startswith("_"):
                continue
            _same(got[k][i], ref[k], k)
            other = text.get(k, np.zeros_like(ref[k]))
            _same(got[k][1 - i], other, k)
        assert got["ref_valid"][i].all() and not got["ref_valid"][1 - i].any()
    with pytest.raises(KeyError):
        jstep.stack_microbatches([ref, text])


@pytest.fixture(scope="module")
def tiny_params():
    return tparams.init(ttiny(), torch.Generator().manual_seed(0),
                        torch.float32, device="cpu")


def test_trainer_builds_the_mix_steps_and_resumes(train_root, tiny_params,
                                                  tmp_path):
    """Trainer(dataset=None) builds the registry's mix from its
    TrainConfig, takes a step of 2 micro-batches of 2 with a finite loss
    and writes a checkpoint; a second Trainer resumes from it."""
    out = str(tmp_path / "out")
    tc = TrainConfig(train_datasets=MIX, data_root=train_root,
                     output_dir=out, per_device_batch_size=2,
                     grad_accum_steps=2, max_steps=1, warmup_steps=1,
                     save_steps=1, log_steps=1)
    trainer = Trainer(ttiny(), tc, tiny_params, device="cpu")
    want = jregistry.build_train_datasets(MIX, train_root, jtiny())
    assert [(type(d).__name__, len(d)) for d in
            trainer.loader.dataset.datasets] == \
        [(type(d).__name__, len(d)) for d in want.datasets]
    assert trainer.loader.collate.roi is False
    state = trainer.train()
    assert state.step == 1
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert np.isfinite(rec["loss"]) and rec["step"] == 1
    assert checkpoint.latest_checkpoint(out)
    tc2 = TrainConfig(**{**tc.__dict__, "max_steps": 2})
    trainer2 = Trainer(ttiny(), tc2, tiny_params, device="cpu")
    assert trainer2.state.step == 1
    assert trainer2.train().step == 2


def test_trainer_roi_collates_boxes(train_root, tiny_params, tmp_path):
    """With roi and no_mask, the inverse reader gives boxes and no mask,
    and the Trainer's collator hands the boxes on (roi_boxes, ref_valid),
    not crops."""
    tc = TrainConfig(train_datasets="refer_seg_inv_refcoco",
                     data_root=train_root, output_dir=str(tmp_path),
                     per_device_batch_size=2, grad_accum_steps=1,
                     max_steps=1, roi=True, no_mask=True, resume=False)
    trainer = Trainer(ttiny(), tc, tiny_params, device="cpu")
    assert trainer.loader.collate.roi is True
    batch = next(iter(trainer.loader))
    assert "roi_boxes" in batch and "ref_images" not in batch
    assert batch["ref_valid"].all() and (batch["roi_boxes"] > 0).any()
    assert not batch["mask_valid"].any()
    assert trainer.train().step == 1


def test_train_cli_writes_merged_params(train_root, tmp_path, monkeypatch,
                                        capsys):
    """--preset tiny --device cpu, assemble_pretrained patched to a random
    tiny init (no released checkpoint here, as in tests/test_cli.py's
    test_train_cli): one step, then <output_dir>/merged.pt that
    load_params reads, with the LoRA folded in."""
    seen = {}

    def fake_assemble(cfg, **kw):
        seen.update(kw, audio=cfg.audio)
        return tparams.init(cfg, torch.Generator().manual_seed(1),
                            torch.float32, device=kw["device"])

    monkeypatch.setattr(checkpoint, "assemble_pretrained", fake_assemble)
    out_dir = str(tmp_path / "out")
    path = ttrain_cli.main(
        ["--preset", "tiny", "--device", "cpu", "--train_datasets",
         "refer_seg_refcoco", "--data_root", train_root, "--output_dir",
         out_dir, "--max_steps", "1", "--grad_accum_steps", "1",
         "--per_device_batch_size", "1", "--save_steps", "1",
         "--warmup_steps", "1", "--encoder_path", "unfused"])
    assert path == os.path.join(out_dir, "merged.pt")
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {path}"
    assert seen["device"] == "cpu" and seen["audio"] is None
    assert seen["llava_dir"] == "LLaVA-Lightning-7B-v1-1"
    params = checkpoint.load_params(path, device="cpu")
    assert set(params) >= {"llama", "sam", "clip", "mm_projector"}
    assert checkpoint.latest_checkpoint(out_dir)


def test_train_cli_audio_follows_the_mix(monkeypatch):
    """The audio tower is assembled for an AVS mix or --add_audio_encoder
    only, as in the JAX CLI."""
    seen = []

    def stop(cfg, **kw):
        seen.append(cfg.audio is not None)
        raise SystemExit

    monkeypatch.setattr(checkpoint, "assemble_pretrained", stop)
    for argv in ([], ["--train_datasets", "avs_object"],
                 ["--add_audio_encoder"]):
        with pytest.raises(SystemExit):
            ttrain_cli.main(["--preset", "tiny", "--device", "cpu", *argv])
    assert seen == [False, True, True]


def test_build_ref_index_cli_matches_jax(train_root, tmp_path, monkeypatch,
                                         capsys):
    """The port's CLI writes the JAX CLI's JSON and prints its line."""
    args = ["--image_root", os.path.join(train_root, "coco", "train2017"),
            "--json_file", os.path.join(train_root, "coco", "annotations",
                                        "instances_train2017.json"),
            "--box_img_threshold", "0.05", "--mask_box_threshold", "0.25"]
    tindex_cli.main(args + ["--out", str(tmp_path / "t.json")])
    got = capsys.readouterr().out.splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["build_ref_index.py", *args, "--out",
                                      str(tmp_path / "j.json")])
    runpy.run_path(str(ROOT / "tools" / "build_ref_index.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()[-1]
    assert got.replace("t.json", "j.json") == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text())
