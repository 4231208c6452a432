"""The port's region-caption eval against the JAX package's, on the CPU: the
caption parser (eval/scene_graph.py), the four caption metrics
(eval/caption_metrics.py), evaluate_refer_inverse under a stub predictor
and through real Predictors at anyref_tiny, and the eval CLI's refer_inv.

Tolerances: none. The parser, the metrics and the harness are pure Python
over the same strings in both packages, so every output is equal, floats
bit for bit. nltk is installed here without its WordNet corpus, so METEOR
and SPICE stem with nltk's PorterStemmer and match without synonyms; a
WordNet stub monkeypatched into both packages exercises the synonym paths.
With synonyms, SPICE's greedy tuple match differs on purpose where a tuple
has two synonym partners (a tie): the port walks sorted tuples, the JAX
module hash-ordered sets, so the two are held equal where no tie exists
and the port is held to one answer under two PYTHONHASHSEEDs."""

import builtins
import json
import math
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anyref_tpu.config import anyref_tiny as jtiny
from anyref_tpu.eval import caption_metrics as jcm
from anyref_tpu.eval import harnesses as jharn
from anyref_tpu.eval import runner as jrunner
from anyref_tpu.eval import scene_graph as jsg
from anyref_tpu.models import anyref as janyref
from anyref_tpu.tokenizer import AnyRefTokenizer as JTokenizer
from anyref_tpu_torch import checkpoint
from anyref_tpu_torch import params as tparams
from anyref_tpu_torch.config import anyref_tiny as ttiny
from anyref_tpu_torch.eval import caption_metrics as tcm
from anyref_tpu_torch.eval import harnesses as tharn
from anyref_tpu_torch.eval import runner as trunner
from anyref_tpu_torch.eval import scene_graph as tsg
from anyref_tpu_torch.tokenizer import AnyRefTokenizer as TTokenizer
from anyref_tpu_torch.tools import eval as teval_cli

import chip_smoke

from .test_caption_metrics import HYPS, REFS
from .test_torch_references import jax_towers

ROOT = pathlib.Path(__file__).resolve().parent.parent
MNT = 4
BUCKETS = (384,)
SLICE_SWITCHES = ("ANYREF_FUSED_WINDOW_BLOCK", "ANYREF_FUSED_GLOBAL_BLOCK",
                  "ANYREF_QKV_WINDOW_KERNEL", "ANYREF_QKV_MHA_KERNEL")

# the corpus' vocabulary: the parser's word classes and open-class words
# it has to guess (plural verbs, -ed / -ing forms, -ly adverbs, suffixes)
DETS = ("a", "an", "the", "this", "two", "some", "his", "each")
ADJS = ("red", "big", "small", "wooden", "young", "striped", "left",
        "shiny", "colorful", "leafy", "dangerous", "furry")
NOUNS = ("cat", "dog", "man", "woman", "girl", "car", "automobile", "table",
         "field", "court", "tennis", "horse", "ball", "tree", "building",
         "shirt", "puppy", "person", "bowl", "fruit", "painting", "bus",
         "sky", "plate", "umbrella")
VERBS = ("standing", "sitting", "holding", "riding", "wearing", "walks",
         "runs", "chases", "parked", "looking", "jumped", "grazing",
         "eating", "carrying")
PREPS = ("on", "in", "near", "next to", "on top of", "in front of",
         "behind", "with", "under", "across", "out of", "in the middle of")
OTHER = ("is", "are", "and", ",", ".", "very", "slowly", "it", "there",
         "which", "looks", "was")
WORDS = DETS + ADJS + NOUNS + VERBS + PREPS + OTHER
# WordNet stub: each word's synonyms (lemma names), used for both packages
SYNONYMS = ({"car", "automobile", "auto"}, {"dog", "puppy", "pup"},
            {"man", "person", "guy"}, {"big", "large"}, {"small", "little"},
            {"ride", "sit"}, {"shirt", "top"})
# and, as WordNet's lemma sets can be, a relation that is not transitive:
# fox ~ lion, fox ~ wolf, hen ~ lion, but hen !~ wolf, so the greedy match
# of "a fox and a hen" against "a lion and a wolf" counts 1 or 2 by order
LEMMAS = {"fox": {"fox", "lion", "wolf"}, "hen": {"hen", "lion"}}


def _np_phrase(rng):
    parts = [str(rng.choice(DETS))]
    parts += [str(a) for a in rng.choice(ADJS, int(rng.integers(0, 3)))]
    if rng.random() < 0.3:
        parts.append(str(rng.choice(NOUNS)))       # a compound modifier
    parts.append(str(rng.choice(NOUNS)))
    return parts


def _caption(rng):
    """A caption-like sentence (NP, then a verb, a preposition or a copula
    and an NP or an adjective), or, one time in five, a bag of random
    words."""
    if rng.random() < 0.2:
        return " ".join(str(w) for w in rng.choice(
            WORDS, int(rng.integers(1, 10))))
    words = _np_phrase(rng)
    for _ in range(int(rng.integers(1, 3))):
        r = rng.random()
        if r < 0.35:
            words.append(str(rng.choice(VERBS)))
            if rng.random() < 0.6:
                words += _np_phrase(rng)
        elif r < 0.75:
            words.append(str(rng.choice(PREPS)))
            words += _np_phrase(rng)
        else:
            words.append(str(rng.choice(("is", "are"))))
            words.append(str(rng.choice(ADJS)))
    if rng.random() < 0.2:
        words.insert(int(rng.integers(1, len(words))), ",")
    return " ".join(words) + ("." if rng.random() < 0.5 else "")


def _synonym(rng, word):
    group = next((g for g in SYNONYMS if word in g), None)
    return str(rng.choice(sorted(group))) if group else word


def _corpus(seed=0, n=200):
    """(hypotheses, references): ``n`` drawn captions, each with 1-3
    references, about one in three of them the hypothesis with a word
    swapped and one in four with words put for their SYNONYMS, plus tests/test_caption_metrics.py's sentences and a few
    edge cases (empty, one word, punctuation only)."""
    rng = np.random.default_rng(seed)
    hyps, refs = [], []
    for _ in range(n):
        h = _caption(rng)
        rs = []
        for _ in range(int(rng.integers(1, 4))):
            r = rng.random()
            w = h.split()
            if r < 0.35:
                w[int(rng.integers(0, len(w)))] = str(rng.choice(WORDS))
                rs.append(" ".join(w))
            elif r < 0.6:
                rs.append(" ".join(_synonym(rng, x) for x in w))
            else:
                rs.append(_caption(rng))
        hyps.append(h)
        refs.append(rs)
    hyps += list(HYPS) + ["", "cat", ", .", "the cat is black"]
    refs += list(REFS) + [["a cat"], ["cat"], ["a dog"], ["a black cat"]]
    return hyps, refs


CORPUS = _corpus()


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------
def test_parser_matches_jax():
    """tokenize, tag, the multiword prepositions and parse_tuples (with
    the identity and with the Porter stem) on every caption."""
    hyps, refs = CORPUS
    sents = hyps + [r for rs in refs for r in rs]
    assert len(sents) > 400
    n_tuples = 0
    for s in sents:
        toks = tsg.tokenize(s)
        assert toks == jsg.tokenize(s)
        tags = tsg.tag(toks)
        assert tags == jsg.tag(toks)
        assert tsg._merge_mwe_preps(toks, tags) == \
            jsg._merge_mwe_preps(toks, tags)
        assert tsg.parse_tuples(s) == jsg.parse_tuples(s)
        got = tsg.parse_tuples(s, stem=tcm._stem)
        assert got == jsg.parse_tuples(s, stem=jcm._stem)
        n_tuples += len(got)
    assert n_tuples > 2000


def test_parser_word_lists_are_the_jax_lists():
    for name in ("_DET", "_COP", "_PRON", "_CONJ", "_NUM_WORDS", "_PREP",
                 "_MWE_PREP", "_ADJ", "_VERB", "_ING_NOUNS", "_STOP_CAPTION"):
        assert getattr(tsg, name) == getattr(jsg, name), name


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------
def test_metrics_match_jax():
    """Corpus BLEU-1..4, CIDEr-D, METEOR and SPICE, and per caption METEOR
    and SPICE, equal to the JAX package's bit for bit."""
    hyps, refs = CORPUS
    for n in (1, 2, 3, 4):
        assert tcm.bleu_n(hyps, refs, n) == jcm.bleu_n(hyps, refs, n)
    assert tcm.bleu_n(hyps, refs, 4) > 0
    assert tcm.cider_d(hyps, refs) == jcm.cider_d(hyps, refs) > 0
    assert tcm.meteor(hyps, refs) == jcm.meteor(hyps, refs) > 0
    assert tcm.spice(hyps, refs) == jcm.spice(hyps, refs) > 0
    per = [(tcm.meteor([h], [r]), tcm.spice([h], [r]))
           for h, r in zip(hyps, refs)]
    assert per == [(jcm.meteor([h], [r]), jcm.spice([h], [r]))
                   for h, r in zip(hyps, refs)]
    assert len({s for _, s in per}) > 20
    # the CIDEr-D document frequencies come from the corpus: a subset
    # scores otherwise, the same in both
    assert tcm.cider_d(hyps[:17], refs[:17]) == \
        jcm.cider_d(hyps[:17], refs[:17])


def _stub_lemmas(tok):
    """LEMMAS, else a word's synonym group with the group's Porter stems
    (SPICE looks up stemmed tuple slots), else the word alone."""
    if tok in LEMMAS:
        return frozenset(LEMMAS[tok])
    for group in SYNONYMS:
        forms = group | {tcm._stem(w) for w in group}
        if tok in forms:
            return frozenset(forms)
    return frozenset((tok,))


@pytest.fixture
def wordnet_stub(monkeypatch):
    """Both packages' WordNet lookups answer from SYNONYMS."""
    for mod in (tcm, jcm):
        monkeypatch.setattr(mod, "_wn_lemmas", _stub_lemmas)
        monkeypatch.setattr(mod, "_WN_STATE", [True])


def _has_tie(ht, rt):
    """True where the greedy synonym match can depend on the order: a
    hypothesis tuple with two unmatched synonym partners, or a reference
    tuple that two hypothesis tuples could take."""
    cands = {t: {u for u in rt - ht if tcm._tuples_match(t, u)}
             for t in ht - rt}
    taken = [u for c in cands.values() for u in c]
    return any(len(c) > 1 for c in cands.values()) or \
        len(taken) != len(set(taken))


def _tie_cases():
    """(hypothesis, references) pairs whose tuples tie under the stub."""
    return [("a fox and a hen", ["a lion and a wolf"]),
            ("a man riding a car", ["a person riding an automobile",
                                    "a guy riding an auto"]),
            ("the big dog and the small puppy", ["a large pup"]),
            ("a man in a shirt", ["a person in a top", "a guy"])]


def test_metrics_with_wordnet_stub_match_jax(wordnet_stub):
    """With synonyms: METEOR equal everywhere; SPICE equal on every
    caption without a tie, and synonyms change SPICE on some of them."""
    hyps, refs = CORPUS
    assert tcm.meteor(hyps, refs) == jcm.meteor(hyps, refs)
    no_tie = moved = ties = 0
    for h, rs in zip(hyps, refs):
        ht = tcm._spice_tuples(h)
        rt = set().union(*(tcm._spice_tuples(r) for r in rs))
        got = tcm.spice([h], [rs])
        if _has_tie(ht, rt):
            ties += 1
            continue
        no_tie += 1
        assert got == jcm.spice([h], [rs]), (h, rs)
        if ht and rt:
            moved += len(ht & rt) != round(got * (len(ht) + len(rt)) / 2)
    assert no_tie > 150 and moved > 5
    for h, rs in _tie_cases():
        ht = tcm._spice_tuples(h)
        assert _has_tie(ht, set().union(*(tcm._spice_tuples(r)
                                          for r in rs))), h
    assert tcm._wn_lemmas("car") == _stub_lemmas("car")


def _spice_in_subprocess(package, cases, hash_seed):
    """SPICE of each (hypothesis, references) under the WordNet stub, by
    ``package``'s caption_metrics in a fresh interpreter."""
    code = (
        "import json, sys\n"
        f"from {package}.eval import caption_metrics as cm\n"
        f"groups = [frozenset(g) for g in {[sorted(g) for g in SYNONYMS]!r}]\n"
        "groups = [g | {cm._stem(w) for w in g} for g in groups]\n"
        f"lemmas = {{k: frozenset(v) for k, v in {LEMMAS!r}.items()}}\n"
        "def stub(tok):\n"
        "    if tok in lemmas:\n"
        "        return lemmas[tok]\n"
        "    return next((g for g in groups if tok in g), frozenset((tok,)))\n"
        "cm._wn_lemmas = stub\n"
        "cm._WN_STATE[0] = True\n"
        f"cases = json.loads({json.dumps(cases)!r})\n"
        "print(json.dumps([cm.spice([h], [r]) for h, r in cases]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT),
                                JAX_PLATFORMS="cpu",
                                PYTHONHASHSEED=str(hash_seed)))
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_spice_with_ties_is_the_same_under_two_hash_seeds(wordnet_stub):
    """The port's SPICE on tying captions, under the stub, in two fresh
    interpreters with PYTHONHASHSEED 0 and 1: one answer. The JAX module
    scores the non-transitive tie 0.5 under one seed and 1.0 under the
    other (its greedy match walks hash-ordered sets); the port walks the
    tuples sorted and scores 0.5 under both."""
    hyps, refs = CORPUS
    cases = _tie_cases() + list(zip(hyps[:60], refs[:60]))
    got = [_spice_in_subprocess("anyref_tpu_torch", cases, s)
           for s in (0, 1)]
    assert got[0] == got[1]
    assert got[0] == [tcm.spice([h], [r]) for h, r in cases]
    assert got[0][0] == 0.5
    fox = cases[:1]
    assert {_spice_in_subprocess("anyref_tpu", fox, s)[0]
            for s in (0, 1)} == {0.5, 1.0}


@pytest.fixture
def no_nltk(monkeypatch):
    """nltk cannot be imported, and neither package holds a stemmer."""
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.startswith("nltk"):
            raise ImportError("nltk blocked")
        return real_import(name, *a, **k)

    for mod in (tcm, jcm):
        monkeypatch.setattr(mod, "_STEMMER", None)
        monkeypatch.setattr(mod, "_STEM_CACHE", {})
    monkeypatch.setattr(builtins, "__import__", blocked)


def test_meteor_and_spice_raise_without_nltk(no_nltk):
    for mod in (tcm, jcm):
        with pytest.raises(ImportError):
            mod.meteor(["a cat"], [["a cat"]])
        with pytest.raises(ImportError):
            mod.spice(["a cat"], [["a cat"]])
    assert tcm.bleu_n(["a cat sat"], [["a cat sat"]], 2) == 1.0


# ---------------------------------------------------------------------------
# the harness under a stub predictor
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """chip_smoke's data roots at a small size: 4 refCOCO val refs on 2
    images, two sentences each."""
    root = str(tmp_path_factory.mktemp("eval_root"))
    chip_smoke.write_eval_root(root, (48, 64), 2)
    return root


class CaptionStub:
    """A caption from a seed and each row's metadata, as byte-level ids
    (the tokenizer's fallback: a byte b is id b + 3): the start of one of
    the ref's sentences, one word in two replaced, an EOS (2) the harness
    drops, then padding."""

    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.device = "cpu"
        self.seed = seed
        self.batches = []

    def predict(self, batch):
        self.batches.append(batch)
        rows = []
        for m in batch["_meta"]:
            # the image's name, not its path: the data root is a
            # temporary directory whose name changes from run to run
            key = (f"{self.seed}|{os.path.basename(m['file_name'])}|"
                   f"{m['sentence']}")
            rng = np.random.default_rng(zlib.crc32(key.encode()))
            words = str(rng.choice(m["sentence"])).split()
            if rng.random() < 0.5:
                words[int(rng.integers(0, len(words)))] = str(
                    rng.choice(NOUNS))
            words = words[:int(rng.integers(2, len(words) + 1))]
            text = " ".join(words) + "."
            rows.append([b + 3 for b in text.encode()] + [2])
        width = max(len(r) for r in rows) + 3
        return (np.stack([np.pad(np.asarray(r, np.int32), (0, width - len(r)))
                          for r in rows]), [None] * len(rows))


def _stub_runs(eval_root, out, roi, limit=None):
    got = tharn.evaluate_refer_inverse(
        CaptionStub(ttiny()), TTokenizer(), eval_root, "refcoco", "val",
        roi=roi, out_root=str(out / "t"), limit=limit,
        timings=(timings := {}))
    want = jharn.evaluate_refer_inverse(
        CaptionStub(jtiny()), JTokenizer(), eval_root, "refcoco", "val",
        roi=roi, out_root=str(out / "j"), limit=limit)
    return got, want, timings


def _inv_txt(out, pkg):
    return (out / pkg / "refcoco" / "val" / "inv_result.txt").read_bytes()


@pytest.mark.parametrize("roi", [False, True])
def test_stub_evaluate_refer_inverse_matches_jax(eval_root, tmp_path, roi):
    """The same captions through both harnesses, with crops or boxes:
    equal result dicts and inv_result.txt files; the port's timings."""
    got, want, timings = _stub_runs(eval_root, tmp_path, roi)
    assert got == want
    assert got["n"] == 4 and got["bleu4"] > 0 and got["cider"] > 0
    assert 0 < got["meteor"] <= 1 and 0 < got["spice"] <= 1
    assert _inv_txt(tmp_path, "t") == _inv_txt(tmp_path, "j")
    assert set(timings) == {"loader_s", "predict_s", "score_s"}
    assert all(v >= 0 for v in timings.values())
    # a second run appends a line
    _stub_runs(eval_root, tmp_path, roi)
    assert _inv_txt(tmp_path, "t").count(b"\n") == 2


def test_stub_evaluate_refer_inverse_reference_kinds(eval_root, tmp_path):
    """Crops without roi, boxes (and no crop) with it, in every batch."""
    for roi, key in ((False, "ref_images"), (True, "roi_boxes")):
        stub = CaptionStub(ttiny())
        tharn.evaluate_refer_inverse(stub, TTokenizer(), eval_root,
                                     "refcoco", "val", roi=roi, limit=2,
                                     out_root=str(tmp_path))
        assert len(stub.batches) == 2
        for b in stub.batches:
            assert key in b and b["ref_valid"].all()
            assert ("ref_images" in b) != ("roi_boxes" in b)


def test_stub_evaluate_refer_inverse_limit_matches_jax(eval_root, tmp_path):
    got, want, _ = _stub_runs(eval_root, tmp_path, False, limit=3)
    assert got == want and got["n"] == 3


def test_stub_evaluate_refer_inverse_without_nltk(eval_root, tmp_path,
                                                  no_nltk):
    """Without nltk both harnesses warn and report METEOR and SPICE as NaN;
    BLEU and CIDEr-D as before."""
    with pytest.warns(UserWarning, match="nltk unavailable"):
        got, want, _ = _stub_runs(eval_root, tmp_path, False)
    assert math.isnan(got["meteor"]) and math.isnan(got["spice"])
    assert math.isnan(want["meteor"]) and math.isnan(want["spice"])
    assert {k: v for k, v in got.items() if k not in ("meteor", "spice")} \
        == {k: v for k, v in want.items() if k not in ("meteor", "spice")}
    assert _inv_txt(tmp_path, "t") == _inv_txt(tmp_path, "j")
    assert b"NaN" in _inv_txt(tmp_path, "t")


# ---------------------------------------------------------------------------
# end to end at anyref_tiny, and the CLI
# ---------------------------------------------------------------------------
@pytest.fixture
def unfused(monkeypatch):
    for name in SLICE_SWITCHES:
        monkeypatch.setenv(name, "0")


def test_evaluate_refer_inverse_matches_jax(unfused, eval_root, tmp_path):
    """Real Predictors on the same tiny weights (the JAX init of key 1,
    bridged) on "unfused", 2 refs with crops: equal greedy ids, so equal
    captions and metrics. The port's CLIP returns the JAX CLIP's fp32
    output (tests/test_torch_references.py's jax_towers): at random tiny
    weights CLIP's sums in another order flip a near-tied token."""
    cfg = jtiny()
    jp = janyref.init(jax.random.key(1), cfg, dtype=jnp.float32)
    tp = tparams.from_numpy(jax.device_get(jp), device="cpu")
    record = chip_smoke.RecordingPredictor
    jrec = record(jrunner.Predictor(jp, cfg, max_new_tokens=MNT,
                                    prompt_buckets=BUCKETS))
    trec = record(trunner.Predictor(tp, ttiny(), max_new_tokens=MNT,
                                    prompt_buckets=BUCKETS, device="cpu",
                                    encoder_path="unfused"))
    want = jharn.evaluate_refer_inverse(jrec, JTokenizer(), eval_root,
                                        "refcoco", "val",
                                        out_root=str(tmp_path / "j"),
                                        limit=2)
    with jax_towers(jp, cfg, "unfused") as calls:
        got = tharn.evaluate_refer_inverse(trec, TTokenizer(), eval_root,
                                           "refcoco", "val",
                                           out_root=str(tmp_path / "t"),
                                           limit=2)
    assert calls == [1, 1, 1, 1]        # the image and the crop, 2 refs
    assert len(jrec.calls) == len(trec.calls) == 2
    for (ji, _), (ti, _) in zip(jrec.calls, trec.calls):
        np.testing.assert_array_equal(ti, ji)
    assert got == want and got["n"] == 2


def test_cli_refer_inv_matches_in_process(eval_root, tmp_path, capsys):
    """--preset tiny --device cpu --roi --limit 2 on a saved tiny
    checkpoint prints what evaluate_refer_inverse gives in process on the
    same weights at the CLI's refer_inv rephrase weight, 0.0."""
    cfg = ttiny()
    p = tparams.init(cfg, torch.Generator().manual_seed(0), torch.float32,
                     device="cpu")
    ckpt = str(tmp_path / "tiny.pt")
    checkpoint.save_params(ckpt, p)
    res = teval_cli.main(["refer_inv", "--ckpt", ckpt, "--data_root",
                          eval_root, "--out_root", str(tmp_path / "cli"),
                          "--inv_dataset", "refcoco", "--split", "val",
                          "--roi", "--preset", "tiny", "--device", "cpu",
                          "--limit", "2", "--max_new_tokens", "3"])
    printed = capsys.readouterr().out.splitlines()[-1]
    assert printed == repr(res)
    pred = trunner.Predictor(p, cfg.scaled(rephrase_weight=0.0),
                             max_new_tokens=3, device="cpu")
    want = tharn.evaluate_refer_inverse(pred, TTokenizer(), eval_root,
                                        "refcoco", "val", roi=True,
                                        out_root=str(tmp_path / "in"),
                                        limit=2)
    assert res == want and res["n"] == 2
    assert (tmp_path / "cli" / "refcoco" / "val" / "inv_result.txt").exists()


def test_follow_ids_makes_the_cpu_emit_given_ids(eval_root, tmp_path):
    """chip_smoke.FollowIds, which holds the card's inverse eval against
    the CPU: with it in place of llama.logits the CPU's greedy decode emits
    the given ids (up to the first EOS), and each step's gap is the CPU's
    top logit less the given token's, 0 where they agree."""
    from anyref_tpu_torch.models import llama
    cfg = ttiny()
    p = tparams.init(cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                     device="cpu")
    rng = np.random.default_rng(0)
    given = [rng.integers(3, 259, (1, 6)) for _ in range(2)]
    given[1][0, 3] = 2
    follow = chip_smoke.FollowIds(torch, llama.logits)
    pred = chip_smoke.RecordingPredictor(trunner.Predictor(
        p, cfg, max_new_tokens=6, device="cpu", encoder_path="unfused"))
    rows = iter(given)
    inner = pred.predict

    def predict(batch):
        follow.start(next(rows))
        return inner(batch)

    pred.predict = predict
    llama.logits = follow
    try:
        res = tharn.evaluate_refer_inverse(pred, TTokenizer(), eval_root,
                                           "refcoco", "val", limit=2,
                                           out_root=str(tmp_path))
    finally:
        llama.logits = follow.real
    want = [g.copy() for g in given]
    want[1][0, 4:] = 2
    for (ids, _), w in zip(pred.calls, want):
        np.testing.assert_array_equal(ids, w)
    assert len(follow.gaps) == 6 + 4 and min(follow.gaps) >= 0
    assert max(follow.gaps) > 0 and res["n"] == 2
