"""Caption metrics: BLEU-n, CIDEr-D, METEOR and SPICE, native
implementations (port of anyref_tpu/eval/caption_metrics.py).

Replace pycocoevalcap (reference eval_refer_inv.py:204-211; not installed
here). Standard definitions: BLEU with corpus-level brevity penalty and
clipped n-gram precision; CIDEr-D with tf-idf 1-4gram cosine similarity,
length gaussian penalty (sigma 6) and the *10 scale. METEOR and SPICE stem
with nltk's PorterStemmer, imported where first needed (an ImportError
without nltk); both use WordNet synonyms only where nltk's wordnet corpus
is installed.

One difference from the JAX module: with WordNet present, SPICE's greedy
tuple match walks the hypothesis tuples in a fixed order (exact hits
first, then sorted) and the unmatched reference tuples sorted, where the
JAX module walks Python sets, whose order follows PYTHONHASHSEED. Without
a tie (a tuple with two synonym partners) both give the same score.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _tokens(s: str) -> List[str]:
    return s.lower().strip().split()


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


def bleu_n(hypotheses: List[str], references: List[List[str]],
           n: int = 4) -> float:
    """Corpus BLEU-n with uniform weights and standard brevity penalty."""
    log_precisions = []
    hyp_len = ref_len = 0
    clipped = [0] * n
    totals = [0] * n
    for hyp, refs in zip(hypotheses, references):
        h = _tokens(hyp)
        rs = [_tokens(r) for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for k in range(1, n + 1):
            hc = _ngrams(h, k)
            if not hc:
                continue
            max_ref = Counter()
            for r in rs:
                rc = _ngrams(r, k)
                for g, c in rc.items():
                    max_ref[g] = max(max_ref[g], c)
            clipped[k - 1] += sum(min(c, max_ref.get(g, 0))
                                  for g, c in hc.items())
            totals[k - 1] += sum(hc.values())
    for k in range(n):
        if totals[k] == 0 or clipped[k] == 0:
            return 0.0
        log_precisions.append(math.log(clipped[k] / totals[k]))
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return float(bp * math.exp(sum(log_precisions) / n))


def cider_d(hypotheses: List[str], references: List[List[str]],
            n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D over the eval corpus (document frequency from the reference
    sets)."""
    # document frequencies per n
    dfs = [Counter() for _ in range(n)]
    num_docs = len(references)
    ref_counts = []
    for refs in references:
        per_ref = []
        seen = [set() for _ in range(n)]
        for r in refs:
            toks = _tokens(r)
            cs = [_ngrams(toks, k + 1) for k in range(n)]
            per_ref.append((cs, len(toks)))
            for k in range(n):
                seen[k].update(cs[k])
        for k in range(n):
            for g in seen[k]:
                dfs[k][g] += 1
        ref_counts.append(per_ref)

    def tfidf_vec(counts: Counter, k: int):
        # RAW term counts x idf, exactly pycocoevalcap's counts2vec
        # (cider_scorer.py): length-normalizing tf would flip which side
        # the min() clip picks whenever hypothesis and reference lengths
        # differ, deviating from CIDEr-D
        vec = {}
        norm = 0.0
        for g, c in counts.items():
            df = math.log(max(dfs[k][g], 1.0))
            idf = math.log(max(num_docs, 1)) - df
            w = c * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for hyp, per_ref in zip(hypotheses, ref_counts):
        htoks = _tokens(hyp)
        hlen = len(htoks)
        score = 0.0
        for k in range(n):
            hvec, hnorm = tfidf_vec(_ngrams(htoks, k + 1), k)
            s_k = 0.0
            for (rcs, rlen) in per_ref:
                rvec, rnorm = tfidf_vec(rcs[k], k)
                num = sum(min(hvec[g], rvec.get(g, 0.0)) * rvec.get(g, 0.0)
                          for g in hvec)
                denom = hnorm * rnorm
                sim = num / denom if denom > 0 else 0.0
                sim *= math.exp(-((hlen - rlen) ** 2) / (2 * sigma ** 2))
                s_k += sim
            score += s_k / max(len(per_ref), 1)
        scores.append(score / n * 10.0)
    return float(sum(scores) / max(len(scores), 1))


# ---------------------------------------------------------------------------
# METEOR (native; exact + Porter-stem modules)
# ---------------------------------------------------------------------------
_STEMMER = None
_STEM_CACHE: dict = {}


def _stem(tok: str) -> str:
    # One module-level PorterStemmer (pure-code, no corpus data) + memoized
    # stems; raises ImportError if nltk is absent — callers that can degrade
    # (evaluate_refer_inverse) catch it and NaN the meteor/spice fields.
    cached = _STEM_CACHE.get(tok)
    if cached is not None:
        return cached
    global _STEMMER
    if _STEMMER is None:
        from nltk.stem import PorterStemmer
        _STEMMER = PorterStemmer()
    out = _STEMMER.stem(tok)
    _STEM_CACHE[tok] = out
    return out


_WN_CACHE: dict = {}
_WN_STATE = [None]                            # None: untried; False: absent


def _wn_lemmas(tok: str) -> frozenset:
    """All WordNet lemma names of all synsets of ``tok`` (plus the token
    itself) — the METEOR synonym-module match set. Empty if nltk's wordnet
    corpus is unavailable (the module then degrades to exact+stem)."""
    got = _WN_CACHE.get(tok)
    if got is not None:
        return got
    if _WN_STATE[0] is False:
        return frozenset()
    try:
        from nltk.corpus import wordnet
        syns = frozenset(
            lemma.name() for ss in wordnet.synsets(tok)
            for lemma in ss.lemmas()) | frozenset((tok,))
        _WN_STATE[0] = True
    except (ImportError, LookupError):
        _WN_STATE[0] = False
        return frozenset()
    _WN_CACHE[tok] = syns
    return syns


def _meteor_align(h: List[str], r: List[str]) -> tuple:
    """Greedy three-stage alignment (exact, then Porter stem, then WordNet
    synonym — the METEOR module order), preferring the ref position that
    continues the previous match so chunks stay minimal.
    Returns (matches, chunks)."""
    hs = [_stem(t) for t in h]
    rs = [_stem(t) for t in r]
    align = [-1] * len(h)                     # hyp idx -> ref idx
    used = [False] * len(r)

    def hit(stage: int, i: int, j: int) -> bool:
        if stage == 0:
            return r[j] == h[i]
        if stage == 1:
            return rs[j] == hs[i]
        return h[i] in _wn_lemmas(r[j]) or r[j] in _wn_lemmas(h[i])

    for stage in (0, 1, 2):                   # exact, stem, wordnet-synonym
        prev = -2
        for i, tok in enumerate(h):
            if align[i] >= 0:
                prev = align[i]
                continue
            cands = [j for j in range(len(r)) if not used[j]
                     and hit(stage, i, j)]
            if not cands:
                continue
            nxt = [j for j in cands if j == prev + 1]
            j = nxt[0] if nxt else cands[0]
            align[i] = j
            used[j] = True
            prev = j
    pairs = [(i, j) for i, j in enumerate(align) if j >= 0]
    matches = len(pairs)
    chunks = 0
    for k, (i, j) in enumerate(pairs):
        if k == 0 or pairs[k - 1][0] != i - 1 or pairs[k - 1][1] != j - 1:
            chunks += 1
    return matches, chunks


def meteor(hypotheses: List[str], references: List[List[str]],
           alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5) -> float:
    """METEOR (Banerjee & Lavie): exact + Porter-stem + WordNet-synonym
    matching modules (synonym stage active when nltk's wordnet corpus is
    present, else degrades to exact+stem).

    The reference scores region captions with pycocoevalcap's METEOR-1.5 jar
    (eval_refer_inv.py:204-211). Deviation bounds vs that jar: this is the
    METEOR-1.0 scoring formula (module weights 1.0, alpha/beta/gamma
    0.9/3/0.5 — pycocoevalcap's jar runs -l en -norm with tuned weights
    alpha=0.85/beta=0.2/gamma=0.6/delta=0.75 and a paraphrase table), so
    absolute scores differ systematically (observed ~±0.05 on caption
    corpora between METEOR 1.0 and 1.5 settings) while rankings track.
    The JAX module's tests validate the same code against
    nltk.translate.meteor_score (same 1.0 formula + modules, independent
    alignment code).
    Per-sentence score = max over references; corpus score = mean.
    """
    scores = []
    for hyp, refs in zip(hypotheses, references):
        h = _tokens(hyp)
        best = 0.0
        for ref in refs:
            r = _tokens(ref)
            if not h or not r:
                continue
            m, ch = _meteor_align(h, r)
            if m == 0:
                continue
            p = m / len(h)
            rec = m / len(r)
            fmean = p * rec / (alpha * p + (1 - alpha) * rec)
            penalty = gamma * (ch / m) ** beta
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return float(sum(scores) / max(len(scores), 1))


# ---------------------------------------------------------------------------
# SPICE (scene-graph tuple F1, Anderson et al. 2016)
# ---------------------------------------------------------------------------


def _spice_tuples(s: str) -> set:
    """Scene-graph tuples via the native caption parser (scene_graph.py):
    POS tag -> NP chunk -> clause rules -> (object) / (object, attribute) /
    (subject, relation, object) tuples, content words Porter-stemmed — the
    same tuple families the reference's SPICE extracts with the Stanford
    Scene Graph Parser (pycocoevalcap, eval_refer_inv.py:204-211)."""
    from .scene_graph import parse_tuples
    return parse_tuples(s, stem=_stem)


def _tuples_match(a: tuple, b: tuple) -> bool:
    """SPICE tuple equivalence: equal length and every slot matches exactly
    or via WordNet synonymy (SPICE's synset merging; active only when
    nltk's wordnet corpus is installed — _wn_lemmas degrades to empty)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x != y and x not in _wn_lemmas(y) and y not in _wn_lemmas(x):
            return False
    return True


def spice(hypotheses: List[str], references: List[List[str]]) -> float:
    """SPICE: F1 between hypothesis scene-graph tuples and the union of
    reference tuples, averaged over the corpus (Anderson et al. 2016 —
    the scoring the reference runs via pycocoevalcap's Java pipeline,
    eval_refer_inv.py:204-211).

    Tuple extraction is the native caption parser in scene_graph.py (it
    reproduces the SPICE paper's own worked example exactly); matching
    allows WordNet synonym equivalence per slot when the wordnet corpus is
    present, else falls back to stem-exact. Deviation vs the Java
    pipeline: the tagger/chunker is a caption-domain rule grammar rather
    than a trained CoreNLP parse, so long relational or garden-path
    sentences can mis-attach a PP; on region-caption-style text (short
    noun phrases with locative preps) the extracted graphs agree."""
    scores = []
    for hyp, refs in zip(hypotheses, references):
        ht = _spice_tuples(hyp)
        rt = set().union(*(_spice_tuples(r) for r in refs)) if refs else set()
        if not ht or not rt:
            scores.append(1.0 if ht == rt else 0.0)
            continue
        if _WN_STATE[0] is not False and _wn_lemmas("cat"):
            # greedy bipartite match under synonym equivalence (exact hits
            # claimed first so a synonym never steals an exact partner)
            # in a fixed order, so the score does not depend on the sets'
            # hash order
            unmatched = set(rt)
            inter = 0
            for t in sorted(ht, key=lambda t: (t not in rt, t)):
                hit = t if t in unmatched else next(
                    (u for u in sorted(unmatched) if _tuples_match(t, u)),
                    None)
                if hit is not None:
                    unmatched.discard(hit)
                    inter += 1
        else:
            inter = len(ht & rt)
        p = inter / len(ht)
        r = inter / len(rt)
        scores.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
    return float(sum(scores) / max(len(scores), 1))
