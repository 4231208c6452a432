"""Caption scene-graph parser for SPICE tuple extraction (port of
anyref_tpu/eval/scene_graph.py: the same rules and word lists).

The reference scores region captions with pycocoevalcap's SPICE
(``eval_refer_inv.py:204-211``), which runs the Stanford Scene Graph
Parser (Schuster et al. 2015) over a CoreNLP dependency parse and scores
F1 over the extracted (object) / (object, attribute) /
(subject, relation, object) tuples (Anderson et al. 2016). Neither the
Java jar nor a pretrained parser is available in this environment, so this
module implements the same pipeline natively for the caption domain:

    tokenize -> POS tag (closed-class lexicons + morphology)
             -> NP chunk (DET? NUM? (ADJ|VPART|NOUN)* head-NOUN)
             -> clause rules (copula, verb, preposition attachment)
             -> semantic tuples

The rules mirror what the scene-graph parser produces on caption-style
English (short declarative noun phrases with locative prepositions):

    objects     every NP head noun                      -> (head,)
    compounds   noun-noun compounds ("tennis court")    -> (head, modifier)
    attributes  attributive ADJ / participle / number   -> (head, adj)
                predicative "NP is ADJ"                 -> (subj, adj)
                bare verb / participle after NP         -> (subj, verb)
    relations   NP-PREP-NP (incl. multiword preps)      -> (gov, prep, head)
                NP-VERB-NP                              -> (subj, verb, obj)
                verb + prep ("standing on top of X")    -> (subj, prep, X)

Worked example (the SPICE paper's figure 1 caption): "a young girl
standing on top of a tennis court" parses to {(girl), (girl, young),
(girl, stand), (court), (court, tennis), (girl, on top of, court)} —
exactly the paper's tuple set.

Content words are Porter-stemmed (SPICE lemmatizes; on caption vocabulary
the stem and the lemma agree for matching purposes because both sides of
the comparison go through the same normalizer). Remaining deviation vs the
Java pipeline: the tagger/chunker is a caption-domain rule grammar, not a
trained parser, so garden-path or deeply nested sentences can mis-attach a
PP; and SPICE's WordNet synset merging is applied only when nltk's wordnet
corpus is installed (see ``caption_metrics.spice``), else matching is
stem-exact.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# POS lexicons (closed classes + the open-class words captions actually use)
# ---------------------------------------------------------------------------

_DET = frozenset(
    "a an the this that these those some any no every each all both another"
    " his her its their our my your".split())
_COP = frozenset("is are was were be been being am 's seems seem looks"
                 " look appears appear".split())
_PRON = frozenset("it he she they we i you him her them us me who which"
                  " that there".split())
_CONJ = frozenset("and or but while".split())
_NUM_WORDS = frozenset(
    "one two three four five six seven eight nine ten eleven twelve dozen"
    " several few many couple".split())

_PREP = frozenset(
    "in on at by with near above below behind beside between across along"
    " around inside outside against atop beneath underneath under over"
    " toward towards from into onto of for to off up down through past"
    " without upon amid among".split())
# multiword prepositions, longest-first (matched greedily over raw tokens)
_MWE_PREP = (
    ("in", "the", "middle", "of"), ("on", "the", "side", "of"),
    ("in", "front", "of"), ("on", "top", "of"), ("next", "to"),
    ("close", "to"), ("out", "of"), ("in", "between"), ("far", "from"),
)

# caption-frequent adjectives (colors, sizes, materials, states)
_ADJ = frozenset(
    "red blue green yellow orange purple pink black white gray grey brown"
    " tan beige golden silver dark light bright colorful big small large"
    " little tiny huge tall short long wide narrow thin thick old young new"
    " wooden metal plastic glass stone brick leather furry fluffy empty"
    " full open closed round square flat sharp left right upper lower"
    " front back middle top bottom near far distant blurry clear shiny"
    " dirty clean wet dry hot cold warm happy sad cute pretty beautiful"
    " ugly fat skinny striped spotted checkered plaid floral leafy grassy"
    " snowy sunny cloudy rainy busy quiet crowded lone single double"
    " second third first last other same different several main baby adult"
    " male female".split())

# caption-frequent verb BASE forms (morphology maps -s/-ing/-ed onto these)
_VERB = frozenset(
    "stand sit hold wear ride look walk run play eat drink jump fly park"
    " lean hang rest graze watch carry drive swim surf ski skate throw"
    " catch cut pose smile laugh point reach climb read talk wait cross"
    " feed kick hit swing serve brush pull push open close cover fill lie"
    " lay face perch stare gaze grab touch lift bend kneel crouch stretch"
    " sleep land take make do go come move turn use give get put see show"
    " contain include surround overlook travel race chase follow lead"
    " pass land float sail row paddle pedal cook bake slice chop peel"
    " pour wash dress smoke type write draw paint decorate".split())
# -ing words that are NOUNS in captions, not participles
_ING_NOUNS = frozenset(
    "building painting ceiling clothing lightning morning evening railing"
    " awning icing frosting dressing landing crossing drawing setting"
    " living dining wedding parking siding carving topping clearing"
    " king ring spring string wing thing something everything nothing"
    " anything duckling seedling sibling darling dumpling".split())

_STOP_CAPTION = frozenset("very really quite so such just also too only"
                          " well even still".split())


def tokenize(s: str) -> List[str]:
    out: List[str] = []
    for raw in s.lower().replace(",", " , ").replace(".", " ").split():
        tok = raw.strip("\"'`;:!?()[]")
        if tok:
            out.append(tok)
    return out


def _base_of(tok: str) -> str:
    """Candidate verb base forms for morphological verb detection."""
    cands = [tok]
    for suf, rep in (("ies", "y"), ("es", ""), ("s", ""), ("ing", ""),
                     ("ing", "e"), ("ed", ""), ("ed", "e")):
        if tok.endswith(suf) and len(tok) > len(suf) + 1:
            stem = tok[: len(tok) - len(suf)] + rep
            cands.append(stem)
            if len(stem) > 2 and stem[-1] == stem[-2]:   # sitting -> sit
                cands.append(stem[:-1])
    return next((c for c in cands if c in _VERB), "")


def tag(tokens: Sequence[str]) -> List[str]:
    """POS-lite tags: DET NUM ADJ NOUN VERB VPART COP PREP PRON CONJ ADV
    PUNCT. Closed classes first, then morphology, default NOUN."""
    tags = []
    for tok in tokens:
        if tok == ",":
            t = "PUNCT"
        elif tok in _DET:
            t = "DET"
        elif tok in _COP:
            t = "COP"
        elif tok in _CONJ:
            t = "CONJ"
        elif tok in _PRON:
            t = "PRON"
        elif tok in _PREP:
            t = "PREP"
        elif tok in _NUM_WORDS or tok.replace("-", "").isdigit():
            t = "NUM"
        elif tok in _ADJ:
            t = "ADJ"
        elif tok in _STOP_CAPTION:
            t = "ADV"
        elif tok.endswith("ing") and tok not in _ING_NOUNS and (
                _base_of(tok) or len(tok) > 6):
            t = "VPART"
        elif tok.endswith("ed") and _base_of(tok):
            t = "VPART"
        elif _base_of(tok) == tok or (tok.endswith("s") and _base_of(tok)):
            t = "VERB"
        elif tok.endswith("ly") and len(tok) > 3:
            t = "ADV"
        elif len(tok) > 4 and tok.endswith(
                ("ous", "ful", "ish", "ive", "able", "ible", "less", "est")):
            t = "ADJ"
        else:
            t = "NOUN"
        tags.append(t)
    # contextual repair: a "verb" right after a determiner/adjective is a
    # noun ("a blue dress", "a watch") — caption noun/verb homographs
    for i in range(1, len(tags)):
        if tags[i] == "VERB" and tags[i - 1] in ("DET", "ADJ", "NUM"):
            tags[i] = "NOUN"
    return tags


def _merge_mwe_preps(tokens: List[str], tags: List[str]):
    """Collapse multiword prepositions into one PREP token ("on top of")."""
    i = 0
    out_t, out_g = [], []
    while i < len(tokens):
        hit = None
        for mwe in _MWE_PREP:
            if tuple(tokens[i:i + len(mwe)]) == mwe:
                hit = mwe
                break
        if hit:
            out_t.append(" ".join(hit))
            out_g.append("PREP")
            i += len(hit)
        else:
            out_t.append(tokens[i])
            out_g.append(tags[i])
            i += 1
    return out_t, out_g


class _NP:
    __slots__ = ("head", "adjs", "compounds", "nums")

    def __init__(self):
        self.head = ""
        self.adjs: List[str] = []
        self.compounds: List[str] = []
        self.nums: List[str] = []


def _parse_nps(tokens: List[str], tags: List[str]):
    """Chunk into a flat sequence of events:
    ('NP', _NP) | ('VERB', word) | ('PREP', word) | ('COP',) | ('CONJ',)."""
    events = []
    i = 0
    n = len(tokens)
    while i < n:
        t = tags[i]
        if t in ("DET", "NUM", "ADJ", "NOUN", "VPART"):
            # candidate NP: scan the maximal modifier+noun run; it is an NP
            # only if it contains a noun ("standing" alone is a verb event)
            j = i
            words: List[Tuple[str, str]] = []
            seen_noun = False
            while j < n and tags[j] in ("DET", "NUM", "ADJ", "NOUN",
                                        "VPART", "ADV"):
                # one NP per noun run: after the head noun(s), a DET starts a
                # new NP and a participle/adjective starts a predicate
                # ("a man riding a horse" must not chunk as one NP)
                if seen_noun and tags[j] in ("DET", "NUM", "ADJ", "VPART"):
                    break
                # a determiner can only START an NP: "riding a horse" must
                # emit the participle as a verb, not fold it into the NP
                if words and tags[j] == "DET":
                    break
                seen_noun = seen_noun or tags[j] == "NOUN"
                words.append((tokens[j], tags[j]))
                j += 1
            noun_idx = [k for k, (_, g) in enumerate(words) if g == "NOUN"]
            if not noun_idx:
                # no head noun: emit participles/verbs, drop the rest
                for w, g in words:
                    if g in ("VPART", "VERB"):
                        events.append(("VERB", w))
                i = j
                continue
            head_k = noun_idx[-1]
            np = _NP()
            np.head = words[head_k][0]
            for k, (w, g) in enumerate(words[:head_k]):
                if g == "NOUN":
                    np.compounds.append(w)
                elif g in ("ADJ", "VPART"):
                    np.adjs.append(w)
                elif g == "NUM":
                    np.nums.append(w)
            events.append(("NP", np))
            # trailing participles bind to this NP's clause ("a girl standing")
            for w, g in words[head_k + 1:]:
                if g in ("VPART", "VERB"):
                    events.append(("VERB", w))
            i = j
        elif t in ("VERB", "VPART"):
            events.append(("VERB", tokens[i]))
            i += 1
        elif t == "PREP":
            events.append(("PREP", tokens[i]))
            i += 1
        elif t == "COP":
            events.append(("COP", ""))
            i += 1
        elif t in ("CONJ", "PUNCT"):
            events.append(("CONJ", ""))
            i += 1
        else:                                   # PRON, ADV: no tuple content
            i += 1
    return events


def parse_tuples(s: str, stem=lambda w: w) -> Set[tuple]:
    """Scene-graph tuples of a caption; ``stem`` normalizes content words."""
    toks = tokenize(s)
    tokens, tags_ = _merge_mwe_preps(toks, tag(toks))
    events = _parse_nps(tokens, tags_)

    def vstem(w: str) -> str:
        return stem(_base_of(w) or w)

    tuples: Set[tuple] = set()
    subj: _NP | None = None          # clause subject (for verb/pred-adj)
    gov: _NP | None = None           # nearest NP (PP attachment site)
    pending_verb: str | None = None  # verb awaiting an object NP
    pending_prep: str | None = None  # prep awaiting its NP complement
    after_cop = False

    for ev in events:
        kind = ev[0]
        if kind == "NP":
            np: _NP = ev[1]
            h = stem(np.head)
            tuples.add((h,))
            for a in np.adjs:
                tuples.add((h, vstem(a) if _base_of(a) else stem(a)))
            for c in np.compounds:
                tuples.add((h, stem(c)))
            for m in np.nums:
                tuples.add((h, m))
            if pending_prep is not None and gov is not None:
                tuples.add((stem(gov.head), pending_prep, h))
                pending_prep = None
                # PP complement does not steal subject/governor status
            elif pending_verb is not None and subj is not None:
                tuples.add((stem(subj.head), vstem(pending_verb), h))
                pending_verb = None
                gov = np
            else:
                if subj is None or after_cop:
                    subj = np
                gov = np
            after_cop = False
        elif kind == "VERB":
            v = ev[1]
            if subj is not None:
                tuples.add((stem(subj.head), vstem(v)))
            pending_verb = v
            after_cop = False
        elif kind == "PREP":
            pending_prep = ev[1]
            pending_verb = None       # "standing on X": prep wins the object
            after_cop = False
        elif kind == "COP":
            after_cop = True
            pending_verb = None
        elif kind == "CONJ":
            pending_verb = pending_prep = None
            after_cop = False

    # predicative adjectives: "the cat is black" tags black as ADJ with no
    # following noun, so the chunker dropped it — recover from raw tags
    for k in range(1, len(tokens)):
        if tags_[k] == "ADJ" and tags_[k - 1] == "COP" and subj is not None:
            if k + 1 >= len(tokens) or tags_[k + 1] not in ("NOUN", "ADJ",
                                                            "NUM"):
                tuples.add((stem(subj.head), stem(tokens[k])))
    return tuples
