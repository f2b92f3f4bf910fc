"""ROUGE-1/2/L F-measures with Porter stemming, the port's own.

`score(ref, hyp, kind)` equals what
`rouge_score.rouge_scorer.RougeScorer([kind], use_stemmer=True).score(ref,
hyp)[kind].fmeasure` computes, without `rouge_score` or `nltk`:

- `tokenize`: `rouge_score/tokenize.py` - lower-case, every run of
  `[^a-z0-9]` becomes a space, split on whitespace, stem the tokens longer
  than 3 characters, drop what does not match `^[a-z0-9]+$`;
- `stem`: nltk's `PorterStemmer()` in its default `NLTK_EXTENSIONS` mode
  (the mode `rouge_score/tokenizers.py` builds): the 1980 paper's steps
  1a-5b with nltk's pool of irregular forms and its departures in steps 1a
  ("ies" of a 4-letter word), 1b ("ied"), 1c (y -> i only after a
  consonant that is not the first letter), 2 ("alli" recursion, "bli",
  "fulli", "logi") and the 2-letter *o condition;
- ROUGE-N: clipped n-gram overlap, precision over max(hypothesis n-grams, 1),
  recall over max(reference n-grams, 1); ROUGE-L: the LCS length, 0 when
  either side has no tokens; F = 2pr / (p + r), or 0.

Every division and sum happens in the order `rouge_score` does it, so the
scores are equal as floats, not only close.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

_VOWELS = frozenset("aeiou")

# nltk's irregular forms (NLTK_EXTENSIONS): word -> stem.
_POOL = {
    form: key
    for key, forms in {
        "sky": ("sky", "skies"),
        "die": ("dying",),
        "lie": ("lying",),
        "tie": ("tying",),
        "news": ("news",),
        "inning": ("innings", "inning"),
        "outing": ("outings", "outing"),
        "canning": ("cannings", "canning"),
        "howe": ("howe",),
        "proceed": ("proceed",),
        "exceed": ("exceed",),
        "succeed": ("succeed",),
    }.items()
    for form in forms
}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _consonant(w: str, i: int) -> bool:
    """A letter other than a vowel, and a 'y' only after a vowel; a run of
    y's alternates, read back from i to the run's start (nltk's reading)."""
    if w[i] in _VOWELS:
        return False
    if w[i] == "y":
        negate = False
        while i > 0 and w[i] == "y":
            negate = not negate
            i -= 1
        return (w[i] not in _VOWELS) != negate
    return True


def _measure(s: str) -> int:
    """m of [C](VC)^m[V]: the number of vowel -> consonant transitions."""
    m, after_vowel = 0, False
    for i in range(len(s)):
        c = _consonant(s, i)
        m += c and after_vowel
        after_vowel = not c
    return m


def _positive(s: str) -> bool:
    return _measure(s) > 0


def _above_one(s: str) -> bool:
    return _measure(s) > 1


def _has_vowel(s: str) -> bool:
    return any(not _consonant(s, i) for i in range(len(s)))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _consonant(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: ends consonant-vowel-consonant, the last not w, x or y; or (nltk)
    a 2-letter vowel-consonant word."""
    n = len(w)
    return (
        n >= 3 and _consonant(w, n - 3) and not _consonant(w, n - 2)
        and _consonant(w, n - 1) and w[-1] not in "wxy"
    ) or (n == 2 and not _consonant(w, 0) and _consonant(w, 1))


def _apply(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix the word ends with decides: its stem plus
    the replacement when the condition holds, else the word unchanged. The
    suffix "*d" stands for a double consonant."""
    for suffix, repl, cond in rules:
        if suffix == "*d" and _double_consonant(word):
            stem = word[:-2]
        elif suffix != "*d" and word.endswith(suffix):
            stem = word[: len(word) - len(suffix)]
        else:
            continue
        return stem + repl if cond is None or cond(stem) else word
    return word


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-3] + "ie"
    return _apply(w, (("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None), ("s", "", None)))


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        return w[:-3] + "ee" if _measure(w[:-3]) > 0 else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[: -len(suffix)]):
            s = w[: -len(suffix)]
            break
    else:
        return w
    return _apply(s, (
        ("at", "ate", None),
        ("bl", "ble", None),
        ("iz", "ize", None),
        ("*d", s[-1], lambda _: s[-1] not in "lsz"),
        ("", "e", lambda stem: _measure(stem) == 1 and _cvc(stem)),
    ))


def _step1c(w: str) -> str:
    return _apply(w, (("y", "i", lambda s: len(s) > 1 and _consonant(s, len(s) - 1)),))


_STEP2 = tuple((suf, rep, _positive) for suf, rep in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"),
    ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
    ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
    ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"),
))


def _step2(w: str) -> str:
    if w.endswith("alli") and _positive(w[:-4]):
        return _step2(w[:-4] + "al")
    # nltk's "logi" rule measures the word less "ogi", not less "logi".
    return _apply(w, _STEP2 + (("logi", "log", lambda _: _positive(w[:-3])),))


_STEP3 = tuple((suf, rep, _positive) for suf, rep in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""),
))

_STEP4 = tuple(
    (suf, "", (lambda s: _measure(s) > 1 and s[-1] in "st") if suf == "ion" else _above_one)
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
                "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize")
)


def _step5a(w: str) -> str:
    if w.endswith("e"):
        s = w[:-1]
        m = _measure(s)
        if m > 1 or (m == 1 and not _cvc(s)):
            return s
    return w


def _step5b(w: str) -> str:
    return _apply(w, (("ll", "l", lambda _: _measure(w[:-1]) > 1),))


def stem(word: str) -> str:
    """nltk's `PorterStemmer().stem(word)` (NLTK_EXTENSIONS mode)."""
    w = word.lower()
    if w in _POOL:
        return _POOL[w]
    if len(word) <= 2:
        return w
    w = _step1c(_step1b(_step1a(w)))
    w = _apply(_apply(_step2(w), _STEP3), _STEP4)
    return _step5b(_step5a(w))


_NON_ALNUM = re.compile(r"[^a-z0-9]+")
_SPACES = re.compile(r"\s+")
_VALID = re.compile(r"^[a-z0-9]+$")


def tokenize(text: str) -> List[str]:
    """`rouge_score`'s tokenizer with the stemmer on."""
    tokens = _SPACES.split(_NON_ALNUM.sub(" ", text.lower()))
    tokens = [stem(t) if len(t) > 3 else t for t in tokens]
    return [t for t in tokens if _VALID.match(t)]


def _fmeasure(p: float, r: float) -> float:
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(ref: List[str], hyp: List[str], n: int) -> float:
    r, h = _ngrams(ref, n), _ngrams(hyp, n)
    overlap = 0
    for g in r:
        overlap += min(r[g], h[g])
    return _fmeasure(overlap / max(sum(h.values()), 1), overlap / max(sum(r.values()), 1))


def rouge_l(ref: List[str], hyp: List[str]) -> float:
    if not ref or not hyp:
        return 0
    prev = [0] * (len(hyp) + 1)
    for a in ref:
        row = [0]
        for j, b in enumerate(hyp, 1):
            row.append(prev[j - 1] + 1 if a == b else max(prev[j], row[j - 1]))
        prev = row
    return _fmeasure(prev[-1] / len(hyp), prev[-1] / len(ref))


def score(ref: str, hyp: str, kind: str) -> float:
    """The F-measure of `kind` ("rouge1", "rouge2" or "rougeL") of `hyp`
    against `ref`."""
    r, h = tokenize(ref), tokenize(hyp)
    if kind == "rougeL":
        return rouge_l(r, h)
    if kind in ("rouge1", "rouge2"):
        return rouge_n(r, h, int(kind[-1]))
    raise ValueError(f"unknown ROUGE kind {kind!r}")
