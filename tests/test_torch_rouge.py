"""The port's own ROUGE against `rouge_score`, and its Porter stemmer
against nltk's.

`radvlm_tpu_torch.eval.metrics.nlg.rouge` must equal the JAX package's
`rouge` (which runs `rouge_score.RougeScorer(..., use_stemmer=True)`) with
`==`, per sample and for the mean, for rouge1, rouge2 and rougeL, on the
report strings of tests/test_metrics.py, the synthetic MIMIC-CXR split's
report sentences, edge strings (empty, punctuation only, digits, mixed case,
non-ASCII) and random sentences. `stem` must equal
`nltk.stem.porter.PorterStemmer().stem` on every distinct token of the
repo's Markdown files and of `radvlm_tpu/data/instructions.py`, and on
random lower-case words.
"""

import glob
import os
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from radvlm_tpu.eval.metrics.nlg import rouge as jax_rouge
from radvlm_tpu_torch.eval.metrics.nlg import rouge
from radvlm_tpu_torch.eval.metrics.rouge import stem, tokenize

nltk_porter = pytest.importorskip("nltk.stem.porter")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("rouge1", "rouge2", "rougel")

# tests/test_metrics.py's report pairs.
REPORTS_REF = [
    "The heart is enlarged . There is a small right pleural effusion .",
    "No acute cardiopulmonary abnormality .",
    "Bibasilar atelectasis without focal consolidation .",
    "There is mild pulmonary edema and cardiomegaly .",
]
REPORTS_HYP = [
    "The heart is mildly enlarged . Small right pleural effusion is present .",
    "No acute abnormality .",
    "There is bibasilar atelectasis . No focal consolidation .",
    "Mild pulmonary edema .",
]
# chip_smoke.py's synthetic MIMIC-CXR reports draw three of these.
SENTENCES = ["The heart size is normal.", "There is a small left pleural effusion.",
             "No pneumothorax.", "Mild pulmonary edema.", "Lines and tubes in place."]
EDGE = ["", " ", "...", "?!,;:", "a", "4", "12 mm", "3.5cm nodule in the RUL x2",
        "HEART Size IS Normal", "ThErE iS nO PnEuMoThOrAx", "Café résumé naïve",
        "İstanbul ÆSIR straße", "肺 no effusion 心脏", "\tline\nbreak\r\n", "a-b_c/d'e",
        "cannings outings skies dying succeed", "generalization relational hopefulness"]


def _same(refs, hyps):
    for kind in KINDS:
        mean, per = rouge(refs, hyps, kind)
        jmean, jper = jax_rouge(refs, hyps, kind)
        assert per == jper, kind
        assert mean == jmean, kind


def test_rouge_equals_rouge_score_on_reports():
    _same(REPORTS_REF, REPORTS_HYP)
    rng = np.random.default_rng(13)
    refs = [" ".join(rng.choice(SENTENCES, 3)) for _ in range(16)]
    hyps = [" ".join(rng.choice(SENTENCES, int(rng.integers(1, 4)))) for _ in range(16)]
    _same(refs, hyps)
    _same(refs, ["No acute process."] * 16)
    assert rouge(REPORTS_REF, REPORTS_REF, "rougel")[0] == 1.0
    assert rouge([], [], "rouge1") == (0.0, [])


def test_rouge_equals_rouge_score_on_edge_strings():
    refs = [r for r in EDGE for _ in EDGE]
    hyps = [h for _ in EDGE for h in EDGE]
    _same(refs, hyps)


_word = st.text(alphabet="abcdefghijklmnopqrstuvwxyz", min_size=1, max_size=15)
_token = st.one_of(_word, st.sampled_from(["effusion", "cardiomegaly", "opacities", "is",
                                           "the", "no", "12", "3.5", ".", ",", "LEFT"]))


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(st.lists(st.tuples(st.lists(_token, max_size=25), st.lists(_token, max_size=25)),
                min_size=1, max_size=4))
def test_rouge_equals_rouge_score_on_random_sentences(pairs):
    _same([" ".join(r) for r, _ in pairs], [" ".join(h) for _, h in pairs])


def test_tokenize():
    assert tokenize("The hearts, 12mm; EFFUSIONS!") == ["the", "heart", "12mm", "effus"]
    assert tokenize("...") == [] and tokenize("") == []


def test_stemmer_equals_nltk_on_repo_words():
    ps = nltk_porter.PorterStemmer()
    files = glob.glob(os.path.join(ROOT, "*.md")) + [
        os.path.join(ROOT, "radvlm_tpu", "data", "instructions.py")]
    words = set()
    for path in files:
        with open(path, encoding="utf-8") as f:
            words.update(re.findall(r"[A-Za-z0-9]+", f.read()))
    words |= {w.lower() for w in words}
    assert len(words) > 3000
    # nltk's departures from the paper, each on a word that needs it.
    words |= {"alogi", "analogi", "ies", "dies", "ied", "tied", "spied", "fly", "yy", "ayyy",
              "sky", "skies", "dying", "howe", "news", "innings", "hopefulli", "radicalli",
              "formalli", "conformabli", "controll", "roll", "hopping", "filing", "at", "is"}
    bad = [w for w in sorted(words) if stem(w) != ps.stem(w)]
    assert not bad, bad[:20]


_SUFFIXES = ("ational tional enci anci izer bli alli entli eli ousli ization ation ator "
             "alism iveness fulness ousness aliti iviti biliti fulli logi icate ative alize "
             "iciti ical ful ness al ance ence er ic able ible ant ement ment ent ion ou ism "
             "ate iti ous ive ize sses ies ss s eed ed ing y ied ll e").split()


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(st.one_of(
    _word,
    st.builds(lambda a, b: (a + b)[:15], st.text(alphabet="bcdlmnrstyaeiouwxz", max_size=8),
              st.sampled_from(_SUFFIXES)),
))
def test_stemmer_equals_nltk_on_random_words(word):
    assert stem(word) == nltk_porter.PorterStemmer().stem(word)
