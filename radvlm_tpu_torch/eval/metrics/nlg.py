"""NLG metrics: BLEU-4 (coco-style), ROUGE-1/2/L, CIDEr-D (the port's own copy
of `radvlm_tpu/eval/metrics/nlg.py`).

Bit-matched rebuilds of the vendored vilmedic scorers the reference evaluates
reports with (`radvlm/evaluation/vilmedic/utils.py:36-66`):
- BLEU: coco-caption corpus BLEU-4 — whitespace tokens, clipped modified n-gram
  precision with tiny/small smoothing constants, 'closest' reference-length option,
  brevity penalty exp(1 - 1/ratio) (`NLG/bleu/bleu_scorer.py`);
- ROUGE-1/2/L: mean F-measure with stemming (`NLG/rouge/rouge.py`), scored by
  the port's own `eval/metrics/rouge.py`, which equals the `rouge_score`
  package with nltk's Porter stemmer float for float. It is the one
  implementation on the CPU and on the card: the port does not switch to
  `rouge_score` where that package imports, so one code path is trusted;
- CIDEr-D: tf-idf n-gram (1..4) similarity with count clipping and gaussian length
  penalty sigma=6, corpus idf from the reference set, score x10
  (`NLG/ciderD/ciderD_scorer.py` — including its bigram-based length quirk).

Each scorer returns (corpus_score, per_sample_scores) like the vilmedic wrappers.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from radvlm_tpu_torch.eval.metrics.rouge import score as _rouge_score

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU-4 (coco-caption semantics)
# ---------------------------------------------------------------------------


def bleu4(
    refs: Sequence[str], hyps: Sequence[str]
) -> Tuple[float, List[float]]:
    """Corpus + per-sample BLEU-4 (single reference per sample)."""
    n = 4
    total_guess = [0] * n
    total_correct = [0] * n
    total_testlen = 0
    total_reflen = 0
    per_sample: List[float] = []

    for ref, hyp in zip(refs, hyps):
        rtok, htok = ref.split(), hyp.split()
        testlen, reflen = len(htok), len(rtok)
        total_testlen += testlen
        total_reflen += reflen
        guess = [max(0, testlen - k) for k in range(n)]
        correct = []
        for k in range(1, n + 1):
            h, r = _ngrams(htok, k), _ngrams(rtok, k)
            correct.append(sum(min(c, r[g]) for g, c in h.items()))
        for k in range(n):
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]
        # per-sample bleu (k=4 entry of bleu_list)
        b = 1.0
        for k in range(n):
            b *= (correct[k] + _TINY) / (guess[k] + _SMALL)
        b = b ** (1.0 / n)
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        if ratio < 1:
            b *= math.exp(1 - 1 / ratio)
        per_sample.append(b)

    corpus = 1.0
    for k in range(n):
        corpus *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
    corpus = corpus ** (1.0 / n)
    ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
    if ratio < 1:
        corpus *= math.exp(1 - 1 / ratio)
    return float(corpus), per_sample


# ---------------------------------------------------------------------------
# ROUGE (stemmed, rouge_score's semantics - see eval/metrics/rouge.py)
# ---------------------------------------------------------------------------


def rouge(
    refs: Sequence[str], hyps: Sequence[str], kind: str = "rougeL"
) -> Tuple[float, List[float]]:
    kind = {"rouge1": "rouge1", "rouge2": "rouge2", "rougel": "rougeL"}[
        kind.lower()
    ]
    f1s = [_rouge_score(r, h, kind) for r, h in zip(refs, hyps)]
    return float(np.mean(f1s)) if f1s else 0.0, f1s


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------


def cider_d(
    refs: Sequence[str],
    hyps: Sequence[str],
    *,
    n: int = 4,
    sigma: float = 6.0,
) -> Tuple[float, List[float]]:
    """Single-reference CIDEr-D with corpus idf computed from `refs`."""
    ref_counts = [_all_ngrams(r.split(), n) for r in refs]
    hyp_counts = [_all_ngrams(h.split(), n) for h in hyps]

    doc_freq: Dict[tuple, float] = defaultdict(float)
    for counts in ref_counts:
        for ngram in counts:
            doc_freq[ngram] += 1.0
    log_corpus = math.log(float(len(ref_counts)))

    def to_vec(counts: Counter):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ngram, tf in counts.items():
            df = math.log(max(1.0, doc_freq[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = tf * (log_corpus - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:  # coco quirk: "length" counts bigrams
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores: List[float] = []
    for h_cnt, r_cnt in zip(hyp_counts, ref_counts):
        hv, hn, hl = to_vec(h_cnt)
        rv, rn, rl = to_vec(r_cnt)
        delta = float(hl - rl)
        penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
        val = np.zeros(n)
        for k in range(n):
            for ngram, w in hv[k].items():
                val[k] += min(w, rv[k][ngram]) * rv[k][ngram]
            if hn[k] != 0 and rn[k] != 0:
                val[k] /= hn[k] * rn[k]
            val[k] *= penalty
        scores.append(float(np.mean(val)) * 10.0)
    return float(np.mean(scores)) if scores else 0.0, scores


def _all_ngrams(tokens: List[str], n: int) -> Counter:
    c: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            c[tuple(tokens[i:i + k])] += 1
    return c


def corpus_doc_freq(corpus: Sequence[str], *, n: int = 4) -> Dict[tuple, float]:
    """n-gram document frequencies over a training corpus — the precomputed
    `df` the RL-reward CIDEr-D variant scores against
    (`NLG/ciderD_RL/ciderD_RL.py:26-29`: DF built once from a corpus file,
    then reused for every reward call)."""
    doc_freq: Dict[tuple, float] = defaultdict(float)
    for doc in corpus:
        for ngram in _all_ngrams(doc.split(), n):
            doc_freq[ngram] += 1.0
    return doc_freq


def cider_d_rl(
    refs: Sequence[str],
    hyps: Sequence[str],
    doc_freq: Dict[tuple, float],
    *,
    n: int = 4,
    sigma: float = 6.0,
    log_norm: float | None = None,
) -> Tuple[float, List[float]]:
    """RL-reward CIDEr-D (`NLG/ciderD_RL/ciderD_RL_scorer.py`): identical to
    :func:`cider_d` except the document frequencies come from an external
    corpus (``corpus_doc_freq``) instead of the eval refs, so per-sample
    scores are stable rewards independent of the sampled batch.

    Reference quirk kept for parity: the default idf log-normalizer is
    ``log(len(refs))`` — the *eval batch* size (`ciderD_RL_scorer.py:167`),
    not the corpus size, even though the DF counts are corpus-level. Pass
    ``log_norm`` (e.g. ``log(corpus_size)``) to pin it — required for
    per-sample reward calls, where ``log(1) = 0`` would zero the idf.
    """
    ref_counts = [_all_ngrams(r.split(), n) for r in refs]
    hyp_counts = [_all_ngrams(h.split(), n) for h in hyps]
    if log_norm is not None:
        log_corpus = log_norm
    else:
        log_corpus = math.log(float(len(ref_counts))) if ref_counts else 0.0

    def to_vec(counts: Counter):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ngram, tf in counts.items():
            df = math.log(max(1.0, doc_freq.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = tf * (log_corpus - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:  # coco quirk: "length" counts bigrams
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores: List[float] = []
    for h_cnt, r_cnt in zip(hyp_counts, ref_counts):
        hv, hn, hl = to_vec(h_cnt)
        rv, rn, rl = to_vec(r_cnt)
        delta = float(hl - rl)
        penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
        val = np.zeros(n)
        for k in range(n):
            for ngram, w in hv[k].items():
                val[k] += min(w, rv[k][ngram]) * rv[k][ngram]
            if hn[k] != 0 and rn[k] != 0:
                val[k] /= hn[k] * rn[k]
            val[k] *= penalty
        scores.append(float(np.mean(val)) * 10.0)
    return float(np.mean(scores)) if scores else 0.0, scores
