"""Classification metrics: substring label matching -> micro/macro/per-label PRF
(the port's counterpart of `radvlm_tpu/eval/metrics/classification.py`).

Predicted labels are detected by case-insensitive substring presence in the
generated text. The JAX package scores the multi-label indicator matrices
with sklearn's `precision_recall_fscore_support(..., zero_division=0)`;
here the same sums and divisions are done in numpy, so evaluation runs where
sklearn is not installed:

- per label: precision tp / predicted, recall tp / true, F1 2 tp / (true +
  predicted), each 0 where its denominator is 0;
- micro: the same over the sums of all labels; macro: the unweighted mean of
  the per-label values.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def predicted_labels_from_text(text: str, labels: Sequence[str]) -> List[str]:
    low = text.lower()
    return [l for l in labels if l.lower() in low]


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def precision_recall_f1(
    actual: np.ndarray, predicted: np.ndarray, average: str | None
) -> Tuple:
    """sklearn's `precision_recall_fscore_support(actual, predicted,
    average=average, zero_division=0)[:3]` on [samples, labels] 0/1 matrices."""
    tp = (actual * predicted).sum(0)
    pred, true = predicted.sum(0), actual.sum(0)
    if average == "micro":
        tp, pred, true = tp.sum(keepdims=True), pred.sum(keepdims=True), true.sum(keepdims=True)
    p, r, f = _divide(tp, pred), _divide(tp, true), _divide(2.0 * tp, 1.0 * true + pred)
    if average is None:
        return p, r, f
    return float(np.mean(p)), float(np.mean(r)), float(np.mean(f))


def evaluate_classification(
    results: Sequence[Dict], labels: Sequence[str]
) -> Dict[str, float]:
    """results: [{"output": text, "labels": [gt label, ...]}]."""
    predicted, actual = [], []
    for r in results:
        if "output" not in r or "labels" not in r:
            raise ValueError("each result needs 'output' and 'labels'")
        pred = {l.lower() for l in predicted_labels_from_text(r["output"], labels)}
        act = {l.lower() for l in r["labels"]}
        predicted.append([1 if l.lower() in pred else 0 for l in labels])
        actual.append([1 if l.lower() in act else 0 for l in labels])

    predicted = np.asarray(predicted, np.int64).reshape(-1, len(labels))
    actual = np.asarray(actual, np.int64).reshape(-1, len(labels))
    p_mi, r_mi, f_mi = precision_recall_f1(actual, predicted, "micro")
    p_ma, r_ma, f_ma = precision_recall_f1(actual, predicted, "macro")
    _, _, f_per = precision_recall_f1(actual, predicted, None)
    return {
        "Precision(macro)": float(p_ma),
        "Precision(micro)": float(p_mi),
        "Recall(macro)": float(r_ma),
        "Recall(micro)": float(r_mi),
        "F1 Score(macro)": float(f_ma),
        "F1 Score(micro)": float(f_mi),
        **{l: float(f) for l, f in zip(labels, f_per)},
    }
