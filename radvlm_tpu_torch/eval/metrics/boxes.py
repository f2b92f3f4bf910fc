"""Grounding metrics: bbox extraction from generated text, IoU, mAP, avg IoU
(the port's own copy of `radvlm_tpu/eval/metrics/boxes.py`).

Bit-matched rebuild of the reference's box metrics
(`radvlm/evaluation/compute_metrics_tasks.py:61-167`):
- boxes are parsed from model text with the regex `[x, y, x, y]` (the textual bbox
  contract produced by `instructions.format_boxes`);
- per-sample AP: predictions in generation order, each greedily matched to its
  max-IoU ground-truth box (>= threshold, unmatched), precision envelope made
  monotone, AP = Σ (r_{i+1}-r_i) * p_{i+1};
- mAP = mean per-sample AP; avg_iou = mean IoU over ALL (pred, gt) pairs (the
  reference averages the full IoU matrix, not only matches).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

_BOX_RE = re.compile(
    r"\[([\d\.]+),\s*([\d\.]+),\s*([\d\.]+),\s*([\d\.]+)\]"
)


def extract_boxes(text: str) -> List[List[float]]:
    return [[float(g) for g in m] for m in _BOX_RE.findall(text)]


def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = (
        (a[2] - a[0]) * (a[3] - a[1])
        + (b[2] - b[0]) * (b[3] - b[1])
        - inter
    )
    return inter / union if union > 0 else 0.0


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    r = np.concatenate(([0.0], recall, [1.0]))
    p = np.concatenate(([0.0], precision, [0.0]))
    # Monotone (non-increasing) precision envelope.
    p = np.maximum.accumulate(p[::-1])[::-1]
    steps = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


def sample_ap(
    pred_boxes: Sequence[Sequence[float]],
    gt_boxes: Sequence[Sequence[float]],
    iou_threshold: float,
) -> float:
    ious = np.asarray(
        [[box_iou(p, g) for g in gt_boxes] for p in pred_boxes], float
    )
    matched: set = set()
    tp = np.zeros(len(pred_boxes))
    for i in range(len(pred_boxes)):
        j = int(np.argmax(ious[i]))
        if ious[i, j] >= iou_threshold and j not in matched:
            tp[i] = 1.0
            matched.add(j)
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    recall = tp_cum / len(gt_boxes)
    precision = tp_cum / (tp_cum + fp_cum)
    return average_precision(recall, precision)


def evaluate_boxes(
    results: Sequence[Dict],
    *,
    iou_thresholds: Optional[Sequence[float]] = None,
    avg_iou: bool = True,
) -> Dict[str, float]:
    """results: [{"output": generated text, "boxes": gt boxes}] -> metrics dict
    {"mAP_0.5": ..., "avg_iou": ...}."""
    iou_thresholds = list(iou_thresholds or [0.5])
    metrics: Dict[str, float] = {}
    iou_sum, iou_count = 0.0, 0

    for thr in iou_thresholds:
        aps = []
        for r in results:
            if "output" not in r or "boxes" not in r:
                raise ValueError("each result needs 'output' and 'boxes'")
            preds = extract_boxes(r["output"])
            gts = list(r["boxes"])
            if not preds or not gts:
                aps.append(0.0)
                continue
            if avg_iou and thr == iou_thresholds[0]:
                for p in preds:
                    for g in gts:
                        iou_sum += box_iou(p, g)
                iou_count += len(preds) * len(gts)
            aps.append(sample_ap(preds, gts, thr))
        metrics[f"mAP_{thr}"] = float(np.mean(aps)) if aps else 0.0

    if avg_iou and iou_count:
        metrics["avg_iou"] = iou_sum / iou_count
    return metrics
