"""Weighted Box Fusion (WBF) — multi-annotator bbox consolidation (the port's
own copy of `radvlm_tpu/data/wbf.py`, numpy only).

Self-contained numpy implementation replacing the reference's `ensemble_boxes`
dependency (`radvlm/data/utils.py:112-132`, used by the VinDr-CXR adapters at
`radvlm/data/datasets.py:449,555` with iou_thr=0.1): VinDr-CXR has up to 3
radiologists drawing boxes for the same finding; WBF clusters boxes whose IoU
exceeds a threshold and replaces each cluster with its confidence-weighted average.

Algorithm (Solovyev et al., arXiv:1910.13302): boxes sorted by score; each box
joins the first existing cluster whose *fused* box has IoU > thr, else starts a new
cluster; fused coordinates are score-weighted means; fused score is the cluster
score mean, optionally rescaled by cluster size / number of models.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two [x1, y1, x2, y2] boxes."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return float(inter / union) if union > 0 else 0.0


def weighted_boxes_fusion(
    boxes_list: Sequence[Sequence[Sequence[float]]],
    scores_list: Sequence[Sequence[float]],
    labels_list: Sequence[Sequence[int]],
    *,
    iou_thr: float = 0.1,
    skip_box_thr: float = 0.0,
    conf_type: str = "avg",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse per-annotator box lists (normalized [0,1] xyxy).

    boxes_list[m] = boxes from annotator m. Returns (boxes [N,4], scores [N],
    labels [N]) sorted by score descending. Fusion is per-label.
    """
    n_models = max(len(boxes_list), 1)
    flat = []
    for m, (bs, ss, ls) in enumerate(zip(boxes_list, scores_list, labels_list)):
        for b, s, l in zip(bs, ss, ls):
            if s > skip_box_thr:
                flat.append((float(s), int(l), np.asarray(b, np.float64)))
    if not flat:
        return np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), np.int64)
    flat.sort(key=lambda t: -t[0])

    # clusters: per label -> list of [member (score, box) lists, fused box]
    out_boxes: List[np.ndarray] = []
    out_scores: List[float] = []
    out_labels: List[int] = []
    clusters: List[dict] = []

    for score, label, box in flat:
        placed = False
        for c in clusters:
            if c["label"] != label:
                continue
            if iou_xyxy(c["fused"], box) > iou_thr:
                c["scores"].append(score)
                c["boxes"].append(box)
                w = np.asarray(c["scores"])
                c["fused"] = (w[:, None] * np.stack(c["boxes"])).sum(0) / w.sum()
                placed = True
                break
        if not placed:
            clusters.append(
                {"label": label, "scores": [score], "boxes": [box],
                 "fused": box.copy()}
            )

    for c in clusters:
        s = float(np.mean(c["scores"]))
        if conf_type == "avg":
            # Standard WBF rescale: clusters confirmed by fewer annotators than
            # n_models get proportionally lower confidence.
            s = s * min(len(c["scores"]), n_models) / n_models
        out_boxes.append(c["fused"])
        out_scores.append(s)
        out_labels.append(c["label"])

    order = np.argsort(-np.asarray(out_scores))
    return (
        np.stack(out_boxes)[order],
        np.asarray(out_scores)[order],
        np.asarray(out_labels, np.int64)[order],
    )


def fuse_annotator_boxes(
    boxes: Sequence[Sequence[float]],
    labels: Sequence[int],
    annotators: Sequence[int],
    *,
    iou_thr: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience wrapper matching the reference's `apply_wbf` usage
    (`radvlm/data/utils.py:112-132`): group raw (box, label, annotator_id) rows by
    annotator, fuse with unit scores, return (boxes [N,4], labels [N])."""
    ann_ids = sorted(set(annotators))
    boxes_list, scores_list, labels_list = [], [], []
    for a in ann_ids:
        idx = [i for i, x in enumerate(annotators) if x == a]
        boxes_list.append([boxes[i] for i in idx])
        scores_list.append([1.0] * len(idx))
        labels_list.append([labels[i] for i in idx])
    fused, _, flabels = weighted_boxes_fusion(
        boxes_list, scores_list, labels_list, iou_thr=iou_thr
    )
    return fused, flabels
