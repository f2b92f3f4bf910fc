"""Task-metric registry, the port's own copy of `radvlm_tpu/eval/metrics/__init__.py`
(rebuild of `compute_metrics_tasks.evaluate_results`,
`radvlm/evaluation/compute_metrics_tasks.py:6-36`, plus the vendored
vilmedic `compute_scores` dispatch, `vilmedic/scores.py:31-141`)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from radvlm_tpu_torch.eval.metrics.boxes import evaluate_boxes, extract_boxes, box_iou
from radvlm_tpu_torch.eval.metrics.classification import evaluate_classification
from radvlm_tpu_torch.eval.metrics.nlg import (
    bleu4,
    cider_d,
    cider_d_rl,
    corpus_doc_freq,
    rouge,
)

GROUNDING_TASKS = (
    "object_grounding",
    "region_grounding",
    "abnormality_grounding",
    "abnormality_detection",
    "phrase_grounding",
)


def evaluate_reports(
    refs: Sequence[str],
    hyps: Sequence[str],
    *,
    with_clinical: bool = True,
) -> Dict[str, float]:
    """BLEU/ROUGE/CIDEr-D always; BERTScore/RadGraph/CheXbert when their optional
    deps + weights are present (reference `vilmedic/utils.py:36-66`; the 'blue' key
    spelling is the reference's)."""
    metrics: Dict[str, float] = {
        "blue": bleu4(refs, hyps)[0],
        "ciderd": cider_d(refs, hyps)[0],
        "rouge1": rouge(refs, hyps, "rouge1")[0],
        "rouge2": rouge(refs, hyps, "rouge2")[0],
        "rougel": rouge(refs, hyps, "rougel")[0],
    }
    if with_clinical:
        from radvlm_tpu_torch.eval.metrics import clinical

        avail = clinical.available_clinical_metrics()
        if avail.get("bertscore"):
            metrics["bertscore"] = clinical.bertscore(refs, hyps)[0]
        if avail.get("radgraph"):
            s, p, c = clinical.radgraph_f1(refs, hyps)
            metrics.update(
                radgraph_simple=s, radgraph_partial=p, radgraph_complete=c
            )
        if avail.get("chexbert"):
            metrics.update(clinical.chexbert_f1(refs, hyps))
    return metrics


def evaluate_results(
    task: str,
    results: Sequence[Dict],
    *,
    labels: Optional[Sequence[str]] = None,
    with_clinical: bool = True,
) -> Dict[str, float]:
    """results: list of dicts with 'output' plus task-specific ground truth
    ('boxes' for grounding, 'labels' for classification, 'txt' for reports)."""
    if task in GROUNDING_TASKS:
        return evaluate_boxes(results, avg_iou=True)
    if task == "abnormality_classification":
        if labels is None:
            raise ValueError("classification needs the label vocabulary")
        return evaluate_classification(results, [l.lower() for l in labels])
    if task == "report_generation":
        refs = [r["txt"] for r in results]
        hyps = [r["output"] for r in results]
        return evaluate_reports(refs, hyps, with_clinical=with_clinical)
    raise ValueError(f"Unsupported task: {task}")


def compute_scores(
    metrics: Sequence[str],
    refs: Sequence[str],
    hyps: Sequence[str],
    *,
    split: str = "test",
    seed: int = 0,
    epoch: Optional[int] = None,
    dump_dir: Optional[str] = None,
    corpus: Optional[Sequence[str]] = None,
    **backend_overrides,
) -> Dict[str, object]:
    """Name-dispatched scorer registry — the vilmedic `compute_scores`
    surface (`vilmedic/scores.py:31-141`): same metric names, same refs/hyps
    text dumps (`{split}_{seed}_refs.txt` / `_hyps.txt`) and appended
    metrics JSON when `dump_dir` is given.

    `corpus` feeds the RL CIDEr-D document frequencies (the reference reads
    a corpus file path from config, `NLG/ciderD_RL/ciderD_RL.py:26-29`).
    `backend_overrides` (ner_fn/nli_fn/sim_fn) reach the entity metrics —
    their external-model backends are pluggable per `radentity.py`.
    """
    scores: Dict[str, object] = {}
    if not metrics:
        return scores
    assert refs is not None and hyps is not None, (
        "You specified metrics but your evaluation does not return hyps "
        "nor refs"
    )
    assert len(refs) == len(hyps), (
        f"refs and hyps must have same length : {len(refs)} vs {len(hyps)}"
    )

    base = None
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        base = os.path.join(dump_dir, f"{split}_{seed}_{{}}")
        with open(base.format("refs.txt"), "w") as f:
            f.write("\n".join(map(str, refs)))
        with open(base.format("hyps.txt"), "w") as f:
            f.write("\n".join(map(str, hyps)))

    from radvlm_tpu_torch.eval.metrics import clinical, radentity

    for metric in metrics:
        if metric == "BLEU":
            scores["BLEU"] = bleu4(refs, hyps)[0]
        elif metric == "CIDERD":
            scores["CIDERD"] = cider_d(refs, hyps)[0]
        elif metric == "ciderdrl":
            if corpus is None:
                raise ValueError("ciderdrl needs corpus= for document freqs")
            scores["ciderdrl"] = cider_d_rl(
                refs, hyps, corpus_doc_freq(corpus)
            )[0]
        elif metric in ("ROUGE1", "ROUGE2", "ROUGEL"):
            scores[metric] = rouge(refs, hyps, metric.lower())[0]
        elif metric == "bertscore":
            scores["bertscore"] = clinical.bertscore(refs, hyps)[0]
        elif metric == "chexbert":
            for k, v in clinical.chexbert_f1(refs, hyps).items():
                # reference key shape: "chexbert-5_micro avg_f1-score" etc.
                tag = k.replace("chexbert_", "")
                group, stat = tag.rsplit("_", 1)
                scores[f"chexbert-{group}_{stat} avg_f1-score"] = v
        elif metric == "radgraph":
            s, p, c = clinical.radgraph_f1(refs, hyps)
            scores["radgraph_simple"] = s
            scores["radgraph_partial"] = p
            scores["radgraph_complete"] = c
        elif metric == "radentitymatchexact":
            scores["radentitymatchexact"] = radentity.rad_entity_match_exact(
                refs, hyps,
                ner_fn=backend_overrides.get("ner_fn"),
            )[0]
        elif metric == "radentitynli":
            scores["radentitynli"] = radentity.rad_entity_nli(
                refs, hyps,
                ner_fn=backend_overrides.get("ner_fn"),
                nli_fn=backend_overrides.get("nli_fn"),
                sim_fn=backend_overrides.get("sim_fn"),
            )[0]
        elif metric == "stanford_ct_abd_accuracy":
            scores["stanford_ct_abd"] = radentity.stanford_ct_abd_accuracy(
                refs, hyps
            )
        elif metric == "accuracy":
            # classification heads: refs are label ids, hyps are logits
            scores["accuracy"] = round(
                float(np.mean(np.array(refs) == np.argmax(hyps, -1))) * 100, 2
            )
        else:
            raise ValueError(f"Metric not implemented: {metric}")

    if base is not None:
        with open(base.format("metrics.txt"), "a+") as f:
            f.write(json.dumps(
                {"split": split, "epoch": epoch, "scores": scores},
                indent=4, sort_keys=False, default=float,
            ))
    return scores
