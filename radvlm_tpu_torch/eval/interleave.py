"""Multi-image (interleave) evaluation driver + metrics (counterpart of
`radvlm_tpu/eval/interleave.py`).

Rebuild of the reference fork's multi-image benchmark harness
(`finetuning/llava/eval/evaluate_interleave.py`): per-dataset dispatch of
open-ended (Rouge-L f) vs multi-choice (normalized letter-accuracy) scoring
over a result.jsonl of {sample_id, dataset, question_type, gt_response,
pred_response} records, with the same VQA-style answer normalization
(punctuation stripping, article removal) and "a: ..."-style choice-letter
extraction.

The generation side reuses the port's `eval.harness.VLMRunner.generate_batch`, which
accepts multiple images per prompt (one `<image>` sentinel each) — the
multi-image path of the fusion core (`models/multimodal.build_sample` handles
N sentinels/images per sample).
"""

from __future__ import annotations

import json
import re
import string
from typing import Dict, List, Sequence, Tuple

ARTICLES = re.compile(r"\b(a|an|the)\b")
CHOICE_LETTERS = set("abcdefgh")

# Reference's image-choice benchmarks (answers are option letters referring to
# candidate images, `evaluate_interleave.py:181`).
IMAGE_CHOICE_DATASETS = (
    "recipeqa-RecipeQA_VisualCloze",
    "RecipeQA_ImageCoherence",
    "COMICS_Panel",
)


def normalize_answer(text: str) -> str:
    """VQA-style normalization (contract of `Eval.process`): lowercase, strip
    punctuation and articles, collapse whitespace."""
    text = text.lower().replace("\n", " ").replace("\t", " ").strip()
    text = "".join(ch for ch in text if ch not in string.punctuation)
    text = ARTICLES.sub(" ", text)
    return " ".join(text.split())


def extract_choice(pred: str) -> str:
    """'b: some option text' -> 'b' (reference `judge_multi_choice:103-110`)."""
    if ":" in pred:
        for part in (p.strip() for p in pred.split(":")):
            if len(part) == 1 and part in CHOICE_LETTERS:
                return part
    return pred


def evaluate_rouge(preds: Sequence[Dict]) -> Tuple[Dict[str, float], List[Dict]]:
    from radvlm_tpu_torch.eval.metrics.nlg import rouge

    refs = [p["gt_response"] for p in preds]
    hyps = [p["pred_response"] for p in preds]
    mean, per = rouge(refs, hyps, kind="rougeL")
    detail = [
        {"id": str(p.get("sample_id", i)), "score": str(round(s, 3))}
        for i, (p, s) in enumerate(zip(preds, per))
    ]
    return {"rouge_l_f": mean}, detail


def evaluate_multichoice(
    preds: Sequence[Dict],
) -> Tuple[Dict[str, float], List[Dict]]:
    correct = 0
    detail = []
    for i, p in enumerate(preds):
        gt = normalize_answer(p["gt_response"])
        # choice extraction runs before normalization (which strips the colon)
        pred = normalize_answer(extract_choice(p["pred_response"].lower()))
        score = int(pred == gt)
        correct += score
        detail.append({"id": str(p.get("sample_id", i)), "score": str(score)})
    return {"accuracy": correct / max(len(preds), 1)}, detail


def evaluate_results(preds: Sequence[Dict]) -> Dict[str, Dict[str, float]]:
    """Group result records by dataset and dispatch the per-type scorer
    (reference `__main__`, `evaluate_interleave.py:170-199`)."""
    by_dataset: Dict[str, List[Dict]] = {}
    for p in preds:
        by_dataset.setdefault(p.get("dataset", "default"), []).append(p)
    out = {}
    for ds, items in by_dataset.items():
        qtype = items[0].get("question_type", "open-ended")
        # Image-choice benchmarks (answers are candidate-image letters) and
        # nlrv2 (the reference's literal spelling; accept nlvr2 too) always
        # use the letter-accuracy scorer, whatever their question_type says
        # (`evaluate_interleave.py:181-199`).
        choice = (
            qtype == "multi-choice"
            or ds in ("nlrv2", "nlvr2")
            or ds in IMAGE_CHOICE_DATASETS
        )
        if choice:
            metrics, _ = evaluate_multichoice(items)
        elif qtype == "open-ended":
            metrics, _ = evaluate_rouge(items)
        else:
            metrics = {"error": f"question_type {qtype!r} not supported"}
        out[ds] = metrics
    return out


def run_interleave(
    runner,
    samples: Sequence[Dict],
    *,
    max_new_tokens: int = 64,
    batch_size: int = 0,
) -> List[Dict]:
    """Generate predictions for multi-image samples.

    samples: [{"prompt": str with N <image> markers, "images": [np.ndarray]*N,
    "gt_response", "dataset", "question_type", "sample_id"}].
    Returns result records ready for `evaluate_results`.
    """
    bs = batch_size or runner.batch_size
    results = []
    for i in range(0, len(samples), bs):
        chunk = samples[i : i + bs]
        texts = runner.generate_batch(
            [s["prompt"] for s in chunk],
            [s["images"] for s in chunk],
            max_new_tokens=max_new_tokens,
        )
        for s, text in zip(chunk, texts):
            results.append({
                "sample_id": s.get("sample_id", len(results)),
                "dataset": s.get("dataset", "default"),
                "question_type": s.get("question_type", "open-ended"),
                "gt_response": s.get("gt_response", ""),
                "pred_response": text,
            })
    return results


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--result-file", required=True,
                    help="result.jsonl of prediction records")
    ap.add_argument("--out", default=None, help="metrics json output path")
    args = ap.parse_args(argv)
    with open(args.result_file) as f:
        preds = [json.loads(line) for line in f if line.strip()]
    metrics = evaluate_results(preds)
    text = json.dumps(metrics, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
