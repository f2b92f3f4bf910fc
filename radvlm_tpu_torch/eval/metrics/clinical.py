"""Clinical metrics sidecar: RadGraph-F1, CheXbert-F1, BERTScore, GREEN (the
port's own copy of `radvlm_tpu/eval/metrics/clinical.py`; the model backends
stay optional and are imported only when called).

These depend on external PyTorch models (radgraph-xl, chexbert, distilbert,
StanfordAIMI/GREEN-radllama2-7b) exactly as the reference does
(`radvlm/evaluation/vilmedic/utils.py:94-128`, `eval_green.py:20-26`). They stay an
*optional CPU/GPU sidecar* (SURVEY.md §7 hard part 5): each scorer degrades to a
clear ImportError message when its package/weights are absent, and
`available_clinical_metrics()` reports what can run in this environment.

GREEN is reimplemented as a thin judge harness: any callable LLM (a loaded
radllama2, an API client, or a test fake) receives the reference/candidate pair
prompt and the harness parses the error counts — the reference's parsing contract
(`NLG/green/green.py:102-176`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def available_clinical_metrics() -> Dict[str, bool]:
    out = {}
    for name, mod in [
        ("radgraph", "radgraph"),
        ("chexbert", "f1chexbert"),
        ("bertscore", "bert_score"),
    ]:
        try:
            __import__(mod)
            out[name] = True
        except Exception:
            out[name] = False
    return out


def radgraph_f1(
    refs: Sequence[str], hyps: Sequence[str]
) -> Tuple[float, float, float]:
    """(simple, partial, complete) mean F1 via the radgraph package
    (radgraph-xl, per-pair averaged like `vilmedic/utils.py:96-111`)."""
    from radgraph import F1RadGraph

    scorer = F1RadGraph(reward_level="all", model_type="radgraph-xl")
    simple, partial, complete = [], [], []
    for t, p in zip(refs, hyps):
        s, pa, c = scorer([t], [p])[0]
        simple.append(s)
        partial.append(pa)
        complete.append(c)
    n = max(len(simple), 1)
    return sum(simple) / n, sum(partial) / n, sum(complete) / n


def chexbert_f1(
    refs: Sequence[str], hyps: Sequence[str]
) -> Dict[str, float]:
    """all/5-label micro+macro F1 via f1chexbert (`vilmedic/utils.py:118-128`)."""
    from f1chexbert import F1CheXbert

    _, _, all_metrics, five_metrics = F1CheXbert(
        refs_filename=None, hyps_filename=None
    )(hyps, refs)
    return {
        "chexbert_all_micro": all_metrics["micro avg"]["f1-score"],
        "chexbert_all_macro": all_metrics["macro avg"]["f1-score"],
        "chexbert_5_micro": five_metrics["micro avg"]["f1-score"],
        "chexbert_5_macro": five_metrics["macro avg"]["f1-score"],
    }


def bertscore(
    refs: Sequence[str], hyps: Sequence[str]
) -> Tuple[float, List[float]]:
    """distilbert BERTScore F1 (reference `NLG/bertscore/bertscore.py:10`)."""
    from bert_score import BERTScorer

    scorer = BERTScorer(
        model_type="distilbert-base-uncased", num_layers=5,
        batch_size=64, all_layers=False, idf=False, lang="en",
        rescale_with_baseline=True,
    )
    _, _, f1 = scorer.score(list(hyps), list(refs))
    f1 = [float(x) for x in f1]
    return sum(f1) / max(len(f1), 1), f1


# ---------------------------------------------------------------------------
# GREEN — LLM-judged report errors
# ---------------------------------------------------------------------------

GREEN_CATEGORIES = (
    "(a) False report of a finding in the candidate",
    "(b) Missing a finding present in the reference",
    "(c) Misidentification of a finding's anatomic location/position",
    "(d) Misassessment of the severity of a finding",
    "(e) Mentioning a comparison that isn't in the reference",
    "(f) Omitting a comparison detailing a change from a prior study",
)

GREEN_PROMPT = """Objective: Evaluate the accuracy of a candidate radiology report in comparison to a reference radiology report composed by expert radiologists.

Process Overview: You will be presented with:
1. The criteria for making a judgment.
2. The reference radiology report.
3. The candidate radiology report.

For each of the following significant clinical error categories, count the number of errors in the candidate report:
{categories}

Also count matched findings: clinically significant findings present in BOTH reports.

Reference report:
{reference}

Candidate report:
{candidate}

Respond with one line per category formatted exactly as
"(x) <category>: <count>" followed by a line "Matched findings: <count>".
"""


def green_prompt(reference: str, candidate: str) -> str:
    cats = "\n".join(GREEN_CATEGORIES)
    return GREEN_PROMPT.format(
        categories=cats, reference=reference, candidate=candidate
    )


_COUNT_RE = re.compile(r"\(([a-f])\)[^:]*:\s*(\d+)")
_MATCHED_RE = re.compile(r"[Mm]atched findings[^\d]*(\d+)")


def parse_green_response(text: str) -> Optional[Dict[str, int]]:
    """Extract per-category error counts + matched findings from judge output.
    Returns None if unparseable (the reference skips such samples)."""
    counts = {c: int(v) for c, v in _COUNT_RE.findall(text)}
    m = _MATCHED_RE.search(text)
    if m is None and not counts:
        return None
    return {"matched": int(m.group(1)) if m else 0, **counts}


def green_score_from_counts(counts: Dict[str, int]) -> float:
    """GREEN per-sample score: matched / (matched + total significant errors)
    (`NLG/green/green.py:102-176` contract); 0 when nothing matched."""
    sig = sum(v for k, v in counts.items() if k != "matched")
    matched = counts.get("matched", 0)
    denom = matched + sig
    return matched / denom if denom > 0 else 0.0


def green(
    refs: Sequence[str],
    hyps: Sequence[str],
    judge: Callable[[str], str],
) -> Tuple[float, List[Optional[float]]]:
    """Run the GREEN judge over (ref, hyp) pairs. `judge(prompt) -> response`."""
    scores: List[Optional[float]] = []
    for r, h in zip(refs, hyps):
        counts = parse_green_response(judge(green_prompt(r, h)))
        scores.append(None if counts is None else green_score_from_counts(counts))
    valid = [s for s in scores if s is not None]
    return (sum(valid) / len(valid) if valid else 0.0), scores


def green_batched(
    refs: Sequence[str],
    hyps: Sequence[str],
    batch_judge: Callable[[Sequence[str]], Sequence[str]],
) -> Tuple[float, List[Optional[float]]]:
    """green() over a BATCHED judge (`[prompts] -> [responses]`, e.g. the
    continuous-engine judge) — all samples in flight at once instead of
    one generate per sample."""
    prompts = [green_prompt(r, h) for r, h in zip(refs, hyps)]
    responses = batch_judge(prompts)
    scores: List[Optional[float]] = []
    for resp in responses:
        counts = parse_green_response(resp)
        scores.append(None if counts is None else green_score_from_counts(counts))
    valid = [s for s in scores if s is not None]
    return (sum(valid) / len(valid) if valid else 0.0), scores
