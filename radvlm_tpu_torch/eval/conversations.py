"""Conversation evaluation: replay multi-turn chats, LLM-judge the answers
(counterpart of `radvlm_tpu/eval/conversations.py`, on the port's
`eval.harness.VLMRunner`).

Rebuild of `radvlm/evaluation/evaluate_conversations.py`: ground-truth multi-turn
conversations are replayed against the model with full chat history (the
reference keeps history in the conversation template, `:60-113`); a judge LLM
scores the generated answers against the ground truth with a rubric prompt and
the score is regex-extracted from "Overall score: X/10" (`:126-144`), keeping a
running average.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from radvlm_tpu_torch.data.chat import llava_turns
from radvlm_tpu_torch.data.llm_clients import LLMClient

log = logging.getLogger(__name__)

JUDGE_PROMPT = """You are evaluating an AI assistant's answers in a conversation about a chest X-ray. You are given the ground-truth conversation (written from the radiology report) and the candidate conversation, which contains the same user questions but the AI assistant's actual answers.

Score the candidate answers from 0 to 10 for clinical accuracy, completeness, and consistency with the ground truth (10 = all answers fully correct and complete; 0 = completely wrong). When bounding boxes are involved, correct localization matters.

Ground-truth conversation:
{reference}

Candidate conversation:
{candidate}

Briefly justify, then end your response with exactly:
Overall score: X/10
"""

_SCORE_RE = re.compile(r"Overall score:\s*([\d\.]+)\s*/\s*10")


def extract_judge_score(text: Optional[str]) -> Optional[float]:
    if not text:
        return None
    m = _SCORE_RE.search(text)
    return float(m.group(1)) if m else None


def _render_turns(turns: Sequence[Tuple[str, str]]) -> str:
    name = {"user": "USER", "assistant": "ASSISTANT"}
    return "\n".join(f"{name[r]}: {t}" for r, t in turns)


def replay_conversation(runner, sample) -> List[Tuple[str, str]]:
    """Feed each ground-truth user turn (with history of *generated* answers),
    collecting the model's answers."""
    gt_turns = llava_turns(sample["conversation"])
    history: List[Tuple[str, str]] = []
    image = sample["img"]
    first = True
    for role, content in gt_turns:
        if role != "user":
            continue
        q = content
        if first and "<image>" not in q:
            q = "<image>\n" + q
        first = False
        prompt = runner.build_prompt(q, history=history)
        answer = runner.generate_batch([prompt], [[image]])[0]
        history.append(("user", q))
        history.append(("assistant", answer))
    return history


def evaluate_conversations(
    runner,
    dataset,
    judge: LLMClient,
    *,
    max_samples: Optional[int] = None,
    output_path: Optional[str] = None,
) -> Dict[str, float]:
    """Replay + judge every conversation sample. Returns {mean_score, n}."""
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    scores: List[float] = []
    records = []
    for i in range(n):
        sample = dataset[i]
        if not sample.get("conversation"):
            continue
        try:
            candidate = replay_conversation(runner, sample)
        except Exception as e:
            log.warning("generation failed for sample %d: %s", i, e)
            continue
        gt = _render_turns(llava_turns(sample["conversation"]))
        cand = _render_turns(candidate)
        verdict = judge.complete(
            JUDGE_PROMPT.format(reference=gt, candidate=cand)
        )
        score = extract_judge_score(verdict)
        if score is None:
            log.warning("unparseable judge verdict for sample %d", i)
            continue
        scores.append(score)
        records.append({"idx": i, "candidate": cand, "score": score})
        log.info("sample %d: %.1f/10 (running mean %.2f)",
                 i, score, sum(scores) / len(scores))
    mean = sum(scores) / len(scores) if scores else 0.0
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            json.dump({"mean_score": mean, "n": len(scores),
                       "records": records}, f, indent=2)
    return {"mean_score": mean, "n": float(len(scores))}
