"""Synthetic-data pipelines: LLM report filtering + conversation generation
(counterpart of `radvlm_tpu/data/synth.py`).

Rebuild of `radvlm/data/llm_filter_reports.py` and `llm_generate_conversations.py`:
- prompts are module-level templates (originals to this framework; the reference
  keeps them in prefixes_prompts/*.txt) with the same inputs: report text, label
  list, view, gender, and per-sentence bounding boxes rendered via
  `format_sentences_bbox` (contract of `utils.py:38-71` process_sbb);
- outputs are idempotent per-sample files (skip-if-exists resume,
  `llm_filter_reports.py:44-46`): filtered_reports/<study_id>.txt and
  conversations/<image_id>.json, with the reference's 100k-file cap;
- parallelism is a thread pool over samples (the LLM call dominates; the
  reference forks N processes over dataset chunks).
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from radvlm_tpu_torch.data.llm_clients import LLMClient, extract_json_array

log = logging.getLogger(__name__)

FILTER_REPORTS_PROMPT = """You are given the findings/impression section of a chest X-ray radiology report. Rewrite it so that it describes ONLY what is visible in the current image:

- remove every reference to prior studies, comparisons, or interval change (e.g. "compared to prior", "again seen", "unchanged", "new since last exam");
- remove recommendations, clinical correlation requests, and communication notes;
- keep all findings and their descriptions otherwise verbatim where possible;
- output only the rewritten report text, nothing else.

Report:
"""

CONVERSATION_PROMPT = """You are generating a training conversation between a USER (a clinician) and an ASSISTANT (an expert chest X-ray AI). You are given ground-truth information about one chest X-ray. Write a natural conversation of 5 to 10 total turns in which the user asks questions about the image and the assistant answers accurately using ONLY the provided information. Vary question styles (findings, severity, locations, view, follow-up questions). Never invent findings that are not supported by the provided data.

Return the conversation as a JSON array of objects with fields "from" ("human" or "gpt") and "value" (the message text), and nothing else.

"""

GROUNDED_CONVERSATION_PROMPT = CONVERSATION_PROMPT + """Some observations come with normalized bounding boxes [x1, y1, x2, y2]. When the user asks where a finding is, the assistant should answer with those exact coordinates in the format [x1, y1, x2, y2] (2 decimals).

"""


def format_sentences_bbox(data: Optional[Sequence[Dict]]) -> Optional[str]:
    """[{observation, box}] -> "sentence: [x, y, x, y] ..." lines
    (contract of `utils.py:38-71`). Returns None on malformed coordinates."""
    if not data:
        return None
    grouped: Dict[str, List[str]] = {}
    for item in data:
        if "box" not in item or item["box"] is None:
            continue
        try:
            box = "[" + ", ".join(f"{float(c):.2f}" for c in item["box"]) + "]"
        except (TypeError, ValueError):
            return None
        grouped.setdefault(item["observation"], []).append(box)
    if not grouped:
        return None
    return "\n".join(f"{s}: {' '.join(bs)}" for s, bs in grouped.items())


def filter_reports(
    dataset,
    client: LLMClient,
    output_dir: str,
    *,
    id_field: str = "study_id",
    num_workers: int = 8,
    max_samples: Optional[int] = None,
) -> int:
    """Write filtered_reports/<id>.txt per sample; returns #written."""
    os.makedirs(output_dir, exist_ok=True)
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)

    def work(i: int) -> int:
        sample = dataset[i]
        sid = sample[id_field]
        out = os.path.join(output_dir, f"{sid}.txt")
        if os.path.exists(out):
            return 0
        report = sample.get("txt")
        if not report or report == "None":
            return 0
        text = client.complete(FILTER_REPORTS_PROMPT + report)
        if not text:
            return 0
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, out)
        return 1

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return sum(ex.map(work, range(n)))


def generate_conversations(
    dataset,
    client: LLMClient,
    output_dir: str,
    *,
    grounded: bool = False,
    num_workers: int = 8,
    max_files: int = 100_000,
    max_samples: Optional[int] = None,
) -> int:
    """Write conversations/<image_id>.json per sample; returns #written."""
    os.makedirs(output_dir, exist_ok=True)
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    prefix = GROUNDED_CONVERSATION_PROMPT if grounded else CONVERSATION_PROMPT

    def work(i: int) -> int:
        if len(os.listdir(output_dir)) >= max_files:
            return 0
        sample = dataset[i]
        image_id = os.path.splitext(os.path.basename(sample["img_path"]))[0]
        out = os.path.join(output_dir, f"{image_id}.json")
        if os.path.exists(out):
            return 0
        report = sample.get("txt")
        if not report or report == "None":
            return 0
        gender = sample.get("gender")
        if gender is not None:
            gender = "female" if gender == "F" else "male"
        prompt = prefix + "Radiology report: " + report + "\n"
        prompt += "List of Abnormalities: " + ", ".join(sample.get("labels") or []) + "\n"
        prompt += "View: " + str(sample.get("view")) + "\n"
        prompt += "Gender: " + str(gender) + "\n"
        sbb = format_sentences_bbox(sample.get("sentencesBBox"))
        if grounded and sbb:
            prompt += (
                "Selected observations with bounding boxes coordinates:\n"
                + sbb + "\n"
            )
        prompt += "\nConversation in expected format:\n"
        conv = extract_json_array(client.complete(prompt))
        if not isinstance(conv, list) or not conv:
            log.warning("no valid conversation for %s", image_id)
            return 0
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(conv, f, indent=2)
        os.replace(tmp, out)
        return 1

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return sum(ex.map(work, range(n)))
