"""Instruction Q/A template banks for the 6 CXR task families (the port's own
copy of `radvlm_tpu/data/instructions.py`: the same banks and draws, so a
seed gives the same prompts in both packages).

Rebuild of the reference's randomized instruction generator
(`radvlm/data/create_instructions.py:120-529`): each task family has a bank of
question phrasings (and answer phrasings where applicable); a template is drawn per
sample with the provided RNG so dataset builds are reproducible under a fixed seed.

The *bbox answer format* is contract-critical and matches the reference exactly
(`create_instructions.py:9-19` and the eval regex `compute_metrics_tasks.py:61-64`):
each box rendered as `[x1, y1, x2, y2]` with 2-decimal normalized coordinates,
multiple boxes joined by ", ". Template wording is original to this framework; the
task coverage and answer semantics mirror the reference.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

Box = Sequence[float]


def format_box(box: Box) -> str:
    return "[" + ", ".join(f"{c:.2f}" for c in box[:4]) + "]"


def format_boxes(boxes: Sequence[Box]) -> str:
    return ", ".join(format_box(b) for b in boxes)


def _pick(rng: random.Random, bank: List[str]) -> str:
    return bank[rng.randrange(len(bank))]


# ---------------------------------------------------------------------------
# Report generation (reference bank: create_instructions.py:120-164)
# ---------------------------------------------------------------------------

REPORT_QUESTIONS = [
    "Provide a radiology report for this chest X-ray.",
    "Write the findings section for this chest X-ray.",
    "Describe the radiographic findings in this image.",
    "Generate a report describing this chest X-ray.",
    "What does this chest X-ray show? Write a full report.",
    "Please interpret this chest radiograph and report your findings.",
    "Draft the radiology report corresponding to this CXR.",
    "Summarize the findings visible on this chest X-ray.",
    "Compose a diagnostic report for the chest radiograph shown.",
    "Read this chest X-ray and produce the report.",
    "Report the radiological findings of this chest image.",
    "Give a detailed account of the findings in this chest X-ray.",
    "As a radiologist, write your report for this image.",
    "Analyze this chest radiograph and write the corresponding report.",
    "What findings would you report for this chest X-ray?",
]


def report_generation(
    report: str, rng: random.Random, *, german_suffixe: bool = False
) -> Dict[str, str]:
    """german_suffixe appends " in German" to the question (multilingual
    report SFT variant, reference `create_instructions.py:139-157`; the
    answer text is expected to already be the German report)."""
    q = _pick(rng, REPORT_QUESTIONS)
    if german_suffixe:
        q += " in German"
    return {"question": q, "answer": report.strip()}


# ---------------------------------------------------------------------------
# Abnormality classification (reference bank: create_instructions.py:452-529)
# ---------------------------------------------------------------------------

CLASSIFICATION_QUESTIONS = [
    "Which abnormalities are present in this chest X-ray?",
    "List the abnormal findings visible on this image.",
    "What pathologies can you identify in this chest X-ray?",
    "Identify any abnormalities shown in this radiograph.",
    "Does this chest X-ray show any abnormal findings? List them.",
    "Name the abnormalities detectable in this CXR.",
    "What abnormal conditions are visible in this chest image?",
    "Classify the abnormalities present on this chest X-ray.",
    "Which of the common CXR pathologies does this image exhibit?",
    "Are there abnormalities on this chest radiograph? Which ones?",
]

NO_FINDING_ANSWERS = [
    "No abnormalities are present.",
    "The chest X-ray shows no abnormalities.",
    "No abnormal findings are identified.",
]


def classification(labels: Sequence[str], rng: random.Random) -> Dict[str, str]:
    q = _pick(rng, CLASSIFICATION_QUESTIONS)
    labels = [l for l in labels if l and l.lower() != "no finding"]
    if not labels:
        return {"question": q, "answer": _pick(rng, NO_FINDING_ANSWERS)}
    return {"question": q, "answer": ", ".join(labels)}


# ---------------------------------------------------------------------------
# Anatomical region location (reference bank: create_instructions.py:208-284)
# ---------------------------------------------------------------------------

REGION_QUESTIONS = [
    "Where is the {region} located in this image? Provide its bounding box.",
    "Give the bounding box coordinates of the {region}.",
    "Locate the {region} on this chest X-ray.",
    "What are the coordinates of the {region} in this radiograph?",
    "Identify the position of the {region} with a bounding box.",
    "Mark the {region} region: output its bounding box.",
    "Please localize the {region} in this chest X-ray.",
    "Provide the box delimiting the {region}.",
    "Point out where the {region} lies using coordinates.",
    "Output the bounding box of the {region} in this image.",
    "In this chest X-ray, where exactly is the {region}?",
    "Determine the bounding box for the {region}.",
    "Show me the {region}'s location as [x1, y1, x2, y2].",
    "Find the {region} and report its coordinates.",
    "What region of the image corresponds to the {region}?",
    "Specify the rectangular area covering the {region}.",
    "Return the normalized coordinates of the {region}.",
    "Highlight the {region}: give its bounding box.",
    "Where should I look to see the {region}? Give the box.",
    "Provide coordinates enclosing the {region}.",
]

REGION_ANSWERS = [
    "The {region} is located at {boxes}.",
    "{boxes} delimits the {region}.",
    "You can find the {region} at {boxes}.",
    "The bounding box of the {region} is {boxes}.",
    "It is located at {boxes}.",
    "The {region} corresponds to the area {boxes}.",
    "The {region} spans {boxes}.",
    "Coordinates of the {region}: {boxes}.",
    "The {region} occupies the region {boxes}.",
    "Its position is {boxes}.",
    "The {region} lies within {boxes}.",
    "Located at {boxes}.",
    "That anatomical region is found at {boxes}.",
    "The area {boxes} covers the {region}.",
    "The {region} appears at {boxes}.",
    "Its bounding box is {boxes}.",
    "The {region} can be seen at {boxes}.",
    "It spans the coordinates {boxes}.",
    "Bounding box: {boxes}.",
    "The {region} is delimited by {boxes}.",
]


def region_location(
    region: str, boxes: Sequence[Box], rng: random.Random
) -> Dict[str, str]:
    q = _pick(rng, REGION_QUESTIONS).format(region=region)
    a = _pick(rng, REGION_ANSWERS).format(region=region, boxes=format_boxes(boxes))
    return {"question": q, "answer": a}


# ---------------------------------------------------------------------------
# Abnormality grounding / detection (reference: create_instructions.py:288-378)
# ---------------------------------------------------------------------------

ABNORMALITY_GROUNDING_QUESTIONS = [
    "Locate the {label} in this chest X-ray.",
    "Where is the {label} visible? Provide bounding boxes.",
    "Give the bounding box coordinates of the {label}.",
    "Identify the position of the {label} on this image.",
    "Mark the area showing {label}.",
    "Where on this radiograph can the {label} be seen?",
    "Output the coordinates of the {label}.",
    "Localize the finding '{label}' with bounding boxes.",
    "Show the region affected by {label}.",
    "Detect the {label} and report its location.",
]

ABNORMALITY_GROUNDING_ANSWERS = [
    "The {label} is located at {boxes}.",
    "{label} is visible at {boxes}.",
    "Bounding boxes for the {label}: {boxes}.",
    "It can be seen at {boxes}.",
    "The finding appears at {boxes}.",
    "The {label} occupies {boxes}.",
]

ABNORMALITY_DETECTION_QUESTIONS = [
    "Detect all abnormalities in this chest X-ray and give their bounding boxes.",
    "Find every abnormal finding and localize it with coordinates.",
    "List all visible abnormalities together with their bounding boxes.",
    "Identify and localize each abnormality on this radiograph.",
    "What abnormalities are present, and where? Provide boxes.",
    "Report all findings with their positions as bounding boxes.",
]

NO_ABNORMALITY_ANSWERS = [
    "No abnormalities are detected in this image.",
    "This chest X-ray shows no localizable abnormalities.",
    "No abnormal findings to localize.",
]


def abnormality_grounding(
    label: str, boxes: Sequence[Box], rng: random.Random
) -> Dict[str, str]:
    q = _pick(rng, ABNORMALITY_GROUNDING_QUESTIONS).format(label=label)
    a = _pick(rng, ABNORMALITY_GROUNDING_ANSWERS).format(
        label=label, boxes=format_boxes(boxes)
    )
    return {"question": q, "answer": a}


def abnormality_detection(
    findings: Sequence[Tuple[str, Box]], rng: random.Random
) -> Dict[str, str]:
    """findings: list of (label, box). Empty -> 'no abnormalities' answer."""
    q = _pick(rng, ABNORMALITY_DETECTION_QUESTIONS)
    if not findings:
        return {"question": q, "answer": _pick(rng, NO_ABNORMALITY_ANSWERS)}
    parts = [f"{label}: {format_box(box)}" for label, box in findings]
    return {"question": q, "answer": "; ".join(parts)}


# ---------------------------------------------------------------------------
# Phrase grounding (reference: create_instructions.py:167-203)
# ---------------------------------------------------------------------------

PHRASE_QUESTIONS = [
    'Locate the finding described by: "{phrase}".',
    'Where in the image is "{phrase}"? Provide bounding boxes.',
    'Give the coordinates corresponding to "{phrase}".',
    'Find the region matching the phrase "{phrase}".',
    'Localize: "{phrase}".',
    'Which area of the X-ray does "{phrase}" refer to?',
    'Mark the region described as "{phrase}".',
    'Output bounding boxes for "{phrase}".',
]

PHRASE_ANSWERS = [
    "It is located at {boxes}.",
    "The described finding appears at {boxes}.",
    "Bounding boxes: {boxes}.",
    "You can see it at {boxes}.",
    "That phrase corresponds to {boxes}.",
]


def phrase_grounding(
    phrase: str, boxes: Sequence[Box], rng: random.Random
) -> Dict[str, str]:
    q = _pick(rng, PHRASE_QUESTIONS).format(phrase=phrase.strip())
    a = _pick(rng, PHRASE_ANSWERS).format(boxes=format_boxes(boxes))
    return {"question": q, "answer": a}


# ---------------------------------------------------------------------------
# Foreign objects (reference: create_instructions.py:381-446)
# ---------------------------------------------------------------------------

FOREIGN_OBJECT_QUESTIONS = [
    "Are there foreign objects or devices in this chest X-ray? Localize them.",
    "Detect any tubes, lines, or hardware and give their bounding boxes.",
    "Identify foreign objects visible on this radiograph with coordinates.",
    "Locate any medical devices or foreign bodies in this image.",
    "Does this X-ray contain foreign objects? Where?",
]

NO_FOREIGN_OBJECT_ANSWERS = [
    "No foreign objects are visible.",
    "This image contains no foreign objects or devices.",
]


def foreign_objects(
    objects: Sequence[Tuple[str, Box]], rng: random.Random
) -> Dict[str, str]:
    q = _pick(rng, FOREIGN_OBJECT_QUESTIONS)
    if not objects:
        return {"question": q, "answer": _pick(rng, NO_FOREIGN_OBJECT_ANSWERS)}
    parts = [f"{name}: {format_box(box)}" for name, box in objects]
    return {"question": q, "answer": "; ".join(parts)}
