"""Instruction-dataset exporters and training-mixture loading (the port's
own copy of `radvlm_tpu/data/export.py`; its files are byte for byte the
JAX package's).

The exporters iterate dataset adapters (with per-entry repeat factors and
optional caps for mixture balance) and turn each sample into a cell of one
serialization format:

- LLaVA json: {"id", "image" (path relative to the data root),
  "conversations": [{"from": "human", "value": "<image>\n" + Q}, {"from":
  "gpt", "value": A}, ...]}, "<image>\n" prepended to the first human turn
  only;
- VLM-R1 jsonl: the same conversations, one "<image>" marker in the first
  turn;
- Qwen jsonl: {"image", "query", "response"} per single-turn instruction;
- VeRL: {"prompt": chat list, "images", "reward_model"};
- GRPO-REC jsonl: {"image", "problem", "solution": JSON bbox}.

`load_mixture` reads training cells back from a LLaVA json file, a brace
glob of such files or a yaml recipe with sampling strategies.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def _relpath(path: str, root: Optional[str]) -> str:
    if root and path.startswith(root):
        return os.path.relpath(path, root)
    return path


def conversations_from_sample(sample: Dict[str, Any]) -> List[Dict[str, str]]:
    """Build the LLaVA `conversations` list from a sample: either a multi-turn
    `conversation` (list of {"from","value"}) or a single-turn `instr` Q/A."""
    if isinstance(sample.get("conversation"), list) and sample["conversation"]:
        conv = [
            {"from": c["from"], "value": c["value"]} for c in sample["conversation"]
        ]
    else:
        instr = sample.get("instr")
        if not isinstance(instr, dict):
            raise ValueError("sample has neither conversation nor instr")
        conv = [
            {"from": "human", "value": instr["question"]},
            {"from": "gpt", "value": instr["answer"]},
        ]
    return conv


def llava_cell(
    sample: Dict[str, Any],
    cell_id: str,
    *,
    data_root: Optional[str] = None,
    num_images: int = 1,
) -> Dict[str, Any]:
    """One LLaVA-json cell; `<image>\n` markers prepended to the first human turn
    (reference `create_instructions.py:29-71`)."""
    conv = conversations_from_sample(sample)
    if conv and conv[0]["from"] == "human" and "<image>" not in conv[0]["value"]:
        conv[0]["value"] = "<image>\n" * num_images + conv[0]["value"]
    return {
        "id": cell_id,
        "image": _relpath(sample["img_path"], data_root),
        "conversations": conv,
    }


def vlmr1_cell(
    sample: Dict[str, Any], cell_id: str, *, data_root: Optional[str] = None
) -> Dict[str, Any]:
    conv = conversations_from_sample(sample)
    if conv and conv[0]["from"] == "human" and "<image>" not in conv[0]["value"]:
        conv[0]["value"] = "<image>" + conv[0]["value"]
    return {
        "id": cell_id,
        "image": _relpath(sample["img_path"], data_root),
        "conversations": conv,
    }


def qwen_cell(
    sample: Dict[str, Any], cell_id: str, *, data_root: Optional[str] = None
) -> Dict[str, Any]:
    instr = sample["instr"]
    return {
        "id": cell_id,
        "image": _relpath(sample["img_path"], data_root),
        "query": instr["question"],
        "response": instr["answer"],
    }


def verl_cell(
    sample: Dict[str, Any], cell_id: str, *, data_root: Optional[str] = None
) -> Dict[str, Any]:
    """VeRL RL-framework cell (reference `create_verl_dataset_llava.py:13-39`)."""
    instr = sample["instr"]
    return {
        "id": cell_id,
        "images": [_relpath(sample["img_path"], data_root)],
        "prompt": [
            {"role": "user", "content": "<image>" + instr["question"]},
        ],
        "reward_model": {"style": "rule", "ground_truth": instr["answer"]},
    }


def grpo_rec_cell(
    sample: Dict[str, Any], cell_id: str, *, data_root: Optional[str] = None
) -> Dict[str, Any]:
    """GRPO referring-expression cell with a JSON bbox answer
    (reference `make_grpo_rec_jsonl.py:33-50`)."""
    return {
        "id": cell_id,
        "image": _relpath(sample["img_path"], data_root),
        "problem": sample["instr"]["question"],
        "solution": json.dumps(
            {"bbox": [[round(float(c), 2) for c in b] for b in sample["boxes"]]}
        ),
    }


@dataclasses.dataclass
class MixtureEntry:
    """One dataset in an export mixture (reference
    `create_llava_dataset.py:213-318`: repeats for balance, caps for size)."""

    dataset: Any  # Sequence-style adapter
    name: str
    repeats: int = 1
    max_samples: Optional[int] = None
    num_images: int = 1


def export_dataset(
    entries: Sequence[MixtureEntry],
    cell_fn: Callable[..., Dict[str, Any]] = llava_cell,
    *,
    data_root: Optional[str] = None,
    num_workers: int = 8,
) -> List[Dict[str, Any]]:
    """Materialize a mixture into cells (parallel sample fetch, deterministic
    order). Equivalent of `generate_llava_dataset_from_instruction_dataset`
    (`create_instructions.py:75-116`) without the torch DataLoader."""
    cells: List[Dict[str, Any]] = []
    for entry in entries:
        n = len(entry.dataset)
        if entry.max_samples is not None:
            n = min(n, entry.max_samples)

        def fetch(i, _entry=entry):
            s = _entry.dataset[i]
            return cell_fn(
                s, f"{_entry.name}_{i}", data_root=data_root
            ) if cell_fn is not llava_cell else cell_fn(
                s, f"{_entry.name}_{i}", data_root=data_root,
                num_images=_entry.num_images,
            )

        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            entry_cells = list(ex.map(fetch, range(n)))
        for r in range(entry.repeats):
            for i, c in enumerate(entry_cells):
                if r == 0:
                    cells.append(c)
                else:
                    cells.append({**c, "id": f"{c['id']}_rep{r}"})
    return cells


def write_json(cells: List[Dict[str, Any]], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cells, f)


def write_jsonl(cells: List[Dict[str, Any]], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for c in cells:
            f.write(json.dumps(c) + "\n")



def apply_sampling_strategy(items: List[Any], strategy: Optional[str]) -> List[Any]:
    """`first:N`, `end:N`, `random:N`, with `N%` percentage forms; `all` or
    None keeps everything. `random` draws with numpy's default generator
    seeded 42, as the JAX package does."""
    if not strategy or strategy == "all":
        return items
    kind, _, amount = strategy.partition(":")
    if amount.endswith("%"):
        n = int(len(items) * float(amount[:-1]) / 100.0)
    else:
        n = int(amount)
    n = min(n, len(items))
    if kind == "first":
        return items[:n]
    if kind == "end":
        return items[-n:]
    if kind == "random":
        rng = np.random.default_rng(42)
        idx = rng.permutation(len(items))[:n]
        return [items[i] for i in sorted(idx)]
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def load_mixture(path: str) -> List[Dict[str, Any]]:
    """Training cells from a .json file, a brace glob (`/a/{x,y}.json`) or a
    .yaml recipe ({datasets: [{json_path, sampling_strategy}]})."""
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            recipe = yaml.safe_load(f)
        cells: List[Dict[str, Any]] = []
        for spec in recipe["datasets"]:
            with open(spec["json_path"]) as f:
                items = json.load(f)
            cells.extend(apply_sampling_strategy(items, spec.get("sampling_strategy")))
        return cells
    if "{" in path:
        pre, _, rest = path.partition("{")
        body, _, post = rest.partition("}")
        cells = []
        for part in body.split(","):
            with open(pre + part + post) as f:
                cells.extend(json.load(f))
        return cells
    with open(path) as f:
        return json.load(f)
