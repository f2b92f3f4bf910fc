"""Training-side mixture loading, the port's own copy of the part of
`radvlm_tpu/data/export.py` the trainer needs: `load_mixture` reads training
cells from a LLaVA json file, a brace glob of such files or a yaml recipe
with sampling strategies. (The exporters that write those files are data
preparation and are not ported.)
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np


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
