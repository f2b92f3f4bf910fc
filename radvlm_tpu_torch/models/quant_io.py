"""Pre-quantized checkpoints: save and load int8 / int4 models (counterpart
of `radvlm_tpu/models/quant_io.py`, and the same artifact).

Quantization is done once offline (`models/quantize_cli.py`); serving starts
from the artifact (`serve/worker_cli.py` detects it by its marker):

- `model.safetensors`: the flattened parameter tree in the JAX package's
  layout ("/"-joined keys, kernels [in, out], per-layer leaves stacked, int8
  `__q__` / `__scale__` nodes, nibble-packed int4 `__q4__` nodes in the
  concat layout, unquantized leaves), written by
  `models/safetensors_io.py`. bfloat16 leaves are stored as their uint16 bit
  patterns, as the JAX package stores them;
- `radvlm_quant.json`: the format marker, the whole `RadVLMConfig` (with the
  vision config's class name) and the map of leaves that are bfloat16.

An artifact the JAX package wrote loads here into the model the weight
bridge gives for the same tree, and one written here is read back by the JAX
package's `load_quantized` as the same tree, both bit for bit
(`convert.radvlm_from_jax` / `radvlm_to_tree` repack the int4 nibbles
without loss).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import torch

from radvlm_tpu_torch.config import (
    AnyResConfig,
    ProjectorConfig,
    Qwen2Config,
    RadVLMConfig,
    ResamplerConfig,
    SigLIPConfig,
)
from radvlm_tpu_torch.models import convert, radvlm, safetensors_io

MARKER = "radvlm_quant.json"
FORMAT_VERSION = 1
WEIGHTS = "model.safetensors"


def config_to_dict(cfg: RadVLMConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["__vision_class__"] = type(cfg.vision).__name__
    return d


def config_from_dict(d: Dict[str, Any]) -> RadVLMConfig:
    d = dict(d)
    vision_class = d.pop("__vision_class__", "SigLIPConfig")
    if vision_class != "SigLIPConfig":
        raise NotImplementedError(
            f"vision tower {vision_class!r} is not ported (ROADMAP M10): SigLIP only")

    def build(cls, sub):
        # tolerate missing / extra keys across versions: keep known fields only
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)  # JSON turns tuples into lists
              for k, v in sub.items() if k in fields}
        return cls(**kw)

    top = {f.name for f in dataclasses.fields(RadVLMConfig)}
    return RadVLMConfig(
        vision=build(SigLIPConfig, d.pop("vision")),
        text=build(Qwen2Config, d.pop("text")),
        projector=build(ProjectorConfig, d.pop("projector")),
        anyres=build(AnyResConfig, d.pop("anyres")),
        resampler=build(ResamplerConfig, d.pop("resampler")),
        **{k: v for k, v in d.items() if k in top},
    )


def _flatten_tree(tree: Any) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def visit(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                if "/" in k:
                    raise ValueError(f"param key {k!r} contains '/'")
                visit(v, f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = node

    visit(tree, "")
    return out


def _unflatten_tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_quantized(model: radvlm.RadVLM, cfg: RadVLMConfig, path: str) -> int:
    """Write an unfused (quantized or not) model as a checkpoint directory:
    `model.safetensors` and the marker. Returns the payload's bytes."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten_tree(convert.radvlm_to_tree(model))
    dtypes: Dict[str, str] = {}
    for k, v in flat.items():
        if v.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            flat[k] = v.view(torch.uint16)
    safetensors_io.write_file(flat, os.path.join(path, WEIGHTS))
    with open(os.path.join(path, MARKER), "w") as f:
        json.dump({
            "format_version": FORMAT_VERSION,
            "config": config_to_dict(cfg),
            "dtypes": dtypes,
        }, f, indent=1)
    return sum(v.numel() * v.element_size() for v in flat.values())


def is_quantized_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MARKER))


def load_quantized(path: str, device=None) -> Tuple[radvlm.RadVLM, RadVLMConfig]:
    """Load a pre-quantized checkpoint: (unfused model on `device`, cfg).
    None means the card. The file is memory-mapped and each leaf goes to the
    device on its own, where its transposes and repacks run."""
    with open(os.path.join(path, MARKER)) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported quantized-checkpoint format {meta.get('format_version')}")
    cfg = config_from_dict(meta["config"])
    flat = safetensors_io.read_file(os.path.join(path, WEIGHTS))
    dtypes = meta.get("dtypes", {})
    for k, v in flat.items():
        if dtypes.get(k) == "bfloat16":
            flat[k] = v.view(torch.bfloat16)
    # The model's dtype is that of its unquantized leaves.
    dtype = flat["image_newline"].dtype
    model = convert.radvlm_from_jax(_unflatten_tree(flat), cfg, device=device, dtype=dtype)
    return model, cfg
