"""LoRA adapters for parameter-efficient finetuning (counterpart of
`radvlm_tpu/training/lora.py`).

Adapters are a separate dictionary {path: {"a": [L, in, r], "b": [L, r,
out]}} over the stacked layer kernels, keyed by the JAX package's tree
paths (`text/layers/attn/q/kernel`) and in its [in, out] layout, so they
cross between the packages as numpy. `merge_lora` attaches them to the
matching `Linear` / `QLinear` modules of a model (in place, no copy of the
base): a dense kernel then multiplies by W + (alpha / r) a b, a quantized
one stays int8 and adds (x a) ((alpha / r) b) beside the quantized matmul
(`models.layers`), so a frozen int8 base never dequantizes into residency
(QLoRA). The optimizer trains the adapter dictionary alone.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from radvlm_tpu_torch.models import radvlm
from radvlm_tpu_torch.models.layers import Elsewhere, Linear, Q4Linear, QLinear
from radvlm_tpu_torch.ops.quant import dequantize_array, quantize_array

Adapters = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 128
    alpha: float = 256.0
    # Kernel paths to adapt (regex over the JAX package's tree paths): the
    # decoder's attention and MLP projections.
    target_patterns: Tuple[str, ...] = (
        r"text/layers/attn/[qkvo]/kernel$",
        r"text/layers/mlp/(gate|up|down)/kernel$",
    )

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def stacked_kernels(model: radvlm.RadVLM) -> Dict[str, List[Optional[nn.Module]]]:
    """Tree path of every stacked projection kernel -> its per-layer
    modules (an unfused model: the trainer never fuses); None for a layer
    another pipeline stage holds (`layers.Elsewhere`)."""
    out: Dict[str, List[Optional[nn.Module]]] = {}
    stacks = (
        ("text/layers/attn", model.text.layers, ("q", "k", "v", "o")),
        ("text/layers/mlp", model.text.layers, ("gate", "up", "down")),
        ("vision_tower/layers/attn", model.vision_tower.layers, ("q", "k", "v", "o")),
        ("vision_tower/layers/mlp", model.vision_tower.layers, ("fc1", "fc2")),
    )
    for prefix, layers, names in stacks:
        held = [layer for layer in layers if not isinstance(layer, Elsewhere)]
        for name in names:
            if held and all(hasattr(layer, name) for layer in held):
                out[f"{prefix}/{name}/kernel"] = [
                    None if isinstance(layer, Elsewhere) else getattr(layer, name)
                    for layer in layers]
    return out


def _targets(model: radvlm.RadVLM, cfg: LoraConfig) -> Dict[str, List[nn.Module]]:
    found = {p: mods for p, mods in stacked_kernels(model).items()
             if any(re.search(pat, p) for pat in cfg.target_patterns)}
    if not found and hasattr(model.text.layers[0], "qkv"):
        raise ValueError("LoRA targets the unfused projections: build the model unfused")
    return found


def init_lora(model: radvlm.RadVLM, cfg: LoraConfig, generator: torch.Generator) -> Adapters:
    """{path: {"a", "b"}}: a gaussian * 0.01 from `generator`, b zero, so
    the adapted model starts exactly at the base weights. Over a dense base
    the adapters take the kernel's dtype, over an int8 base f32; an int4
    base raises, as in the JAX package. Made on the model's device, with
    `requires_grad` on."""
    adapters: Adapters = {}
    for path, mods in _targets(model, cfg).items():
        first = next(m for m in mods if m is not None)
        if isinstance(first, Q4Linear):
            raise NotImplementedError(
                "LoRA over an int4-packed base is not wired; quantize the "
                "frozen base to int8 (quantize_model(bits=8))"
            )
        dtype = torch.float32 if isinstance(first, QLinear) else first.weight.dtype
        d_out, d_in = first.weight.shape
        dev = first.weight.device
        a = torch.randn((len(mods), d_in, cfg.rank), generator=generator, device=dev,
                        dtype=torch.float32) * 0.01
        b = torch.zeros((len(mods), cfg.rank, d_out), device=dev, dtype=torch.float32)
        adapters[path] = {"a": a.to(dtype).requires_grad_(True),
                          "b": b.to(dtype).requires_grad_(True)}
    return adapters


def merge_lora(model: radvlm.RadVLM, adapters: Adapters, cfg: LoraConfig) -> radvlm.RadVLM:
    """Attach the adapters to the model's matching projections, in place
    (differentiable with respect to the adapters: the modules read them at
    every forward). Paths without an adapter are detached. Returns the
    model."""
    kernels = stacked_kernels(model)
    unknown = set(adapters) - set(kernels)
    if unknown:
        raise KeyError(f"adapters for unknown kernels: {sorted(unknown)}")
    for path, mods in kernels.items():
        ad = adapters.get(path)
        for i, mod in enumerate(mods):
            if isinstance(mod, (Linear, QLinear)):
                mod.lora = None if ad is None else (ad["a"], ad["b"], i, cfg.scaling)
    return model


@torch.no_grad()
def merge_and_bake(model: radvlm.RadVLM, adapters: Adapters, cfg: LoraConfig) -> radvlm.RadVLM:
    """One-time merge for deployment, in place: a dense kernel becomes W +
    (alpha / r) a b; a quantized one dequantizes, adds the delta and
    quantizes again to fresh int8 scales. The adapters are detached."""
    kernels = stacked_kernels(model)
    for path, ad in adapters.items():
        for i, mod in enumerate(kernels[path]):
            if mod is None:
                continue
            a, b = ad["a"][i], ad["b"][i]
            if isinstance(mod, QLinear):
                # B is scaled and rounded to its dtype first, as `merge_lora`
                # hands it to the quantized matmul.
                delta = torch.matmul(a.float(), (cfg.scaling * b).to(b.dtype).float())
                dense = dequantize_array(mod.weight, mod.scale[:, None], torch.float32)
                q, s = quantize_array(dense + delta.t())
                mod.weight.copy_(q)
                mod.scale.copy_(s[:, 0])
            else:
                w = mod.weight
                w.copy_((w + cfg.scaling * torch.matmul(a, b).t().to(w.dtype)).to(w.dtype))
            mod.lora = None
    return model


def adapter_parameters(adapters: Adapters) -> Dict[str, torch.Tensor]:
    """{`<path>/a`, `<path>/b`: tensor}: the flat view the optimizer and the
    checkpoint use."""
    return {f"{path}/{k}": t for path, ad in adapters.items() for k, t in ad.items()}
