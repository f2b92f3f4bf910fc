"""Weight bridge: the JAX package's parameter tree -> the port's modules, and
a seeded random init made directly on the device.

The JAX tree has numpy-convertible leaves, kernels in [in, out] layout and
per-layer leaves stacked along a leading [L, ...] axis, fused (`qkv`,
`gateup`) or not. This module owns every transpose and unstack. Quantized
leaves (int8 `{__q__, __scale__}` and int4 `{__q4__, __scale__}` nodes)
raise: the int8/int4 paths are ROADMAP M9.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import qwen2, radvlm, siglip

Tree = Mapping[str, Any]


def _array(x) -> np.ndarray:
    if isinstance(x, Mapping):
        if "__q__" in x or "__q4__" in x:
            raise NotImplementedError(
                "quantized weights (int8/int4 nodes) are not ported (ROADMAP M9)"
            )
        raise TypeError(f"expected an array leaf, got a subtree {sorted(x)}")
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    return a


def _copy(param: torch.Tensor, x, *, transpose: bool = False) -> None:
    a = _array(x)
    t = torch.from_numpy(np.array(a.T if transpose else a))  # a writable copy
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: {tuple(t.shape)} -> {tuple(param.shape)}")
    param.data.copy_(t)


def _linear(lin, node: Tree, idx=None) -> None:
    """JAX {kernel [.., in, out], bias [.., out]} (layer `idx` of a stack)."""
    pick = (lambda a: _array(a)[idx]) if idx is not None else _array
    _copy(lin.weight, pick(node["kernel"]), transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, pick(node["bias"]))
    elif "bias" in node:
        raise ValueError("the JAX tree has a bias the module does not")


def load_siglip(tower: siglip.SigLIPTower, tree: Tree) -> None:
    _linear(tower.patch_embed, tree["patch_embed"])
    _copy(tower.pos_embed, tree["pos_embed"])
    lt = tree["layers"]
    fused = "qkv" in lt["attn"]
    if fused:
        siglip.fuse_projections(tower)
    for i, layer in enumerate(tower.layers):
        _copy(layer.ln1_scale, _array(lt["ln1"]["scale"])[i])
        _copy(layer.ln1_bias, _array(lt["ln1"]["bias"])[i])
        _copy(layer.ln2_scale, _array(lt["ln2"]["scale"])[i])
        _copy(layer.ln2_bias, _array(lt["ln2"]["bias"])[i])
        names = ("qkv", "o") if fused else ("q", "k", "v", "o")
        for name in names:
            _linear(getattr(layer, name), lt["attn"][name], i)
        _linear(layer.fc1, lt["mlp"]["fc1"], i)
        _linear(layer.fc2, lt["mlp"]["fc2"], i)


def load_qwen2(model: qwen2.Qwen2Decoder, tree: Tree) -> None:
    _copy(model.embed, tree["embed"]["embedding"])
    _copy(model.norm, tree["norm"])
    if model.lm_head is not None:
        _linear(model.lm_head, tree["lm_head"])
    lt = tree["layers"]
    if "moe" in lt["mlp"]:
        raise NotImplementedError("MoE decoders are not ported (ROADMAP M10)")
    fused = "qkv" in lt["attn"]
    if fused:
        qwen2.fuse_projections(model)
    for i, blk in enumerate(model.layers):
        _copy(blk.ln1, _array(lt["ln1"])[i])
        _copy(blk.ln2, _array(lt["ln2"])[i])
        attn = ("qkv", "o") if fused else ("q", "k", "v", "o")
        mlp = ("gateup", "down") if fused else ("gate", "up", "down")
        for name in attn:
            _linear(getattr(blk, name), lt["attn"][name], i)
        for name in mlp:
            _linear(getattr(blk, name), lt["mlp"][name], i)


def radvlm_from_jax(
    params: Tree, cfg: RadVLMConfig, *, device=None, dtype=torch.float32
) -> radvlm.RadVLM:
    """The JAX package's RadVLM parameter tree -> a `RadVLM` module."""
    model = radvlm.RadVLM(cfg, device=device, dtype=dtype)
    load_siglip(model.vision_tower, params["vision_tower"])
    for i, fc in enumerate(model.projector.fcs):
        _linear(fc, params["projector"][f"fc{i}"])
    load_qwen2(model.text, params["text"])
    _copy(model.image_newline, params["image_newline"])
    return model


@torch.no_grad()
def init_params(
    cfg: RadVLMConfig, generator: torch.Generator, device=None, dtype=torch.bfloat16
) -> radvlm.RadVLM:
    """Random weights made directly on `device` from `generator`, with the
    JAX package's init distributions: matrices and embeddings N(0, 0.02),
    biases 0, norm scales 1, image_newline N(0, 1/d). The values differ from
    the JAX package's (another generator)."""
    model = radvlm.RadVLM(cfg, device=device, dtype=dtype)
    ones = ("ln1", "ln2", "ln1_scale", "ln2_scale", "norm")
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "image_newline":
            p.normal_(0.0, cfg.text.hidden_size ** -0.5, generator=generator)
        elif leaf in ones:
            p.fill_(1.0)
        elif leaf in ("bias", "ln1_bias", "ln2_bias"):
            p.zero_()
        else:  # Linear weights, embeddings, pos_embed
            p.normal_(0.0, 0.02, generator=generator)
    return model
