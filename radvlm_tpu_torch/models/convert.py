"""Weight bridge: the JAX package's parameter tree -> the port's modules, and
seeded random inits made directly on the device.

The JAX tree has numpy-convertible leaves, kernels in [in, out] layout and
per-layer leaves stacked along a leading [L, ...] axis, fused (`qkv`,
`gateup`) or not. This module owns every transpose and unstack. int8
`{__q__, __scale__}` nodes (the output of the JAX package's
`quantize_params`, fused or not) become `QLinear` modules: q [.., in, out]
-> weight [out, in], scale [.., 1, out] -> [out]; the int8 embedding keeps
its [V, D] rows and [V, 1] scales. int4 `{__q4__, __scale__}` nodes raise:
the int4 path is ROADMAP M9.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import qwen2, radvlm, siglip
from radvlm_tpu_torch.models.layers import QLinear
from radvlm_tpu_torch.ops.quant import dequantize_array, quantize_model

Tree = Mapping[str, Any]
Q_KEY, SCALE_KEY = "__q__", "__scale__"


def _is_qnode(x) -> bool:
    return isinstance(x, Mapping) and Q_KEY in x


def _array(x) -> np.ndarray:
    if isinstance(x, Mapping):
        if "__q4__" in x:
            raise NotImplementedError("int4 weights ({__q4__} nodes) are not ported (ROADMAP M9)")
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


def _linear(parent, name: str, node: Tree, idx=None) -> None:
    """JAX {kernel [.., in, out] or an int8 node, bias [.., out]} (layer
    `idx` of a stack) -> `parent.<name>`. An int8 node replaces the module by
    a `QLinear` on the same device (the bias keeps the module's dtype)."""
    lin = getattr(parent, name)
    pick = (lambda a: _array(a)[idx]) if idx is not None else _array
    kernel = node["kernel"]
    if _is_qnode(kernel):  # q [.., in, out] int8, scale [.., 1, out]
        d_in, d_out = pick(kernel[Q_KEY]).shape
        lin = QLinear.empty(d_in, d_out, lin.bias is not None,
                            device=lin.weight.device, dtype=lin.weight.dtype)
        setattr(parent, name, lin)
        _copy(lin.scale, pick(kernel[SCALE_KEY]).reshape(-1))
        kernel = kernel[Q_KEY]
    _copy(lin.weight, pick(kernel), transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, pick(node["bias"]))
    elif "bias" in node:
        raise ValueError("the JAX tree has a bias the module does not")


def load_siglip(tower: siglip.SigLIPTower, tree: Tree) -> None:
    _linear(tower, "patch_embed", tree["patch_embed"])
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
            _linear(layer, name, lt["attn"][name], i)
        _linear(layer, "fc1", lt["mlp"]["fc1"], i)
        _linear(layer, "fc2", lt["mlp"]["fc2"], i)


def load_qwen2(model: qwen2.Qwen2Decoder, tree: Tree) -> None:
    emb = tree["embed"]["embedding"]
    if _is_qnode(emb):  # int8 rows [V, D], one scale per row [V, 1]
        dev = model.embed.device
        model.set_int8_embedding(torch.from_numpy(np.array(emb[Q_KEY])).to(dev),
                                 torch.from_numpy(np.array(emb[SCALE_KEY], np.float32)).to(dev))
    else:
        _copy(model.embed, emb)
    _copy(model.norm, tree["norm"])
    if model.lm_head is not None:
        _linear(model, "lm_head", tree["lm_head"])
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
            _linear(blk, name, lt["attn"][name], i)
        for name in mlp:
            _linear(blk, name, lt["mlp"][name], i)


def radvlm_from_jax(
    params: Tree, cfg: RadVLMConfig, *, device=None, dtype=torch.float32
) -> radvlm.RadVLM:
    """The JAX package's RadVLM parameter tree -> a `RadVLM` module."""
    model = radvlm.RadVLM(cfg, device=device, dtype=dtype)
    load_siglip(model.vision_tower, params["vision_tower"])
    for i in range(len(model.projector.fcs)):
        _linear(model.projector.fcs, str(i), params["projector"][f"fc{i}"])
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


@torch.no_grad()
def random_quantized_params(
    cfg: RadVLMConfig, generator: torch.Generator, device=None, *, dtype=torch.bfloat16,
) -> radvlm.RadVLM:
    """A RadVLM whose quantizable projections and token embedding are born
    int8 on `device` (the counterpart of the JAX package's
    `bench._random_quantized_params`): no bf16 copy of those weights is ever
    made. int8 values are uniform over the whole byte range (so -128
    occurs), every scale is 0.02/127, and every other parameter is
    N(0, 0.02) in `dtype`. The model is quantized (`quantize_model`) and
    fused (`radvlm.fuse_for_inference`) on the meta device, before anything
    is allocated."""
    model = quantize_model(radvlm.RadVLM(cfg, device="meta", dtype=dtype))
    radvlm.fuse_for_inference(model, cfg)
    model.to_empty(device="cpu" if device is None else device)
    scales = {id(m.scale) for m in model.modules() if isinstance(m, QLinear)}
    scales.add(id(model.text.embed_scale))
    for p in model.parameters():
        if p.dtype == torch.int8:
            p.random_(-128, 128, generator=generator)
        elif id(p) in scales:
            p.fill_(0.02 / 127.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


@torch.no_grad()
def dequantized_copy(model: radvlm.RadVLM, cfg: RadVLMConfig, dtype=torch.float32) -> radvlm.RadVLM:
    """A plain (`Linear`) RadVLM in `dtype` holding the dequantized weights
    of a quantized one, fused as the source is: the reference the int8
    kernel path is held against. Filled one parameter at a time, so at most
    one dequantized weight is alive besides the copy."""
    ref = radvlm.RadVLM(cfg, device="meta", dtype=dtype)
    if hasattr(model.text.layers[0], "qkv"):
        qwen2.fuse_projections(ref.text)
    if hasattr(model.vision_tower.layers[0], "qkv"):
        siglip.fuse_projections(ref.vision_tower)
    ref.to_empty(device=model.device)
    done = set()
    for name, mod in model.named_modules():
        if isinstance(mod, QLinear):
            ref.get_parameter(f"{name}.weight").copy_(
                dequantize_array(mod.weight, mod.scale[:, None], dtype))
            done |= {f"{name}.weight", f"{name}.scale"}
    text = model.text
    if text.embed_scale is not None:
        ref.text.embed.copy_(dequantize_array(text.embed, text.embed_scale, dtype))
        done |= {"text.embed", "text.embed_scale"}
    for name, p in model.named_parameters():
        if name not in done:
            ref.get_parameter(name).copy_(p)
    return ref
