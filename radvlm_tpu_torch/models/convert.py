"""Weight bridge: the JAX package's parameter tree -> the port's modules and
back, and seeded random inits made directly on the device.

The JAX tree has numpy-convertible leaves, kernels in [in, out] layout and
per-layer leaves stacked along a leading [L, ...] axis, fused (`qkv`,
`gateup`) or not. This module owns every transpose, unstack and repack.
int8 `{__q__, __scale__}` nodes (the output of the JAX package's
`quantize_params`, fused or not) become `QLinear` modules: q [.., in, out]
-> weight [out, in], scale [.., 1, out] -> [out]; the int8 embedding keeps
its [V, D] rows and [V, 1] scales. int4 `{__q4__, __scale__}` nodes
(`quantize_params(bits=4)`; packed [.., in/2, out] in the concat layout,
scales [.., in/128, out]) become `Q4Linear` modules: the nibbles are
repacked once into the K12 kernel's layout, the group scales keep theirs.
`radvlm_to_tree` is the inverse, for an unfused model: the same keys,
shapes, dtypes and bytes the JAX package's tree has (the artifact writer,
`models/quant_io.py`, stores that tree).

A `device` of None means the card (`device.resolve`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import qwen2, radvlm, siglip
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.models.layers import Q4Linear, QLinear
from radvlm_tpu_torch.ops.int4_matmul import (
    dequantize_weight_int4,
    repack_from_concat,
    repack_to_concat,
)
from radvlm_tpu_torch.ops.quant import dequantize_array, quantize_model

Tree = Mapping[str, Any]
Q_KEY, Q4_KEY, SCALE_KEY = "__q__", "__q4__", "__scale__"


def _is_qnode(x) -> bool:
    return isinstance(x, Mapping) and Q_KEY in x


def _is_q4node(x) -> bool:
    return isinstance(x, Mapping) and Q4_KEY in x


def _tensor(x, idx=None) -> torch.Tensor:
    """A leaf (layer `idx` of a stacked one) as a CPU tensor: a numpy or JAX
    array (a writable copy; bf16 arrives as f32, exactly), or a tensor that
    `radvlm_to_tree` or an artifact made (taken as it is, possibly
    memory-mapped)."""
    if isinstance(x, Mapping):
        raise TypeError(f"expected an array leaf, got a subtree {sorted(x)}")
    if isinstance(x, torch.Tensor):
        return x if idx is None else x[idx]
    a = np.asarray(x)
    if idx is not None:
        a = a[idx]
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def _copy(param: torch.Tensor, x, idx=None, *, transpose: bool = False) -> None:
    """Leaf `x` (layer `idx` of it) -> `param`, moved to the parameter's
    device first so that a transpose runs there."""
    t = _tensor(x, idx).to(param.device)
    if transpose:
        t = t.t()
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: {tuple(t.shape)} -> {tuple(param.shape)}")
    param.data.copy_(t)


def _linear(parent, name: str, node: Tree, idx=None) -> None:
    """JAX {kernel [.., in, out] or an int8 / int4 node, bias [.., out]}
    (layer `idx` of a stack) -> `parent.<name>`. A quantized node replaces
    the module by a `QLinear` / `Q4Linear` on the same device (the bias
    keeps the module's dtype)."""
    lin = getattr(parent, name)
    kernel = node["kernel"]
    dev, dtype, bias = lin.weight.device, lin.weight.dtype, lin.bias is not None
    if _is_q4node(kernel):  # q4 [.., in/2, out] int8 packed, scale [.., in/128, out]
        packed = _tensor(kernel[Q4_KEY], idx).view(torch.int8).to(dev)
        lin = Q4Linear.empty(2 * packed.shape[0], packed.shape[1], bias, device=dev, dtype=dtype)
        setattr(parent, name, lin)
        _copy(lin.scale, kernel[SCALE_KEY], idx)
        lin.weight.data.copy_(repack_from_concat(packed))  # repacked on the device
    else:
        if _is_qnode(kernel):  # q [.., in, out] int8, scale [.., 1, out]
            d_in, d_out = _tensor(kernel[Q_KEY], idx).shape
            lin = QLinear.empty(d_in, d_out, bias, device=dev, dtype=dtype)
            setattr(parent, name, lin)
            lin.scale.data.copy_(_tensor(kernel[SCALE_KEY], idx).reshape(-1))
            kernel = kernel[Q_KEY]
        _copy(lin.weight, kernel, idx, transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, node["bias"], idx)
    elif "bias" in node:
        raise ValueError("the JAX tree has a bias the module does not")


def load_siglip(tower: siglip.SigLIPTower, tree: Tree) -> None:
    _linear(tower, "patch_embed", tree["patch_embed"])
    _copy(tower.pos_embed, tree["pos_embed"])
    _copy(tower.post_ln_scale, tree["post_ln"]["scale"])
    _copy(tower.post_ln_bias, tree["post_ln"]["bias"])
    lt = tree["layers"]
    fused = "qkv" in lt["attn"]
    if fused:
        siglip.fuse_projections(tower)
    for i, layer in enumerate(tower.layers):
        _copy(layer.ln1_scale, lt["ln1"]["scale"], i)
        _copy(layer.ln1_bias, lt["ln1"]["bias"], i)
        _copy(layer.ln2_scale, lt["ln2"]["scale"], i)
        _copy(layer.ln2_bias, lt["ln2"]["bias"], i)
        names = ("qkv", "o") if fused else ("q", "k", "v", "o")
        for name in names:
            _linear(layer, name, lt["attn"][name], i)
        _linear(layer, "fc1", lt["mlp"]["fc1"], i)
        _linear(layer, "fc2", lt["mlp"]["fc2"], i)


def load_qwen2(model: qwen2.Qwen2Decoder, tree: Tree) -> None:
    emb = tree["embed"]["embedding"]
    if _is_qnode(emb):  # int8 rows [V, D], one scale per row [V, 1]
        dev = model.embed.device
        model.set_int8_embedding(_tensor(emb[Q_KEY]).to(dev),
                                 _tensor(emb[SCALE_KEY]).float().to(dev))
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
        _copy(blk.ln1, lt["ln1"], i)
        _copy(blk.ln2, lt["ln2"], i)
        attn = ("qkv", "o") if fused else ("q", "k", "v", "o")
        mlp = ("gateup", "down") if fused else ("gate", "up", "down")
        for name in attn:
            _linear(blk, name, lt["attn"][name], i)
        for name in mlp:
            _linear(blk, name, lt["mlp"][name], i)


def radvlm_from_jax(
    params: Tree, cfg: RadVLMConfig, *, device=None, dtype=torch.float32
) -> radvlm.RadVLM:
    """The JAX package's RadVLM parameter tree -> a `RadVLM` module on
    `device` (None: the card)."""
    model = radvlm.RadVLM(cfg, device=resolve(device), dtype=dtype)
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
    the JAX package's (another generator). `device` None means the card."""
    model = radvlm.RadVLM(cfg, device=resolve(device), dtype=dtype)
    ones = ("ln1", "ln2", "ln1_scale", "ln2_scale", "post_ln_scale", "norm")
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "image_newline":
            p.normal_(0.0, cfg.text.hidden_size ** -0.5, generator=generator)
        elif leaf in ones:
            p.fill_(1.0)
        elif leaf in ("bias", "ln1_bias", "ln2_bias", "post_ln_bias"):
            p.zero_()
        else:  # Linear weights, embeddings, pos_embed
            p.normal_(0.0, 0.02, generator=generator)
    return model


@torch.no_grad()
def random_quantized_params(
    cfg: RadVLMConfig, generator: torch.Generator, device=None, *, dtype=torch.bfloat16,
    bits: int = 8, fuse: bool = True,
) -> radvlm.RadVLM:
    """A RadVLM whose quantizable projections and token embedding are born
    quantized on `device` (None: the card), the counterpart of the JAX
    package's `bench._random_quantized_params`: no bf16 copy of those
    weights is ever made. int8 values and packed nibble bytes are uniform
    over the whole byte range (so -128 and -8 occur), every int8 scale is
    0.02/127 and every int4 group scale 0.02/7, and every other parameter
    is N(0, 0.02) in `dtype`. With `bits=4` the split is
    `quantize_model(bits=4)`'s. The model is quantized and, unless
    `fuse=False` (an artifact holds the unfused tree), fused
    (`radvlm.fuse_for_inference`) on the meta device, before anything is
    allocated."""
    model = quantize_model(radvlm.RadVLM(cfg, device="meta", dtype=dtype), bits=bits)
    if fuse:
        radvlm.fuse_for_inference(model, cfg)
    model.to_empty(device=resolve(device))
    scales = {id(m.scale): 0.02 / (7.0 if isinstance(m, Q4Linear) else 127.0)
              for m in model.modules() if isinstance(m, (QLinear, Q4Linear))}
    scales[id(model.text.embed_scale)] = 0.02 / 127.0
    for p in model.parameters():
        if p.dtype == torch.int8:
            p.random_(-128, 128, generator=generator)
        elif p.dtype == torch.uint8:
            p.random_(0, 256, generator=generator)
        elif id(p) in scales:
            p.fill_(scales[id(p)])
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


@torch.no_grad()
def dequantized_copy(model: radvlm.RadVLM, cfg: RadVLMConfig, dtype=torch.float32) -> radvlm.RadVLM:
    """A plain (`Linear`) RadVLM in `dtype` holding the dequantized weights
    of a quantized one (int8 or int4), fused as the source is: the reference
    the quantized kernel path is held against. Filled one parameter at a time, so at most
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
        elif isinstance(mod, Q4Linear):
            # Rounded to the model's dtype first, as K12 and the dequant
            # route round the weights they multiply.
            ref.get_parameter(f"{name}.weight").copy_(
                dequantize_weight_int4(mod.weight, mod.scale, model.image_newline.dtype))
            done |= {f"{name}.weight", f"{name}.scale"}
    text = model.text
    if text.embed_scale is not None:
        ref.text.embed.copy_(dequantize_array(text.embed, text.embed_scale, dtype))
        done |= {"text.embed", "text.embed_scale"}
    for name, p in model.named_parameters():
        if name not in done:
            ref.get_parameter(name).copy_(p)
    return ref


def _kernel_node(lins) -> Any:
    """The JAX package's `kernel` leaf or node of a projection: one module,
    or a list of per-layer modules stacked along a leading axis."""
    many = isinstance(lins, (list, tuple))
    stack = (lambda ts: torch.stack([t.cpu() for t in ts])) if many else (lambda ts: ts[0].cpu())
    lins = list(lins) if many else [lins]
    if isinstance(lins[0], Q4Linear):
        return {Q4_KEY: stack([repack_to_concat(m.weight.data) for m in lins]),
                SCALE_KEY: stack([m.scale.data for m in lins])}
    if isinstance(lins[0], QLinear):
        return {Q_KEY: stack([m.weight.data.t().contiguous() for m in lins]),
                SCALE_KEY: stack([m.scale.data[None, :] for m in lins])}
    return stack([m.weight.data.t().contiguous() for m in lins])


def _linear_node(lins) -> Dict[str, Any]:
    node = {"kernel": _kernel_node(lins)}
    first = lins[0] if isinstance(lins, (list, tuple)) else lins
    if first.bias is not None:
        node["bias"] = (torch.stack([m.bias.data.cpu() for m in lins])
                        if isinstance(lins, (list, tuple)) else first.bias.data.cpu())
    return node


@torch.no_grad()
def radvlm_to_tree(model: radvlm.RadVLM) -> Dict[str, Any]:
    """An unfused `RadVLM` -> the JAX package's parameter tree: the same
    keys and shapes (kernels [in, out], per-layer leaves stacked [L, ...],
    int8 and int4 nodes in the JAX layouts), leaves as CPU tensors of the
    parameters' dtypes holding the same bytes. The inverse of
    `radvlm_from_jax`. A fused model raises: the tree of an artifact is the
    unfused one (the loader's runner fuses its own copy)."""
    text, tower = model.text, model.vision_tower
    if hasattr(text.layers[0], "qkv") or hasattr(tower.layers[0], "qkv"):
        raise ValueError("radvlm_to_tree takes an unfused model (load or build it with "
                         "fuse=False): fused projections have no place in the JAX tree")

    def col(layers, name):
        return [getattr(layer, name) for layer in layers]

    def stacked(layers, name):
        return torch.stack([getattr(layer, name).data.cpu() for layer in layers])

    tl, vl = list(text.layers), list(tower.layers)
    if text.embed_scale is not None:
        embedding = {Q_KEY: text.embed.data.cpu(), SCALE_KEY: text.embed_scale.data.cpu()}
    else:
        embedding = text.embed.data.cpu()
    text_tree: Dict[str, Any] = {
        "embed": {"embedding": embedding},
        "layers": {
            "ln1": stacked(tl, "ln1"),
            "ln2": stacked(tl, "ln2"),
            "attn": {n: _linear_node(col(tl, n)) for n in ("q", "k", "v", "o")},
            "mlp": {n: _linear_node(col(tl, n)) for n in ("gate", "up", "down")},
        },
        "norm": text.norm.data.cpu(),
    }
    if text.lm_head is not None:
        text_tree["lm_head"] = _linear_node(text.lm_head)
    tower_tree = {
        "patch_embed": _linear_node(tower.patch_embed),
        "pos_embed": tower.pos_embed.data.cpu(),
        "layers": {
            "ln1": {"scale": stacked(vl, "ln1_scale"), "bias": stacked(vl, "ln1_bias")},
            "ln2": {"scale": stacked(vl, "ln2_scale"), "bias": stacked(vl, "ln2_bias")},
            "attn": {n: _linear_node(col(vl, n)) for n in ("q", "k", "v", "o")},
            "mlp": {n: _linear_node(col(vl, n)) for n in ("fc1", "fc2")},
        },
        "post_ln": {"scale": tower.post_ln_scale.data.cpu(),
                    "bias": tower.post_ln_bias.data.cpu()},
    }
    return {
        "vision_tower": tower_tree,
        "projector": {f"fc{i}": _linear_node(fc) for i, fc in enumerate(model.projector.fcs)},
        "text": text_tree,
        "image_newline": model.image_newline.data.cpu(),
    }
