"""Weight-only int8 / int4 quantization and the quantized matmul dispatch
(counterpart of `radvlm_tpu/ops/quant.py`).

Quantized projections are `models.layers.QLinear` modules (int8 weight
[out, in] with one f32 scale per output channel: the JAX package's
{"__q__", "__scale__"} node, transposed) or `Q4Linear` modules (nibble-
packed int4 with group-128 scales: its {"__q4__", "__scale__"} node,
repacked). `qmm` and `q4mm` are their forwards and dispatch as the JAX
`quant.qmm` / `qmm_idx` do (`qmm_route` is the one predicate, which
`generation.engine.kernel_provenance` also calls).

int8 weights:
- more than 64 rows with W8A8 on: `quantize_rows`, then the K3 kernel, or,
  with RADVLM_W8A8_IMPL=fused (`w8a8_impl_name`), the K13 kernel that
  quantizes the rows itself;
- 64 rows or fewer: the K5/K6 kernel (weights streamed as int8);
- otherwise (the lm_head passes w8a8=False; RADVLM_W8A8=0): dequantize and
  one plain large matmul, which XLA also runs outside Pallas.

int4 weights (W4A16, activations are never quantized):
- 64 rows or fewer: the K12 kernel (weights streamed as nibbles);
- otherwise: dequantize to the activations' dtype and one plain matmul.

Training (`training_mode`): every quantized matmul dequantizes its weight
and runs one dense matmul, so that the activations keep a gradient through a
frozen quantized base (QLoRA); no quantized kernel is reached. The LoRA term
beside a quantized matmul is `models.layers.QLinear.forward`'s. The JAX
package's `qmm_idx` (a stacked weight and a layer index) needs no
counterpart: a layer's weight is its own tensor.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from radvlm_tpu_torch.ops.int4_matmul import (
    GROUP,
    dequantize_weight_int4,
    int4_matmul,
    quantize_weight_int4,
)
from radvlm_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_matmul
from radvlm_tpu_torch.ops.w8a8_matmul import quantize_rows, w8a8_matmul, w8a8_matmul_fused


# Set while a train step runs (forward AND backward: rematerialised layers run
# their forward again inside the backward). The W8A8 activation rounding has
# a zero gradient and the int8 / int4 kernels have none at all, so either
# would silently stop backprop through a frozen quantized base.
_TRAINING = False


@contextlib.contextmanager
def training_mode():
    """Quantized matmuls take the differentiable dequantize-then-matmul
    route while this is active (the counterpart of the JAX package's
    `quant.training_mode`)."""
    global _TRAINING
    prev = _TRAINING
    _TRAINING = True
    try:
        yield
    finally:
        _TRAINING = prev


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a dense matmul of `x` runs in: the autocast dtype where
    autocast is on for x's device (the trainer's bf16 operands over f32
    master weights), else x's own."""
    if x.is_cuda and torch.is_autocast_enabled():
        return torch.get_autocast_dtype("cuda")
    return x.dtype


def quantize_array(
    x: torch.Tensor, *, reduce_axes: Tuple[int, ...] = (-1,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with scale = max(max|x| / 127, 1e-12) over
    `reduce_axes` (kept as size 1): (q int8, scale f32). Weights [out, in]
    reduce over -1 (the JAX package's [in, out] kernels over -2), embeddings
    [V, D] over -1. Bit-exact with the JAX function."""
    xf = x.float()
    scale = (xf.abs().amax(dim=reduce_axes, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def w8a8_enabled() -> bool:
    """W8A8 prefill is on by default for int8 weights; RADVLM_W8A8=0 keeps
    activations in their dtype (dequantize, then one plain matmul)."""
    return os.environ.get("RADVLM_W8A8", "1") != "0"


def w8a8_impl_name() -> str:
    """Which kernel the "w8a8" route launches, from RADVLM_W8A8_IMPL:
    "fused" (K13: the rows are quantized inside the matmul) or "kernel" (K3
    after `quantize_rows`, the default). The JAX package's other names,
    "xla" and "pallas", both mean K3 here: the port has no XLA emitter."""
    impl = os.environ.get("RADVLM_W8A8_IMPL", "xla")
    if impl not in ("xla", "pallas", "fused"):
        raise ValueError(f"RADVLM_W8A8_IMPL={impl!r}: expected xla, pallas or fused")
    return "fused" if impl == "fused" else "kernel"


def qmm_route(rows: int, w8a8: Optional[bool] = None, bits: int = 8) -> str:
    """Where a quantized matmul of `rows` activation rows goes. The one
    dispatch predicate. Under `training_mode` always "dequant". int8 weights (`bits=8`): "w8a8" (K3, or K13 as
    `w8a8_impl_name` says), "int8" (K5/K6) or "dequant" (plain). int4
    weights (`bits=4`, whose contraction dim always divides by 128): "int4"
    (K12) or "dequant"; `w8a8` does not matter to them."""
    if _TRAINING:
        return "dequant"
    if bits == 4:
        return "int4" if rows <= MAX_ROWS else "dequant"
    if (w8a8_enabled() if w8a8 is None else w8a8) and rows > MAX_ROWS:
        return "w8a8"
    if rows <= MAX_ROWS:
        return "int8"
    return "dequant"


def qmm(
    x: torch.Tensor,
    weight: torch.Tensor,  # [out, in] int8
    scale: torch.Tensor,  # [out] f32
    bias: Optional[torch.Tensor] = None,
    *,
    w8a8: Optional[bool] = None,
) -> torch.Tensor:
    """x @ dequant(weight)^T (+ bias), in x's dtype."""
    route = qmm_route(x.numel() // x.shape[-1], w8a8)
    if route == "w8a8" and w8a8_impl_name() == "fused":
        y = w8a8_matmul_fused(x, weight, scale)
    elif route == "w8a8":
        xq, xs = quantize_rows(x)
        y = w8a8_matmul(xq, xs, weight, scale, out_dtype=x.dtype)
    elif route == "int8":
        y = int8_matmul(x, weight, scale)
    else:
        y = F.linear(x, dequantize_array(weight, scale[:, None], compute_dtype(x)))
    return y if bias is None else y + bias


def q4mm(
    x: torch.Tensor,
    weight: torch.Tensor,  # [out, in/2] uint8, two nibbles a byte
    scale: torch.Tensor,  # [in/128, out] f32
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x @ dequant4(weight)^T (+ bias), in x's dtype (W4A16)."""
    if qmm_route(x.numel() // x.shape[-1], bits=4) == "int4":
        y = int4_matmul(x, weight, scale)
    else:
        y = F.linear(x, dequantize_weight_int4(weight, scale, compute_dtype(x)))
    return y if bias is None else y + bias


def quantize_model(model, bits: int = 8):
    """Quantize a `RadVLM`'s projections in place, as the JAX package's
    `quantize_params` does with its default patterns: the decoder's
    attention and MLP projections (MPT's up / down too), the lm_head and
    the tower's attention projections and fc1 / fc2 (every tower kind: an
    EVA tower's swiglu w1 / w2 / w3, ImageBind's head, the resamplers and
    the projector are not matched) become `QLinear`; the token embedding
    becomes int8 with one scale per row. An MoE layer's router, expert
    tables and shared expert stay dense (the patterns name `mlp/gate|up|
    down` only, which an MoE tree does not have). With `bits=4` (W4A16)
    the layers' projections whose contraction dim divides by 128 become
    `Q4Linear` instead; the others (the SO400M tower's `fc2`, D = 4304),
    the lm_head and the embedding stay int8. The patch embedding, norms and
    biases stay as they are. Quantize before `fuse_for_inference`: as in
    the JAX package, fused `qkv` / `gateup` projections are not matched.
    Returns the model."""
    from radvlm_tpu_torch.models.layers import Linear, Q4Linear, QLinear

    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def swap(parent, names, bits=8):
        for name in names:
            lin = getattr(parent, name, None)
            if not isinstance(lin, Linear):
                continue
            if bits == 4 and lin.weight.shape[1] % GROUP == 0:
                setattr(parent, name, Q4Linear(*quantize_weight_int4(lin.weight.data), lin.bias))
            else:
                q, s = quantize_array(lin.weight.data)
                setattr(parent, name, QLinear(q, s[:, 0], lin.bias))

    text = model.text
    for blk in text.layers:
        swap(blk, ("q", "k", "v", "o", "gate", "up", "down"), bits)
    swap(text, ("lm_head",))
    if text.embed.dtype != torch.int8:
        q, s = quantize_array(text.embed.data)
        text.set_int8_embedding(q, s)
    for layer in model.vision_tower.layers:  # EVA's swiglu w1 / w2 / w3 stay dense
        swap(layer, ("q", "k", "v", "o", "fc1", "fc2"), bits)
    return model


def quantized_bytes(model) -> int:
    """Bytes of the model's parameters as they are stored (packed nibbles,
    int8 values, f32 scales, bf16 leaves)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())
