"""Weight-only int8 quantization and the quantized matmul dispatch
(counterpart of `radvlm_tpu/ops/quant.py`).

Quantized projections are `models.layers.QLinear` modules: int8 weight
[out, in] with one f32 scale per output channel (the JAX package's
{"__q__", "__scale__"} node, transposed). `qmm` is their forward and
dispatches as the JAX `quant.qmm` does (`qmm_route` is the one predicate,
which `generation.engine.kernel_provenance` also calls):

- more than 64 rows with W8A8 on: `quantize_rows`, then the K3 kernel;
- 64 rows or fewer: the K5/K6 kernel (weights streamed as int8);
- otherwise (the lm_head passes w8a8=False; RADVLM_W8A8=0): dequantize and
  one plain large matmul, which XLA also runs outside Pallas.

Not ported here (they raise in the weight bridge or have no counterpart):
the training-mode dequant path and LoRA adapters (ROADMAP M11), int4
weights (ROADMAP M9). The JAX package's `qmm_idx` (a stacked weight and a
layer index) needs no counterpart: a layer's weight is its own tensor.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from radvlm_tpu_torch.ops.int8_matmul import MAX_ROWS, int8_matmul
from radvlm_tpu_torch.ops.w8a8_matmul import quantize_rows, w8a8_matmul



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


def qmm_route(rows: int, w8a8: Optional[bool] = None) -> str:
    """Where a quantized matmul of `rows` activation rows goes: "w8a8"
    (K3), "int8" (K5/K6) or "dequant" (plain). The one dispatch predicate."""
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
    if route == "w8a8":
        xq, xs = quantize_rows(x)
        y = w8a8_matmul(xq, xs, weight, scale, out_dtype=x.dtype)
    elif route == "int8":
        y = int8_matmul(x, weight, scale)
    else:
        y = F.linear(x, dequantize_array(weight, scale[:, None], x.dtype))
    return y if bias is None else y + bias


def quantize_model(model):
    """Quantize a `RadVLM`'s projections in place, as the JAX package's
    `quantize_params` does with its default patterns: the decoder's
    attention and MLP projections, the lm_head and the SigLIP tower's
    projections become `QLinear`; the token embedding becomes int8 with one
    scale per row. The projector, the patch embedding, norms and biases stay
    as they are. Quantize before `fuse_for_inference`: as in the JAX
    package, fused `qkv` / `gateup` projections are not matched. Returns the
    model."""
    from radvlm_tpu_torch.models.layers import Linear, QLinear

    def swap(parent, names):
        for name in names:
            lin = getattr(parent, name, None)
            if isinstance(lin, Linear):
                q, s = quantize_array(lin.weight.data)
                setattr(parent, name, QLinear(q, s[:, 0], lin.bias))

    text = model.text
    for blk in text.layers:
        swap(blk, ("q", "k", "v", "o", "gate", "up", "down"))
    swap(text, ("lm_head",))
    if text.embed.dtype != torch.int8:
        q, s = quantize_array(text.embed.data)
        text.set_int8_embedding(q, s)
    for layer in getattr(model.vision_tower, "layers", ()):
        if hasattr(layer, "fc1"):  # the SigLIP tower
            swap(layer, ("q", "k", "v", "o", "fc1", "fc2"))
    return model
