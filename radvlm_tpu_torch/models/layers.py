"""Small building blocks shared by the port's models.

Parameters are created uninitialised (`torch.empty`) on the requested device
and dtype: weights come from the weight bridge (`models/convert.py`), either
from the JAX package's parameter tree or from a seeded random init, so no
time is spent on an init that is overwritten. They are made with
`requires_grad=False` (inference); the trainer turns gradients on for the
tunable groups of an f32 model (`training.optimizer.mark_trainable`).

LoRA: `training.lora.merge_lora` attaches stacked adapters to a `Linear` or
`QLinear` as `lora = (a [L, in, r], b [L, r, out], layer, scaling)`. A dense
`Linear` then multiplies by W + scaling * (a b)^T, as the JAX package merges
the delta into the kernel; a `QLinear` adds (x a) (scaling * b) beside the
quantized matmul, so the int8 base never dequantizes into residency.
Under tensor parallelism a projection holds a slice (`tp_part`, set by
`parallel.tp`), and its adapter's matching slice is applied: b's output
columns for a column-parallel projection, a's input rows for a row-parallel
one (`lora_factors`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from radvlm_tpu_torch.ops.int4_matmul import GROUP
from radvlm_tpu_torch.ops.quant import q4mm, qmm


def empty_param(*shape: int, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Elsewhere(nn.Module):
    """A decoder layer that another pipeline stage holds
    (`parallel/pp.py`): it keeps the layer's place in `layers`, so every
    held layer keeps its global index and name, and has no parameters."""


def lora_factors(lin: nn.Module):
    """(a [in, r], b [r, out], scaling) of the adapter attached to `lin`,
    the part of them that matches its tensor-parallel slice (`tp_part` =
    ("out" | "in", ranks, rank)); differentiable in the adapters."""
    a, b, layer, scaling = lin.lora
    a, b = a[layer], b[layer]
    part = getattr(lin, "tp_part", None)
    if part is not None:
        side, n, rank = part
        if side == "out":
            w = b.shape[1] // n
            b = b.narrow(1, rank * w, w)
        else:
            w = a.shape[0] // n
            a = a.narrow(0, rank * w, w)
    return a, b, scaling


class Linear(nn.Module):
    """y = x W^T + b with W [out, in] (torch layout). A plain large matrix
    product: it stays `torch.nn.functional.linear` (cuBLAS on the card)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.lora = None  # (a, b, layer, scaling) while adapters are attached

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, *, device=None, dtype=None) -> "Linear":
        w = torch.empty((d_out, d_in), device=device, dtype=dtype)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight
        if self.lora is not None:
            a, b, scaling = lora_factors(self)
            weight = (weight + scaling * torch.matmul(a, b).t()).to(weight.dtype)
        return F.linear(x, weight, self.bias)


class QLinear(nn.Module):
    """y = x dequant(W)^T + b with W int8 [out, in] (torch's layout, K
    contiguous for both int8 kernels), one f32 scale per output channel
    [out] and an optional bias: the JAX package's {"__q__", "__scale__"}
    node. Its forward is `ops.quant.qmm`, which picks K3, K5/K6 or a plain
    dequantized matmul by row count (`w8a8=False` keeps the activations
    unquantized, as the lm_head asks)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        if weight.dtype != torch.int8 or scale.shape != weight.shape[:1]:
            raise ValueError(
                f"QLinear: int8 weight [out, in] and scale [out], got {weight.dtype} "
                f"{tuple(weight.shape)} and {tuple(scale.shape)}"
            )
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.scale = nn.Parameter(scale.float(), requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.lora = None  # (a, b, layer, scaling) while adapters are attached

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, *, device=None, dtype=None) -> "QLinear":
        """Uninitialised; `dtype` is the bias's."""
        w = torch.empty((d_out, d_in), device=device, dtype=torch.int8)
        s = torch.empty((d_out,), device=device, dtype=torch.float32)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, s, b)

    def forward(self, x: torch.Tensor, w8a8: Optional[bool] = None) -> torch.Tensor:
        y = qmm(x, self.weight, self.scale, None, w8a8=w8a8)
        if self.lora is not None:
            a, b, scaling = lora_factors(self)
            low = torch.matmul(torch.matmul(x, a.to(x.dtype)),
                               (scaling * b).to(b.dtype).to(x.dtype))
            y = y + low.to(y.dtype)
        return y if self.bias is None else y + self.bias


class Q4Linear(nn.Module):
    """y = x dequant4(W)^T + b with W int4, two nibbles a byte: weight
    [out, in/2] uint8 (byte b of a row = k 2b in the low nibble, k 2b + 1 in
    the high one), one f32 scale per group of 128 along `in` and output
    channel [in/128, out], and an optional bias: the JAX package's
    {"__q4__", "__scale__"} node, repacked by the weight bridge. Its forward
    is `ops.quant.q4mm`: K12 for at most 64 rows, else the weights
    dequantized to the activations' dtype and one plain matmul. Activations
    are never quantized (W4A16)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        d_out, d_in = weight.shape[0], 2 * weight.shape[1]
        if (weight.dtype != torch.uint8 or d_in % GROUP
                or scale.shape != (d_in // GROUP, d_out)):
            raise ValueError(
                f"Q4Linear: uint8 weight [out, in/2] with in a multiple of {GROUP} and "
                f"scale [in/{GROUP}, out], got {weight.dtype} {tuple(weight.shape)} and "
                f"{tuple(scale.shape)}"
            )
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.scale = nn.Parameter(scale.float(), requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, *, device=None, dtype=None) -> "Q4Linear":
        """Uninitialised; `dtype` is the bias's."""
        w = torch.empty((d_out, d_in // 2), device=device, dtype=torch.uint8)
        s = torch.empty((d_in // GROUP, d_out), device=device, dtype=torch.float32)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, s, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return q4mm(x, self.weight, self.scale, self.bias)


def fuse_linears(parts: Sequence[nn.Module]) -> nn.Module:
    """Concatenate Linears (or QLinears / Q4Linears: weights and their
    scales alike) along the output axis - one launch instead of n. The
    parts are of one kind: projections that fuse share their input width."""
    kind = type(parts[0])
    w = torch.cat([p.weight for p in parts], dim=0)
    b = None
    if parts[0].bias is not None:
        b = torch.cat([p.bias for p in parts], dim=0)
    if kind is Q4Linear:  # group scales [in/128, out]: the output axis is last
        return Q4Linear(w, torch.cat([p.scale for p in parts], dim=1), b)
    if kind is QLinear:
        return QLinear(w, torch.cat([p.scale for p in parts], dim=0), b)
    return Linear(w, b)
