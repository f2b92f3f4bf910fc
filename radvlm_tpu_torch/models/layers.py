"""Small building blocks shared by the port's models.

Parameters are created uninitialised (`torch.empty`) on the requested device
and dtype: weights come from the weight bridge (`models/convert.py`), either
from the JAX package's parameter tree or from a seeded random init, so no
time is spent on an init that is overwritten. They never require grad: the
port serves inference only so far.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from radvlm_tpu_torch.ops.quant import qmm


def empty_param(*shape: int, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Linear(nn.Module):
    """y = x W^T + b with W [out, in] (torch layout). A plain large matrix
    product: it stays `torch.nn.functional.linear` (cuBLAS on the card)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, *, device=None, dtype=None) -> "Linear":
        w = torch.empty((d_out, d_in), device=device, dtype=dtype)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


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

    @classmethod
    def empty(cls, d_in: int, d_out: int, bias: bool, *, device=None, dtype=None) -> "QLinear":
        """Uninitialised; `dtype` is the bias's."""
        w = torch.empty((d_out, d_in), device=device, dtype=torch.int8)
        s = torch.empty((d_out,), device=device, dtype=torch.float32)
        b = torch.empty((d_out,), device=device, dtype=dtype) if bias else None
        return cls(w, s, b)

    def forward(self, x: torch.Tensor, w8a8: Optional[bool] = None) -> torch.Tensor:
        return qmm(x, self.weight, self.scale, self.bias, w8a8=w8a8)


def fuse_linears(parts: Sequence[nn.Module]) -> nn.Module:
    """Concatenate Linears (or QLinears: weights and their per-channel
    scales alike) along the output axis - one launch instead of n."""
    w = torch.cat([p.weight for p in parts], dim=0)
    b = None
    if parts[0].bias is not None:
        b = torch.cat([p.bias for p in parts], dim=0)
    if isinstance(parts[0], QLinear):
        return QLinear(w, torch.cat([p.scale for p in parts], dim=0), b)
    return Linear(w, b)
