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


def fuse_linears(parts: Sequence[Linear]) -> Linear:
    """Concatenate Linears along the output axis (one launch instead of n)."""
    w = torch.cat([p.weight for p in parts], dim=0)
    b = None
    if parts[0].bias is not None:
        b = torch.cat([p.bias for p in parts], dim=0)
    return Linear(w, b)
