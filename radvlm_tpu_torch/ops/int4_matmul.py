"""Skinny int4-weight matmul for decode (K12), PyTorch side, and the int4
quantizer (counterpart of `radvlm_tpu/ops/int4_matmul.py`).

W4A16: weights are symmetric int4 in [-8, 7], two nibbles a byte, with one
f32 scale per group of 128 along the contraction axis and output column.
y = x @ bf16(nibble * scale): each weight is rounded to the activations'
dtype after its scale, products are summed in f32, the sum is rounded once.

Two layouts:

- the JAX package's, for the exchange with it (`pack_int4`, `unpack_int4`,
  `quantize_array_int4`, `dequantize_array_int4`): kernels [..., D, F],
  packed [..., D/2, F] int8 in the concat layout (byte i = row i in the low
  nibble, row i + D/2 in the high nibble), scales [..., D/128, F]. These
  functions are bit-exact with the JAX ones;
- the port's (`Q4Linear`, the K12 kernel): packed weight [F, D/2] uint8 in
  torch's [out, in] orientation, byte b of a row = k 2b in the low nibble and
  k 2b + 1 in the high one, so that a lane's 16-byte load is 32 consecutive
  k of one output column; scales keep the JAX layout [D/128, F].
  `repack_from_concat` / `repack_to_concat` convert one layer both ways
  without loss.

The hand-written Hopper kernel is `csrc/int4_matmul.cu`; it replaces the
Pallas `int4_matmul_stacked` (in PyTorch a layer's weight is its own
tensor, so there is no stacked variant). `int4_matmul_plain` is the plain
version. The wrapper runs it only for a tensor on the CPU; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops.int8_matmul import MAX_ROWS, split_plan

GROUP = 128  # k per scale group
_STAGE_K = 512  # the kernel's K a stage (4 groups): its K splits are whole stages


# --- the JAX package's layout: kernels [..., D, F] --------------------------

def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """[..., D, F] integers in [-8, 7] -> [..., D/2, F] int8, concat layout."""
    half = vals.shape[-2] // 2
    lo = vals[..., :half, :].to(torch.int32) & 0xF
    hi = vals[..., half:, :].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4`, sign-extended: [..., D/2, F] int8 -> [..., D, F]
    int8 values in [-8, 7]."""
    p = packed.view(torch.int8)
    lo = (p << 4) >> 4  # int8 arithmetic: the low nibble, sign-extended
    hi = p >> 4
    return torch.cat([lo, hi], dim=-2)


def quantize_array_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 with scale = max(amax / 7, 1e-12) per group of 128
    along the contraction axis (-2), round half to even, clip to [-8, 7]:
    x [..., D, F] -> (packed [..., D/2, F] int8, scale [..., D/128, F] f32)."""
    d, f = x.shape[-2], x.shape[-1]
    if d % GROUP:
        raise ValueError(f"int4 needs a contraction dim that divides by {GROUP}, got {d}")
    grouped = x.float().reshape(*x.shape[:-2], d // GROUP, GROUP, f)
    scale = (grouped.abs().amax(dim=-2, keepdim=True) / 7.0).clamp_min(1e-12)
    q = torch.round(grouped / scale).clamp_(-8, 7).to(torch.int8)
    return pack_int4(q.reshape(*x.shape[:-2], d, f)), scale[..., 0, :]


def dequantize_array_int4(packed: torch.Tensor, scale: torch.Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """(packed [..., D/2, F], scale [..., D/128, F]) -> [..., D, F] `dtype`."""
    q = unpack_int4(packed).float()
    group = q.shape[-2] // scale.shape[-2]
    return (q * scale.repeat_interleave(group, dim=-2)).to(dtype)


# --- the port's layout: weight [F, D/2] uint8, scale [D/128, F] -------------

def pack_rows(vals: torch.Tensor) -> torch.Tensor:
    """[F, D] integers in [-8, 7] -> [F, D/2] uint8: byte b = k 2b (low
    nibble), k 2b + 1 (high nibble)."""
    v = vals.to(torch.int32) & 0xF
    return (v[:, 0::2] | (v[:, 1::2] << 4)).to(torch.uint8)


def unpack_rows(weight: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_rows`, sign-extended: [F, D/2] uint8 -> [F, D] int8."""
    p = weight.view(torch.int8)
    return torch.stack([(p << 4) >> 4, p >> 4], dim=-1).reshape(weight.shape[0], -1)


def repack_from_concat(packed: torch.Tensor) -> torch.Tensor:
    """One layer of the JAX package's packed bytes [D/2, F] int8 -> the
    port's weight [F, D/2] uint8."""
    return pack_rows(unpack_int4(packed).t())


def repack_to_concat(weight: torch.Tensor) -> torch.Tensor:
    """Inverse of `repack_from_concat`: the same bytes the JAX package packed."""
    return pack_int4(unpack_rows(weight).t())


def quantize_weight_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A torch weight [F, D] -> (weight [F, D/2] uint8, scale [D/128, F] f32):
    `quantize_array_int4` of its transpose in the port's layout, value for
    value."""
    f, d = w.shape
    if d % GROUP:
        raise ValueError(f"int4 needs a contraction dim that divides by {GROUP}, got {d}")
    grouped = w.float().reshape(f, d // GROUP, GROUP)
    scale = (grouped.abs().amax(dim=-1, keepdim=True) / 7.0).clamp_min(1e-12)
    q = torch.round(grouped / scale).clamp_(-8, 7).to(torch.int8)
    return pack_rows(q.reshape(f, d)), scale[..., 0].t().contiguous()


def dequantize_weight_int4(weight: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.bfloat16) -> torch.Tensor:
    """(weight [F, D/2] uint8, scale [D/128, F]) -> [F, D] `dtype`: the f32
    product nibble * scale rounded once, as K12 rounds it."""
    f, groups = weight.shape[0], scale.shape[0]
    q = unpack_rows(weight).reshape(f, groups, -1).float()
    return q.mul_(scale.t()[:, :, None]).reshape(f, -1).to(dtype)


def int4_matmul_plain(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: the weights rounded to x's dtype after their
    scale, f32 sums, rounded once to x's dtype."""
    w = dequantize_weight_int4(weight, scale, x.dtype)
    return (x.float() @ w.float().t()).to(x.dtype)


def _splits(n: int, k: int, sms: int) -> Tuple[int, int]:
    """K12's plan (`int8_matmul.split_plan`, K5/K6's blocks and rule): whole
    512-k stages of the kernel, so whole 128-k scale groups, and no stage
    straddles a split."""
    return split_plan(n, k, sms, _STAGE_K)


def int4_matmul(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K12 wrapper: x [..., K] (at most 64 rows), weight [N, K/2] uint8,
    scale [K/128, N] f32 -> [..., N] in x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = weight.shape[0]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return int4_matmul_plain(x2, weight, scale).reshape(*lead, n)
    m = x2.shape[0]
    if k % GROUP or weight.shape != (n, k // 2) or scale.shape != (k // GROUP, n):
        raise ValueError(
            f"int4_matmul: x {tuple(x.shape)} does not match weight {tuple(weight.shape)} / "
            f"scale {tuple(scale.shape)} (K must divide by {GROUP})"
        )
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"int4_matmul: the kernel takes 1-{MAX_ROWS} rows, got {m}")
    kernels.require_dtype("int4_matmul", torch.bfloat16, x=x2)
    kernels.require_dtype("int4_matmul", torch.uint8, weight=weight)
    kernels.require_dtype("int4_matmul", torch.float32, scale=scale)
    x2 = x2.contiguous()
    kernels.require_cuda_tensors("int4_matmul", x2, weight, align=16)
    kernels.require_cuda_tensors("int4_matmul", scale)
    nsplit, k_per_split = _splits(n, k, kernels.sm_count(x.device))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = kernels.lib().radvlm_int4_matmul(
        x2.data_ptr(), weight.data_ptr(), scale.data_ptr(), out.data_ptr(), None,
        m, n, k, nsplit, k_per_split, kernels.stream_ptr(x.device),
    )
    kernels.check(err, "int4_matmul")
    kernels.count_launch("int4_matmul")
    return out.reshape(*lead, n)
