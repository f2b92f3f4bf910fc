"""W8A8 prefill matmul (K3), PyTorch side.

Counterpart of `radvlm_tpu/ops/w8a8_matmul.py`: `quantize_rows` (per-row
symmetric int8 activations) and `w8a8_matmul`, the int8 x int8 product with
an exact int32 sum and the two scales applied in f32,
y = (float(xq @ wq^T) * xs[row]) * ws[col]. The hand-written Hopper kernel
is `csrc/w8a8_matmul.cu`; it replaces the Pallas `w8a8_matmul_pallas`. The
JAX package's default emitter is XLA's s8 x s8 dot, which computes the same
product; the port has the kernel only.

`quantize_rows` stays plain PyTorch: an elementwise pass with a row
reduction, which XLA also fuses outside any Pallas kernel. It is bit-exact
with the JAX function: the scale is amax * float32(1/127) (a multiply, not a
division), `torch.round` rounds half to even as `jnp.round` does, and the
quotient is clipped to +-127.

Weights keep torch's [out, in] layout (K contiguous); the JAX package's
[in, out] kernels are transposed once by the weight bridge.
`w8a8_matmul_plain` is the plain version. The wrapper runs it only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radvlm_tpu_torch import kernels

# The f32 value of 1/127, as the JAX package's `_INV127`.
INV127 = float(np.float32(1.0 / 127.0))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (xq [..., D] int8, xs [..., 1] f32)."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV127
    xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
    return xq, xs


def w8a8_matmul_plain(
    xq: torch.Tensor,  # [M, K] int8
    xs: torch.Tensor,  # [M] f32
    wq: torch.Tensor,  # [N, K] int8
    ws: torch.Tensor,  # [N] f32
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of K3. The sum is taken in f64, which is exact here
    (|sum| < 2^53; an f32 matmul of int8 values is not exact past 2^24 and
    the down projection reaches ~3e8), then rounded to f32 as the kernel's
    int32 -> f32 conversion rounds it."""
    acc = torch.matmul(xq.double(), wq.double().t()).float()
    return ((acc * xs[:, None]) * ws[None, :]).to(out_dtype)


def w8a8_matmul(
    xq: torch.Tensor,  # [..., K] int8 (quantize_rows)
    xs: torch.Tensor,  # [..., 1] f32
    wq: torch.Tensor,  # [N, K] int8
    ws: torch.Tensor,  # [N] f32
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K3 wrapper: y [..., N] = (float(xq @ wq^T) * xs) * ws."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    n = wq.shape[0]
    x2, s2 = xq.reshape(-1, k), xs.reshape(-1)
    if xq.device.type == "cpu":
        return w8a8_matmul_plain(x2, s2.float(), wq, ws.float(), out_dtype).reshape(*lead, n)
    if wq.shape != (n, k) or ws.shape != (n,) or s2.shape != (x2.shape[0],):
        raise ValueError(
            f"w8a8_matmul: xq {tuple(xq.shape)} / xs {tuple(xs.shape)} do not match "
            f"wq {tuple(wq.shape)} / ws {tuple(ws.shape)}"
        )
    if out_dtype != torch.bfloat16:
        raise ValueError(f"w8a8_matmul: the kernel writes bf16, asked for {out_dtype}")
    if k % 16:
        raise ValueError(f"w8a8_matmul: the kernel takes K a multiple of 16, got K={k}")
    kernels.require_dtype("w8a8_matmul", torch.int8, xq=x2, wq=wq)
    kernels.require_dtype("w8a8_matmul", torch.float32, xs=s2, ws=ws)
    x2, s2 = x2.contiguous(), s2.contiguous()
    kernels.require_cuda_tensors("w8a8_matmul", x2, wq, align=16)
    kernels.require_cuda_tensors("w8a8_matmul", s2, ws)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    err = kernels.lib().radvlm_w8a8_matmul(
        x2.data_ptr(), s2.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
        m, n, k, kernels.stream_ptr(xq.device),
    )
    kernels.check(err, "w8a8_matmul")
    kernels.count_launch("w8a8_matmul")
    return out.reshape(*lead, n)
