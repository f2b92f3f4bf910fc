"""Skinny int8-weight matmul for decode (K5/K6), PyTorch side.

Counterpart of `radvlm_tpu/ops/int8_matmul.py`: y = (x @ w^T) * scale with
bf16 activations of at most 64 rows and int8 weights streamed once,
dequantized in registers. The Pallas package has two entry points, a
stacked one whose layer index is scalar-prefetched (`int8_matmul_stacked`,
the decode layers' projections) and a flat one (`int8_matmul`, the
lm_head); in PyTorch a layer's weight is its own tensor (or a free view), so
one hand-written kernel (`csrc/int8_matmul.cu`) serves both callers.

`int8_matmul_plain` is the plain version. The wrapper runs it only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from radvlm_tpu_torch import kernels

MAX_ROWS = 64  # the kernel's row limit, and quant.qmm's dispatch bound
_BLOCK_N = 128  # the kernel's columns per CTA
_STEP_K = 64  # the kernel's K per step; K splits are whole steps


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K5/K6: f32 sums of x times the int8 values, times
    scale per output column, rounded once to x's dtype."""
    return ((x.float() @ w.float().t()) * scale.float()).to(x.dtype)


def _splits(n: int, k: int, device: torch.device) -> Tuple[int, int]:
    """(nsplit, k_per_split): split K over enough CTAs for ~2 per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cols = -(-n // _BLOCK_N)
    steps = -(-k // _STEP_K)
    nsplit = max(1, min(-(-2 * sms // cols), steps))
    per = -(-steps // nsplit)
    return -(-steps // per), per * _STEP_K


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K5/K6 wrapper: x [..., K] (at most 64 rows), w [N, K] int8, scale [N]
    f32 -> [..., N] in x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = w.shape[0]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return int8_matmul_plain(x2, w, scale).reshape(*lead, n)
    m = x2.shape[0]
    if w.shape != (n, k) or scale.shape != (n,):
        raise ValueError(
            f"int8_matmul: x {tuple(x.shape)} does not match w {tuple(w.shape)} / "
            f"scale {tuple(scale.shape)}"
        )
    if not 1 <= m <= MAX_ROWS or k % 16:
        raise ValueError(
            f"int8_matmul: the kernel takes 1-{MAX_ROWS} rows and K a multiple of 16, "
            f"got {m} rows, K={k}"
        )
    kernels.require_dtype("int8_matmul", torch.bfloat16, x=x2)
    kernels.require_dtype("int8_matmul", torch.int8, w=w)
    kernels.require_dtype("int8_matmul", torch.float32, scale=scale)
    x2 = x2.contiguous()
    kernels.require_cuda_tensors("int8_matmul", x2, w, align=16)
    kernels.require_cuda_tensors("int8_matmul", scale)
    nsplit, k_per_split = _splits(n, k, x.device)
    part = (torch.empty((nsplit, m, n), dtype=torch.float32, device=x.device)
            if nsplit > 1 else None)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = kernels.lib().radvlm_int8_matmul(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, n, k, nsplit, k_per_split,
        kernels.stream_ptr(x.device),
    )
    kernels.check(err, "int8_matmul")
    kernels.count_launch("int8_matmul")
    return out.reshape(*lead, n)
