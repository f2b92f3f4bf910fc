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
_BLOCK_N = 64  # the kernel's output columns a work unit
_STEP_K = 64  # K splits are whole 64-wide steps
_MAX_SPLIT = 8  # a K split is one CTA of a thread-block cluster (portable size)


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K5/K6: f32 sums of x times the int8 values, times
    scale per output column, rounded once to x's dtype."""
    return ((x.float() @ w.float().t()) * scale.float()).to(x.dtype)


def split_plan(n: int, k: int, sms: int, step: int) -> Tuple[int, int]:
    """(nsplit, k_per_split): the K split of a skinny decode matmul (K5/K6,
    K12) for a weight of N output columns and K inputs on a card of `sms`
    SMs, in whole `step`s of K. The work units are 64-column blocks x K
    splits, and the kernels run one CTA an SM. With fewer blocks than SMs, K
    is split in 2, 4 or 8 while the units still fit on the SMs at once (one
    unit a CTA, the splits of a block one cluster); with more, persistent
    CTAs walk the blocks whole. Depends on N, K and the SM count only, never
    on the row count, so a row's sums do not depend on how many rows come
    with it."""
    blocks = -(-n // _BLOCK_N)
    steps = -(-k // step)
    nsplit = 1
    while 2 * nsplit <= min(_MAX_SPLIT, steps) and 2 * nsplit * blocks <= sms:
        nsplit *= 2
    per = -(-steps // nsplit)
    return -(-steps // per), per * step


def _splits(n: int, k: int, sms: int) -> Tuple[int, int]:
    """K5/K6's plan: whole 64-wide steps of K."""
    return split_plan(n, k, sms, _STEP_K)


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
    nsplit, k_per_split = _splits(n, k, kernels.sm_count(x.device))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = kernels.lib().radvlm_int8_matmul(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), None,
        m, n, k, nsplit, k_per_split, kernels.stream_ptr(x.device),
    )
    kernels.check(err, "int8_matmul")
    kernels.count_launch("int8_matmul")
    return out.reshape(*lead, n)
