"""int8-compressed gradient all-reduce, ZeRO++'s qgZ (counterpart of
`radvlm_tpu/parallel/compression.py`).

The reference's ZeRO++ config turns on quantized gradient reduction
(`finetuning/scripts/zero3pp.json`: `zero_quantized_gradients`). Where a
data-parallel sync crosses a slow link (between hosts), wire bytes dominate,
and `quantized_psum` sums over a process group with the qgZ wire pattern:

1. blockwise int8 quantization of the local tensor (one f32 scale a block);
2. `all_to_all_single`: each rank receives only ITS chunk from every peer,
   int8 on the wire (about a quarter of the bytes of a bf16 ring
   all-reduce's two passes);
3. dequantize and sum the chunk in f32;
4. re-quantize the summed chunk and `all_gather_into_tensor` it back
   (int8 again).

Two quantization stages bound the relative error at about 1/127 each (the
tests hold the sum within 1.6e-2 of the exact one). As in the JAX package,
no driver calls it: an exact all-reduce inside a host stays the default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _quantize_blocks(x: torch.Tensor, block: int):
    """x [..., C] with C % block == 0 -> (int8 [..., C], f32 scales
    [..., C/block, 1]). Multiplies by the f32 1/127 and rounds half to even,
    as the JAX package does."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], shape[-1] // block, block).float()
    s = torch.clamp_min(xb.abs().amax(dim=-1, keepdim=True), 1e-12) * _INV127.to(x.device)
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return q.reshape(shape), s


def _dequantize_blocks(q: torch.Tensor, s: torch.Tensor, block: int) -> torch.Tensor:
    shape = q.shape
    qb = q.reshape(*shape[:-1], shape[-1] // block, block).float()
    return (qb * s).reshape(shape)


def quantized_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None, *,
                   block: int = 512) -> torch.Tensor:
    """The sum of `x` over `group` with an int8 wire format; every rank gets
    the same result, in x's dtype. Relative error within the two blockwise
    int8 stages (~1.6e-2 worst case)."""
    r = dist.get_world_size(group)
    if r == 1:
        return x
    orig_dtype, orig_shape = x.dtype, x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = -n % (r * block)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(r, -1)  # row j = the chunk rank j will own
    q, s = _quantize_blocks(chunks, block)
    # each rank receives its own chunk from every peer (int8 wire)
    q_mine, s_mine = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_mine, q.contiguous(), group=group)
    dist.all_to_all_single(s_mine, s.contiguous(), group=group)
    reduced = _dequantize_blocks(q_mine, s_mine, block).sum(dim=0)  # [c] f32
    qr, sr = _quantize_blocks(reduced[None], block)
    q_all = qr.new_empty((r,) + tuple(qr.shape[1:]))
    s_all = sr.new_empty((r,) + tuple(sr.shape[1:]))
    dist.all_gather_into_tensor(q_all, qr.contiguous(), group=group)  # int8 wire
    dist.all_gather_into_tensor(s_all, sr.contiguous(), group=group)
    out = _dequantize_blocks(q_all, s_all, block).reshape(-1)
    if pad:
        out = out[:n]
    return out.reshape(orig_shape).to(orig_dtype)


def quantized_pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None, *,
                    block: int = 512) -> torch.Tensor:
    return quantized_psum(x, group, block=block) / dist.get_world_size(group)


def quantized_grad_sync(grads: Dict[str, torch.Tensor],
                        group: Optional[dist.ProcessGroup] = None, *,
                        block: int = 512) -> Dict[str, torch.Tensor]:
    """`quantized_pmean` of every gradient: data-parallel averaging with
    int8 wire bytes (the ZeRO++ qgZ role)."""
    return {k: quantized_pmean(g, group, block=block) for k, g in grads.items()}
