"""Fused attention for the tower (K1) and the prefill (K2), PyTorch side.

Counterpart of `radvlm_tpu/ops/flash_attention.py`. The public
`flash_attention` keeps the JAX package's BSHD layout and sends each call to
one of two hand-written Hopper kernels (`csrc/flash_attention.cu`):

- K1 `tower_attention`, replacing `_fwd_short`: unmasked, non-causal
  self-attention with as many kv heads as query heads (`tower_eligible`, the
  counterpart of `_short_eligible`) - the SigLIP tower's 729-token tiles;
- K2 `prefill_attention`, replacing `_fwd` / `_fwd_kernel` (forward only):
  everything else - GQA, causal, segment ids (`q_seg == k_seg & q_seg != 0`).

`attention_plain` is the plain PyTorch version of both. A wrapper runs it
only for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises. The JAX package's 512-block sequence padding (`_pad_inputs`) has no
counterpart: the kernels mask ragged tails themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from radvlm_tpu_torch import kernels


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Plain version of K1/K2. q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D].

    f32 scores scaled after the dot; masked entries (causal, segment
    mismatch, segment 0) get p = 0; p is rounded to v's dtype before the PV
    product and l sums the unrounded p; a row with nothing to attend gives 0.
    Causal positions are absolute (query i sees keys <= i)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().transpose(1, 2)  # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    vf = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, Sq, Sk]
    mask = None
    if q_segment_ids is not None:
        mask = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]) & (
            q_segment_ids[:, :, None] != 0
        )
        mask = mask[:, None]
    if causal:
        tri = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device).tril()
        mask = tri[None, None] if mask is None else mask & tri
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vf.float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.transpose(1, 2).to(q.dtype)


def tower_eligible(
    q: torch.Tensor,
    k: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    causal: bool,
) -> bool:
    """K1 dispatch: unmasked non-causal self-attention, H == Hkv, Sq == Sk."""
    return (
        not causal
        and q_segment_ids is None
        and q.shape[2] == k.shape[2]
        and q.shape[1] == k.shape[1]
    )


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take bf16 q/k/v on the card with an even head_dim <= 128
    (padded inside to 64, 80 or 128)."""
    kernels.require_cuda_tensors(name, *tensors)
    for t in tensors[:3]:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16, got {t.dtype}")
    d = tensors[0].shape[-1]
    if d > 128 or d % 2:
        raise ValueError(f"{name}: the kernel takes an even head_dim <= 128, got {d}")


def tower_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """K1 wrapper. q/k/v [B, S, H, D] -> [B, S, H, D]."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, None, None, False, scale)
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"tower_attention: q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _require_cuda("tower_attention", q, k, v)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    err = kernels.lib().radvlm_tower_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, s, h, d, scale, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "tower_attention")
    kernels.count_launch("tower_attention")
    return o


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 wrapper. q [B,Sq,H,D], k/v [B,Sk,Hkv,D], segment ids [B,S] -> [B,Sq,H,D]."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"prefill_attention: bad k/v shapes {k.shape} {v.shape} for q {q.shape}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    segs = []
    if q_segment_ids is not None:
        segs = [
            q_segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous(),
        ]
        if segs[0].shape != (b, sq) or segs[1].shape != (b, sk):
            raise ValueError("prefill_attention: segment ids must be [B, Sq] and [B, Sk]")
    _require_cuda("prefill_attention", q, k, v, *segs)
    o = torch.empty_like(q)
    qseg_ptr, kseg_ptr = (segs[0].data_ptr(), segs[1].data_ptr()) if segs else (None, None)
    err = kernels.lib().radvlm_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qseg_ptr, kseg_ptr, o.data_ptr(),
        b, sq, sk, h, hkv, d, int(causal), scale, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "prefill_attention")
    kernels.count_launch("prefill_attention")
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention. q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D].

    Rows with nothing to attend (segment 0) come out as 0."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("provide both or neither of q/kv segment ids")
    if tower_eligible(q, k, q_segment_ids, causal):
        return tower_attention(q, k, v, scale=scale)
    return prefill_attention(
        q, k, v,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        causal=causal,
        scale=scale,
    )
