"""Fused attention for the tower (K1), the prefill (K2) and, under a
gradient, K2 with its lse and the backward kernels K7 / K8; PyTorch side.

Counterpart of `radvlm_tpu/ops/flash_attention.py`. The public
`flash_attention` and `flash_attention_with_lse` keep the JAX package's BSHD
layout and send each call to the hand-written Hopper kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`):

- K1 `tower_attention`, replacing `_fwd_short`: unmasked, non-causal
  self-attention with as many kv heads as query heads (`tower_eligible`, the
  counterpart of `_short_eligible`) - the SigLIP tower's 729-token tiles,
  where no input needs a gradient;
- K2 `prefill_attention`, replacing `_fwd` / `_fwd_kernel`: everything else
  without a gradient - GQA, causal, segment ids (`q_seg == k_seg & q_seg !=
  0`); `prefill_attention_lse` is the same kernel writing the f32 lse too;
- under a gradient (any of q, k, v requires one) every call, the tower's
  included, goes through one `torch.autograd.Function`: K2 with the lse
  forward, K7 `flash_attention_bwd_dkv` (replacing `_bwd_dkv_kernel`) and K8
  `flash_attention_bwd_dq` (replacing `_bwd_dq_kernel`) backward, as the JAX
  package's `_flash_fwd` always takes `_fwd`.

`attention_plain` is the plain PyTorch version of the forwards and
`attention_backward_plain` of the backward (the FA2 formulas written out,
no `torch.autograd`). A wrapper runs the plain version only for a tensor on
the CPU; on a CUDA tensor it launches its kernel or raises. The kernels take
bf16: under a gradient on the card `flash_attention` casts other dtypes to
bf16 and the result back (the trainer keeps f32 master weights). The JAX
package's 512-block sequence padding (`_pad_inputs`) has no counterpart: the
kernels mask ragged tails themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    with_lse: bool = False,
):
    """Plain version of K1/K2. q [B,Sq,H,D], k/v [B,Sk,Hkv,D] -> [B,Sq,H,D],
    and with `with_lse` also the f32 logsumexp of the scaled scores
    [B,H,Sq].

    f32 scores scaled after the dot; masked entries (causal, segment
    mismatch, segment 0) get p = 0; p is rounded to v's dtype before the PV
    product and l sums the unrounded p; a row with nothing to attend gives 0
    and lse = -inf. Causal positions are absolute (query i sees keys <= i)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().transpose(1, 2)  # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    vf = v.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, Sq, Sk]
    mask = _mask(q_segment_ids, kv_segment_ids, causal, sq, k.shape[1], q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vf.float())
    o = (o / torch.where(l == 0, torch.ones_like(l), l)).transpose(1, 2).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(torch.where(l == 0, torch.ones_like(l), l)))
    return o, lse[..., 0]


def _mask(q_segment_ids, kv_segment_ids, causal: bool, sq: int, sk: int, device):
    """Boolean [B or 1, 1, Sq, Sk], True = attend; None when nothing is masked."""
    mask = None
    if q_segment_ids is not None:
        mask = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]) & (
            q_segment_ids[:, :, None] != 0
        )
        mask = mask[:, None]
    if causal:
        tri = torch.ones(sq, sk, dtype=torch.bool, device=device).tril()
        mask = tri[None, None] if mask is None else mask & tri
    return mask


def attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    dlse: Optional[torch.Tensor],
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7/K8: the flash-attention-2 backward written out.

    q/o/do [B,Sq,H,D], k/v [B,Sk,Hkv,D], lse/dlse [B,H,Sq] f32 -> (dq, dk, dv)
    in the shapes and dtypes of q, k, v. p = exp(s - lse) is recomputed from
    the f32 scores scaled after the dot and SELECTED to 0 under the mask (a
    row with lse = -inf would otherwise give inf); delta = rowsum(do * o) -
    dlse; dv = p^T do; dp = do v^T; ds = p (dp - delta) scale; dk = ds^T q;
    dq = ds k. p and ds are rounded to the inputs' dtype before their
    products, where the kernels round them to bf16 (no rounding for f32
    inputs); dk and dv sum over each GQA group in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().transpose(1, 2)  # [B, H, Sq, D]
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    dof = do.float().transpose(1, 2)
    delta = attention_delta(o, do, dlse)  # [B, H, Sq]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    mask = _mask(q_segment_ids, kv_segment_ids, causal, sq, sk, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    del s
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)  # [B, H, Sk, D]
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    del p, dp
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    dk = dk.reshape(b, hkv, g, sk, d).sum(2)
    dv = dv.reshape(b, hkv, g, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def tower_eligible(
    q: torch.Tensor,
    k: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    causal: bool,
    needs_grad: bool = False,
) -> bool:
    """K1 dispatch: unmasked non-causal self-attention, H == Hkv, Sq == Sk,
    and no gradient asked (K1 writes no lse, which the backward reads)."""
    return (
        not needs_grad
        and not causal
        and q_segment_ids is None
        and q.shape[2] == k.shape[2]
        and q.shape[1] == k.shape[1]
    )


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[-1] ** -0.5 if scale is None else scale)


MAX_HEAD_DIM = 128  # the widest head K1 / K2 / K7 / K8 take


def kernel_takes(head_dim: int) -> bool:
    """The head dims K1 / K2 / K7 / K8 take: even and at most 128 (padded
    inside to a multiple of 16). The wrappers raise on a CUDA tensor outside
    it, and `ops.attention.flash_eligible` routes such a call to the plain
    path."""
    return head_dim <= MAX_HEAD_DIM and head_dim % 2 == 0


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take bf16 q/k/v on the card with a head dim that
    `kernel_takes`."""
    kernels.require_cuda_tensors(name, *tensors)
    for t in tensors[:3]:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16, got {t.dtype}")
    d = tensors[0].shape[-1]
    if not kernel_takes(d):
        raise ValueError(
            f"{name}: the kernel takes an even head_dim <= {MAX_HEAD_DIM}, got {d}")


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


def _prefill_inputs(name, q, k, v, q_segment_ids, kv_segment_ids):
    """Shape checks shared by K2, K7 and K8: contiguous q/k/v and int32
    segment ids (a list of two, or empty)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: bad k/v shapes {k.shape} {v.shape} for q {q.shape}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    segs = []
    if q_segment_ids is not None:
        segs = [
            q_segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous(),
        ]
        if segs[0].shape != (b, sq) or segs[1].shape != (b, sk):
            raise ValueError(f"{name}: segment ids must be [B, Sq] and [B, Sk]")
    _require_cuda(name, q, k, v, *segs)
    return q, k, v, segs


def _seg_ptrs(segs):
    return (segs[0].data_ptr(), segs[1].data_ptr()) if segs else (None, None)


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
    q, k, v, segs = _prefill_inputs("prefill_attention", q, k, v, q_segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    qseg_ptr, kseg_ptr = _seg_ptrs(segs)
    err = kernels.lib().radvlm_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qseg_ptr, kseg_ptr, o.data_ptr(),
        b, sq, sk, h, hkv, d, int(causal), scale, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "prefill_attention")
    kernels.count_launch("prefill_attention")
    return o


def prefill_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper with the lse: (o [B,Sq,H,D], lse [B,H,Sq] f32, -inf on a
    row with nothing to attend). o equals `prefill_attention`'s bit for bit."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, q_segment_ids, kv_segment_ids, causal, scale,
                               with_lse=True)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q, k, v, segs = _prefill_inputs("prefill_attention_lse", q, k, v,
                                    q_segment_ids, kv_segment_ids)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    qseg_ptr, kseg_ptr = _seg_ptrs(segs)
    err = kernels.lib().radvlm_prefill_attention_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qseg_ptr, kseg_ptr, o.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, hkv, d, int(causal), scale,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, "prefill_attention_lse")
    kernels.count_launch("prefill_attention_lse")
    return o, lse


def attention_delta(o: torch.Tensor, do: torch.Tensor,
                    dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """delta = rowsum(do * o) - dlse, f32 [B,H,Sq]: plain PyTorch, as the JAX
    package leaves it to XLA outside its kernels."""
    # o promotes to f32 inside the product (exact), so only do is copied.
    delta = (do.float() * o).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _bwd_inputs(name, q, k, v, q_segment_ids, kv_segment_ids, do, lse, delta):
    q, k, v, segs = _prefill_inputs(name, q, k, v, q_segment_ids, kv_segment_ids)
    b, sq, h, _ = q.shape
    do, lse, delta = do.contiguous(), lse.contiguous(), delta.contiguous()
    kernels.require_cuda_tensors(name, do, lse, delta)
    kernels.require_dtype(name, torch.bfloat16, do=do)
    kernels.require_dtype(name, torch.float32, lse=lse, delta=delta)
    if do.shape != q.shape or lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError(f"{name}: do must be q's shape and lse / delta [B, H, Sq], got "
                         f"{tuple(do.shape)} {tuple(lse.shape)} {tuple(delta.shape)}")
    return q, k, v, segs, do, lse, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, q_segment_ids=None,
                            kv_segment_ids=None, causal: bool = False,
                            scale: Optional[float] = None):
    """K7 wrapper: (dk, dv) [B,Sk,Hkv,D] in k's dtype, summed over each GQA
    group inside the kernel. `delta` is `attention_delta`'s [B,H,Sq]. On CPU
    tensors this is `attention_backward_plain` given delta as -dlse on a zero
    o (the same delta)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return _backward_plain_delta(q, k, v, q_segment_ids, kv_segment_ids, lse, do, delta,
                                     causal, scale)[1:]
    q, k, v, segs, do, lse, delta = _bwd_inputs(
        "flash_attention_bwd_dkv", q, k, v, q_segment_ids, kv_segment_ids, do, lse, delta)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    qseg_ptr, kseg_ptr = _seg_ptrs(segs)
    err = kernels.lib().radvlm_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qseg_ptr, kseg_ptr, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, hkv, d, int(causal), scale, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "flash_attention_bwd_dkv")
    kernels.count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, q_segment_ids=None,
                           kv_segment_ids=None, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """K8 wrapper: dq [B,Sq,H,D] in q's dtype."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return _backward_plain_delta(q, k, v, q_segment_ids, kv_segment_ids, lse, do, delta,
                                     causal, scale)[0]
    q, k, v, segs, do, lse, delta = _bwd_inputs(
        "flash_attention_bwd_dq", q, k, v, q_segment_ids, kv_segment_ids, do, lse, delta)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    qseg_ptr, kseg_ptr = _seg_ptrs(segs)
    err = kernels.lib().radvlm_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qseg_ptr, kseg_ptr, do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, sq, sk, h, hkv, d, int(causal), scale, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "flash_attention_bwd_dq")
    kernels.count_launch("flash_attention_bwd_dq")
    return dq


def _backward_plain_delta(q, k, v, q_segment_ids, kv_segment_ids, lse, do, delta, causal, scale):
    """`attention_backward_plain` from a ready delta: with o = 0 its
    rowsum(do * o) vanishes and dlse = -delta gives delta back."""
    return attention_backward_plain(q, k, v, q_segment_ids, kv_segment_ids,
                                    torch.zeros_like(do), lse, do, -delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the hand-written backward. CUDA tensors: K2 with the lse
    forward, K7 and K8 backward. CPU tensors: the plain forward and
    `attention_backward_plain`. Saves (q, k, v, segment ids, o, lse), as the
    JAX package's `_flash_fwd` does."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
        o, lse = prefill_attention_lse(q, k, v, q_segment_ids=q_segment_ids,
                                       kv_segment_ids=kv_segment_ids, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, qseg, kseg, o, lse = ctx.saved_tensors
        if do is None:  # only the lse was used
            do = torch.zeros_like(o)
        kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg, causal=ctx.causal, scale=ctx.scale)
        if q.device.type == "cpu":
            dq, dk, dv = attention_backward_plain(q, k, v, qseg, kseg, o, lse, do, dlse,
                                                  ctx.causal, ctx.scale)
        else:
            delta = attention_delta(o, do, dlse)
            do = do.to(q.dtype)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention returning (out [B,Sq,H,D], lse [B,H,Sq] f32); a row
    with nothing to attend has lse = -inf and zero output. Differentiable in
    both outputs: the lse cotangent folds into delta."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("provide both or neither of q/kv segment ids")
    scale = _scale(q, scale)
    dtype = q.dtype
    if q.device.type != "cpu" and dtype != torch.bfloat16 and _needs_grad(q, k, v):
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, bool(causal), scale)
    return o.to(dtype), lse


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

    Rows with nothing to attend (segment 0) come out as 0. Where any of q, k,
    v needs a gradient the call goes through `_FlashAttention` (K2 with the
    lse, K7 and K8 backward), the tower's too; otherwise to K1 or K2."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("provide both or neither of q/kv segment ids")
    needs_grad = _needs_grad(q, k, v)
    if tower_eligible(q, k, q_segment_ids, causal, needs_grad):
        return tower_attention(q, k, v, scale=scale)
    if needs_grad:
        return flash_attention_with_lse(
            q, k, v, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            causal=causal, scale=scale)[0]
    return prefill_attention(
        q, k, v,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        causal=causal,
        scale=scale,
    )
