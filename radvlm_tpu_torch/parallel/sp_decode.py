"""Sequence-parallel DECODE: the KV cache split over the `seq` group
(counterpart of `radvlm_tpu/parallel/sp_decode.py`).

At long multimodal contexts the KV cache dominates device memory, so it
lives sequence-sharded: rank i of the group owns cache rows
[i*S/n, (i+1)*S/n). Each decode step

1. computes the new token's q/k/v on every rank (weights replicated);
2. writes k/v on the OWNING rank only (global write index -> local offset;
   ranks out of range keep their row);
3. attends over the local cache block with a log-sum-exp, then merges
   across ranks with one all_reduce(MAX) and two all_reduce(SUM): the
   distributed flash-decoding merge (softmax(QK^T)V over a split K/V is the
   lse-weighted average of the ranks' partial outputs).

`active(group)` turns the route on;
`qwen2._block_cached` then calls `block_attention` for its cached
attention, over the bf16 or the int8 cache. `make_sp_decode_step` is one
such step.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from radvlm_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv_row

# A ContextVar like the TP context: a fleet thread must not see another
# thread's split cache.
_SP_GROUP: "contextvars.ContextVar[Optional[dist.ProcessGroup]]" = contextvars.ContextVar(
    "radvlm_sp_decode_group", default=None)


def context() -> Optional[dist.ProcessGroup]:
    return _SP_GROUP.get()


@contextlib.contextmanager
def active(group):
    token = _SP_GROUP.set(group)
    try:
        yield
    finally:
        _SP_GROUP.reset(token)


def local_write(cache_all, layer_idx, rows, local_idx, in_range, new_row) -> None:
    """Write `new_row` [B, D'] at (layer_idx, rows, local_idx) in place, only
    where `in_range` [B] (this rank owns that cache position); other lanes
    keep their (clamped-position) row."""
    smax_local = cache_all.shape[2]
    safe = local_idx.clamp(0, smax_local - 1).long()
    old = cache_all[layer_idx, rows, safe]
    cache_all[layer_idx, rows, safe] = torch.where(in_range[:, None], new_row.to(old.dtype), old)


def local_write_scale(scale_all, layer_idx, rows, local_idx, in_range, new_scale) -> None:
    """int8-cache companion of `local_write` for the per-(token, kv-head)
    scale planes [L, B, Hkv, Smax]: `new_scale` [B, Hkv] at
    (layer_idx, rows, :, local_idx), only where `in_range`."""
    smax_local = scale_all.shape[3]
    safe = local_idx.clamp(0, smax_local - 1).long()
    old = scale_all[layer_idx, rows, :, safe]  # [B, Hkv]
    scale_all[layer_idx, rows, :, safe] = torch.where(in_range[:, None], new_scale, old)


def cached_attention_merge(
    q: torch.Tensor,  # [B, 1, H, hd] new-token queries (replicated)
    ck_i: torch.Tensor,  # [B, S_local, Hkv*hd] this rank's cache block, one layer
    cv_i: torch.Tensor,
    cache_seg_local: torch.Tensor,  # [B, S_local] segment ids of the local rows
    *,
    num_kv_heads: int,
    group,
) -> torch.Tensor:
    """Distributed flash-decoding: per-rank partial attention and lse, then
    the cross-rank merge. Returns [B, 1, H, hd], attention over the whole
    concatenated cache up to float association."""
    b, s_local = cache_seg_local.shape
    h, hd = q.shape[2], q.shape[3]
    hkv = num_kv_heads
    k = ck_i.reshape(b, s_local, hkv, hd).float()
    v = cv_i.reshape(b, s_local, hkv, hd).float()
    qh = q[:, 0].reshape(b, hkv, h // hkv, hd).float() * hd ** -0.5  # GQA grouping
    scores = torch.einsum("bkgd,bskd->bkgs", qh, k)  # [B, hkv, g, S_local]
    valid = (cache_seg_local != 0)[:, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m_local = scores.amax(dim=-1)  # [B, hkv, g]
    # An all-padding rank's sentinel sits BELOW any real score: with 0 it
    # would inflate the global max, and exp(m - m_global) of the ranks with
    # very negative valid scores would underflow to zero.
    neg_big = -torch.finfo(torch.float32).max
    finite = torch.isfinite(m_local)
    m_safe = torch.where(finite, m_local, torch.full_like(m_local, neg_big))
    p = torch.where(valid, torch.exp(scores - m_safe.clamp_min(neg_big / 2)[..., None]),
                    torch.zeros_like(scores))
    l_local = p.sum(dim=-1)
    o_local = torch.einsum("bkgs,bskd->bkgd", p, v)
    m_global = m_safe.clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=group)
    w = torch.where(finite, torch.exp(m_safe - m_global), torch.zeros_like(m_safe))
    num = o_local * w[..., None]
    den = l_local * w
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def block_attention(cfg, layer_idx: int, cache, q, k_flat, v_flat, cache_index,
                    cache_segment_ids, group) -> torch.Tensor:
    """`qwen2._block_cached`'s attention under the SP-decode context: write
    the new token's K/V (int8-quantized for the 4-tuple cache) on the owning
    rank, then `cached_attention_merge` over the local block (dequantized
    for the int8 cache). One token per row; `cache_index` the GLOBAL write
    index, scalar or [B]."""
    b, s = q.shape[:2]
    if s != 1:
        raise NotImplementedError(
            "multi-token cached decode (speculative verify) is not wired for "
            "sequence-parallel decode: the cache here is a LOCAL seq shard")
    if cfg.pos_embedding != "rope":
        raise NotImplementedError("sequence-parallel decode has no ALiBi bias support")
    hkv = cfg.num_kv_heads
    ck_all, cv_all = cache[0], cache[1]
    s_local = ck_all.shape[2]
    shard = dist.get_rank(group)
    global_idx = torch.as_tensor(cache_index, device=q.device)
    if global_idx.ndim == 0:
        global_idx = global_idx.expand(b)
    local_idx = global_idx.to(torch.int64) - shard * s_local
    in_range = (local_idx >= 0) & (local_idx < s_local)
    rows = torch.arange(b, device=q.device)
    if len(cache) == 4:
        (kq, ksc), (vq, vsc) = quantize_kv_row(k_flat[:, 0], hkv), quantize_kv_row(v_flat[:, 0], hkv)
        local_write(ck_all, layer_idx, rows, local_idx, in_range, kq)
        local_write(cv_all, layer_idx, rows, local_idx, in_range, vq)
        local_write_scale(cache[2], layer_idx, rows, local_idx, in_range, ksc)
        local_write_scale(cache[3], layer_idx, rows, local_idx, in_range, vsc)
        ck = dequantize_kv(ck_all[layer_idx], cache[2][layer_idx], hkv)
        cv = dequantize_kv(cv_all[layer_idx], cache[3][layer_idx], hkv)
    else:
        local_write(ck_all, layer_idx, rows, local_idx, in_range, k_flat[:, 0])
        local_write(cv_all, layer_idx, rows, local_idx, in_range, v_flat[:, 0])
        ck, cv = ck_all[layer_idx], cv_all[layer_idx]
    return cached_attention_merge(q, ck, cv, cache_segment_ids, num_kv_heads=hkv, group=group)


def make_sp_decode_step(cfg, mesh, *, axis_name: str = "seq", kv_quant: bool = False):
    """One sequence-parallel decode step on this rank:

    step(decoder, cache, cache_seg, tok, positions, cache_index)
        -> (cache, cache_seg, logits [B, V])

    cache (k, v) [L, B, Smax/n, Hkv*hd] is this rank's block of the
    sequence (with kv_quant the int8 4-tuple, scales [L, B, Hkv, Smax/n]),
    cache_seg [B, Smax/n] its segment ids; both are updated in place.
    Everything else is replicated; `cache_index` is the scalar GLOBAL write
    position (a lock-step batch)."""
    from radvlm_tpu_torch.models import qwen2
    from radvlm_tpu_torch.parallel.ring import group_of

    group = group_of(mesh, axis_name)
    n_cache = 4 if kv_quant else 2

    @torch.inference_mode()
    def step(decoder, cache, cache_seg, tok, positions, cache_index: int):
        if len(cache) != n_cache:
            raise ValueError(f"cache tuple has {len(cache)} tensors; this step was built with "
                             f"kv_quant={kv_quant} (expects {n_cache})")
        s_local = cache[0].shape[2]
        local = int(cache_index) - dist.get_rank(group) * s_local
        if 0 <= local < s_local:  # mark the new position's segment on the owning rank
            cache_seg[:, local] = 1
        b = tok.shape[0]
        with active(group):
            logits, cache = qwen2.forward(
                decoder, cfg,
                input_embeds=qwen2.embed_tokens(decoder, tok[:, None], cfg),
                positions=positions[:, None],
                segment_ids=torch.ones((b, 1), dtype=torch.int32, device=tok.device),
                kv_cache=cache, cache_index=int(cache_index), cache_segment_ids=cache_seg,
                attn_impl="xla",
            )
        return cache, cache_seg, logits[:, 0]

    return step
