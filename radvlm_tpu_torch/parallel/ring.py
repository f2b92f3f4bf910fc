"""Ring attention: sequence-parallel attention over the `seq` process group
(counterpart of `radvlm_tpu/parallel/ring.py`, its contiguous forward).

Rank i of the group holds positions [i*S, (i+1)*S) of q, k and v. K/V and
their segment ids rotate around the ring (`dist.batch_isend_irecv`: send to
rank i + 1, receive from rank i - 1); each step attends the local queries to
the chunk in hand with K2 writing its lse (`flash_attention.
prefill_attention_lse`, its plain version on the CPU and where
`flash_eligible` does not hold), and the partial results merge by the
online-softmax rule. Under the causal mask a chunk from an earlier rank
attends fully, the rank's own chunk causally, and a later rank's chunk is
skipped: which pair is which is known on the host, so a skipped pair costs
nothing.

Only the forward is ported: the serving path's prefill. The ring's backward
and the load-balanced zigzag schedule (`zigzag_indices`,
`zigzag_shift_batch`) are training work (ROADMAP M12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from radvlm_tpu_torch.ops.attention import flash_eligible
from radvlm_tpu_torch.ops.flash_attention import attention_plain, prefill_attention_lse


def group_of(mesh_or_group, axis_name: str = "seq"):
    """A DeviceMesh's group along `axis_name`, or a process group as given."""
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group(axis_name)
    return mesh_or_group


def _local_attn_with_lse(q, k, v, q_seg, kv_seg, *, causal: bool, scale: float, impl: str):
    """(out, lse [B, H, Sq] f32) for one chunk pair: K2 with its lse where
    the kernels serve the call, else its plain version."""
    if impl != "xla" and flash_eligible(q, k, impl=impl):
        return prefill_attention_lse(q, k, v, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                     causal=causal, scale=scale)
    return attention_plain(q, k, v, q_seg, kv_seg, causal, scale, with_lse=True)


def _merge(o_acc, m_acc, l_acc, o_t, lse_t):
    """Online-softmax merge of a new partial attention into the running
    state. o_acc is the UNNORMALISED numerator relative to m_acc (the true
    output is o_acc / l_acc); a chunk's normalised o_t enters with weight
    exp(lse_t - m_new)."""
    m_new = torch.maximum(m_acc, lse_t)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_safe), torch.zeros_like(m_acc))
    beta = torch.where(torch.isfinite(lse_t), torch.exp(lse_t - m_safe), torch.zeros_like(lse_t))
    l_new = l_acc * alpha + beta
    a = alpha.transpose(1, 2)[..., None]
    b = beta.transpose(1, 2)[..., None]
    o_new = o_acc * a + o_t.float() * b
    return o_new, m_new, l_new


def _pair_attn(q, k_t, v_t, q_seg, kv_seg_t, rel: int, *, scale: float, impl: str):
    """One chunk pair: rel < 0 full, rel == 0 diagonal (causal), rel > 0
    skip (None: nothing to merge)."""
    if rel > 0:
        return None
    return _local_attn_with_lse(q, k_t, v_t, q_seg, kv_seg_t, causal=rel == 0, scale=scale,
                                impl=impl)


def _rotate(group, tensors):
    """Send each tensor to the next rank of the ring and receive the previous
    rank's (one batch of point-to-point operations)."""
    if tensors[0].is_cuda and dist.get_backend(group) == "gloo":
        # gloo sends a device pointer as if it were host memory and aborts
        # the process; NCCL carries CUDA tensors point to point.
        raise RuntimeError("ring attention over CUDA tensors needs an NCCL group: gloo sends "
                           "no CUDA tensor point to point")
    n, my = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (my + 1) % n)
    prv = dist.get_global_rank(group, (my - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(
    q: torch.Tensor,  # [B, S_local, H, D] (this rank's sequence shard)
    k: torch.Tensor,  # [B, S_local, Hkv, D]
    v: torch.Tensor,
    *,
    group,
    q_segment_ids: Optional[torch.Tensor] = None,  # [B, S_local]
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    impl: str = "flash",
    schedule: str = "contiguous",
) -> torch.Tensor:
    """Sequence-parallel attention over `group`: equal to attention over the
    concatenated sequence, rank i holding positions [i*S_local, (i+1)*S_local)."""
    if schedule != "contiguous":
        raise NotImplementedError(
            f"ring schedule {schedule!r}: only the contiguous one is ported; the zigzag "
            "schedule is training work (ROADMAP M12)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the ring attention backward is not ported (ROADMAP M12)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, s_local, h, d = q.shape
    ones = torch.ones((b, s_local), dtype=torch.int32, device=q.device)
    q_seg = ones if q_segment_ids is None else q_segment_ids.to(torch.int32)
    kv_seg = ones if kv_segment_ids is None else kv_segment_ids.to(torch.int32)
    o_acc = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    m_acc = torch.full((b, h, s_local), float("-inf"), device=q.device)
    l_acc = torch.zeros((b, h, s_local), device=q.device)
    k_t, v_t, seg_t = k.contiguous(), v.contiguous(), kv_seg.contiguous()
    for t in range(n):
        src = (my - t) % n  # whose kv chunk this rank holds now
        rel = (src - my) if causal else -1
        pair = _pair_attn(q, k_t, v_t, q_seg, seg_t, rel, scale=scale, impl=impl)
        if pair is not None:
            o_acc, m_acc, l_acc = _merge(o_acc, m_acc, l_acc, *pair)
        if t + 1 < n:
            k_t, v_t, seg_t = _rotate(group, (k_t, v_t, seg_t))
    safe_l = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return (o_acc / safe_l.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# The ring context that ops.attention consults for attn_impl="ring".
# ---------------------------------------------------------------------------

_RING_CONTEXT: Optional[Tuple] = None  # (group, local impl, schedule)


def enable_ring_attention(mesh, *, axis_name: str = "seq", impl: str = "flash",
                          schedule: str = "contiguous") -> None:
    """Register the group (a DeviceMesh's `axis_name`, or a process group)
    that attn_impl="ring" runs over; mesh=None clears it."""
    global _RING_CONTEXT
    if mesh is not None and schedule != "contiguous":
        raise NotImplementedError(
            f"ring schedule {schedule!r}: only the contiguous one is ported (ROADMAP M12)")
    _RING_CONTEXT = None if mesh is None else (group_of(mesh, axis_name), impl, schedule)


def get_ring_context():
    if _RING_CONTEXT is None:
        raise RuntimeError("attn_impl='ring' requires parallel.ring.enable_ring_attention(mesh)")
    return _RING_CONTEXT


def ring_attention_sharded(q, k, v, q_segment_ids, kv_segment_ids, *, causal: bool, scale):
    """Ring attention over the registered context, on this rank's shards
    (the JAX package's shard_map over the global arrays: in SPMD the
    activations are already local)."""
    group, impl, schedule = get_ring_context()
    return ring_attention(q, k, v, group=group, q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, causal=causal, scale=scale,
                          impl=impl, schedule=schedule)


def make_ring_attention(mesh, *, axis_name: str = "seq", impl: str = "flash",
                        schedule: str = "contiguous"):
    """fn(q, k, v, q_seg, kv_seg) -> out, ring attention over `mesh[axis_name]`
    on this rank's sequence shards [B, S_local, H, D] (the JAX package's
    version takes the global arrays and shard_maps them)."""
    group = group_of(mesh, axis_name)

    def fn(q, k, v, q_seg=None, kv_seg=None):
        return ring_attention(q, k, v, group=group, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                              impl=impl, schedule=schedule)

    return fn
