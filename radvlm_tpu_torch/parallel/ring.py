"""Ring attention: sequence-parallel attention over the `seq` process group
(counterpart of `radvlm_tpu/parallel/ring.py`).

Each rank holds one shard of q, k and v. K/V and their segment ids rotate
around the ring (`dist.batch_isend_irecv`: send to rank i + 1, receive from
rank i - 1); each step attends the local queries to the chunk in hand with
K2 writing its lse (`flash_attention.flash_attention_with_lse`, its plain
version on the CPU and where `flash_eligible` does not hold), and the
partial results merge by the online-softmax rule. Which chunk pairs attend
fully, causally or not at all is known on the host, so a skipped pair costs
nothing. Two schedules:

- "contiguous": rank i holds positions [i*S, (i+1)*S). A chunk from an
  earlier rank attends fully, the rank's own causally, a later one is
  skipped: the last rank computes N pairs, the first one.
- "zigzag" (the default, as in the JAX package): the sequence is permuted
  into 2N chunks and rank i holds chunks (i, 2N-1-i) as two halves. Every
  step runs two half-chunk pairs on every rank (three on the first): load
  balanced. Data enters permuted (`zigzag_indices`, `zigzag_shift_batch`):
  positions and segment ids travel with the permutation, so rope and masks
  stay right, and the labels are shifted before it, so the loss is a
  positionwise sum that the permutation does not change.

Backward: autograd through the pieces, as the JAX package differentiates
its ring (and the train step recomputes it under remat): each pair's
`flash_attention_with_lse` has its backward (K7 and K8 on the card, the lse
cotangent folded into delta), `_merge` is plain tensor ops, and `_Rotate`'s
backward sends the K/V cotangents the other way round the ring (the
transpose of a ppermute).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radvlm_tpu_torch.config import IGNORE_INDEX
from radvlm_tpu_torch.ops.attention import flash_eligible
from radvlm_tpu_torch.ops.flash_attention import attention_plain, flash_attention_with_lse

SCHEDULES = ("contiguous", "zigzag")


def group_of(mesh_or_group, axis_name: str = "seq"):
    """A DeviceMesh's group along `axis_name`, or a process group as given."""
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group(axis_name)
    return mesh_or_group


def _local_attn_with_lse(q, k, v, q_seg, kv_seg, *, causal: bool, scale: float, impl: str):
    """(out, lse [B, H, Sq] f32) for one chunk pair: K2 with its lse (K7 and
    K8 backward) where the kernels serve the call, else its plain version
    (differentiated by autograd)."""
    if impl != "xla" and flash_eligible(q, k, impl=impl):
        return flash_attention_with_lse(q, k, v, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                        causal=causal, scale=scale)
    return attention_plain(q, k, v, q_seg, kv_seg, causal, scale, with_lse=True)


def _merge(o_acc, m_acc, l_acc, o_t, lse_t):
    """Online-softmax merge of a new partial attention into the running
    state. o_acc is the UNNORMALISED numerator relative to m_acc (the true
    output is o_acc / l_acc); a chunk's normalised o_t enters with weight
    exp(lse_t - m_new). A row with lse = -inf (nothing to attend) enters
    with weight 0 through `torch.where`, whose other branch is finite, so
    its gradient is 0, never NaN."""
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


def _send_recv(group, tensors, step: int):
    """Send each tensor `step` ranks on round the ring and receive the
    tensors of the rank `step` back (one batch of point-to-point ops)."""
    if tensors[0].is_cuda and dist.get_backend(group) == "gloo":
        # gloo sends a device pointer as if it were host memory and aborts
        # the process; NCCL carries CUDA tensors point to point.
        raise RuntimeError("ring attention over CUDA tensors needs an NCCL group: gloo sends "
                           "no CUDA tensor point to point")
    n, my = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (my + step) % n)
    src = dist.get_global_rank(group, (my - step) % n)
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """K, V and segment ids to the next rank, the previous rank's in; the
    backward sends the K / V cotangents to the previous rank and takes the
    next rank's (zeros where a rank's chunk reached no output)."""

    @staticmethod
    def forward(ctx, group, k, v, seg):
        ctx.group = group
        k2, v2, seg2 = _send_recv(group, (k, v, seg), 1)
        ctx.mark_non_differentiable(seg2)
        return k2, v2, seg2

    @staticmethod
    def backward(ctx, dk, dv, _):
        dk2, dv2 = _send_recv(ctx.group, (dk, dv), -1)
        return None, dk2, dv2, None


def _rotate(group, k, v, seg):
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        return _Rotate.apply(group, k, v, seg)
    return tuple(_send_recv(group, (k, v, seg), 1))


def _finish(o_acc, l_acc):
    safe_l = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return o_acc / safe_l.transpose(1, 2)[..., None]


def _zero_acc(b, s, h, d, device):
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=device),
            torch.full((b, h, s), float("-inf"), device=device),
            torch.zeros((b, h, s), device=device))


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
    schedule: str = "zigzag",
) -> torch.Tensor:
    """Sequence-parallel attention over `group`, differentiable: equal to
    attention over the whole sequence. "contiguous": rank i holds positions
    [i*S_local, (i+1)*S_local); "zigzag": rank i holds zigzag chunks
    (i, 2N-1-i) of the permuted sequence (see the module docstring)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"ring schedule {schedule!r}: one of {SCHEDULES}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, s_local, h, d = q.shape
    ones = torch.ones((b, s_local), dtype=torch.int32, device=q.device)
    q_seg = ones if q_segment_ids is None else q_segment_ids.to(torch.int32)
    kv_seg = ones if kv_segment_ids is None else kv_segment_ids.to(torch.int32)
    if schedule == "zigzag" and causal:
        return _ring_attention_zigzag(q, k, v, group, q_seg, kv_seg, scale, impl)
    n, my = dist.get_world_size(group), dist.get_rank(group)
    acc = _zero_acc(b, s_local, h, d, q.device)
    k_t, v_t, seg_t = k.contiguous(), v.contiguous(), kv_seg.contiguous()
    for t in range(n):
        src = (my - t) % n  # whose kv chunk this rank holds now
        rel = (src - my) if causal else -1
        pair = _pair_attn(q, k_t, v_t, q_seg, seg_t, rel, scale=scale, impl=impl)
        if pair is not None:
            acc = _merge(*acc, *pair)
        if t + 1 < n:
            k_t, v_t, seg_t = _rotate(group, k_t, v_t, seg_t)
    out = _finish(acc[0], acc[2])
    if n > 1 and torch.is_grad_enabled() and (k_t.requires_grad or v_t.requires_grad):
        # A later rank's chunks reach no output of this rank, so without
        # this zero term the rotations' backward would run on some ranks
        # and not on others, and their point-to-point sends would not pair.
        out = out + 0.0 * (k_t.float().sum() + v_t.float().sum())
    return out.to(q.dtype)


def _ring_attention_zigzag(q, k, v, group, q_seg, kv_seg, scale: float, impl: str):
    """Zigzag schedule: the local shard is the halves [chunk my, chunk
    2N-1-my]. With kv from source rank j (q rank i):
      lo x lo: full if j < i, diagonal if j == i, skip if j > i
      hi x lo: always full (every low chunk precedes every high chunk)
      hi x hi: full if j > i, diagonal if j == i, skip if j < i
      lo x hi: always skip
    Step 0 runs two diagonals and one full pair; a later step exactly one of
    lo x lo / hi x hi beside hi x lo."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, s_local, h, d = q.shape
    sh = s_local // 2
    if sh * 2 != s_local:
        raise ValueError(f"the zigzag schedule needs an even local shard, got {s_local}")
    q_lo, q_hi = q[:, :sh], q[:, sh:]
    qs_lo, qs_hi = q_seg[:, :sh], q_seg[:, sh:]
    acc_lo, acc_hi = _zero_acc(b, sh, h, d, q.device), _zero_acc(b, sh, h, d, q.device)
    k_t, v_t, seg_t = k.contiguous(), v.contiguous(), kv_seg.contiguous()
    for t in range(n):
        src = (my - t) % n
        k_lo, k_hi = k_t[:, :sh], k_t[:, sh:]
        v_lo, v_hi = v_t[:, :sh], v_t[:, sh:]
        ks_lo, ks_hi = seg_t[:, :sh], seg_t[:, sh:]
        kw = dict(scale=scale, impl=impl)
        pair = _pair_attn(q_lo, k_lo, v_lo, qs_lo, ks_lo, src - my, **kw)
        if pair is not None:
            acc_lo = _merge(*acc_lo, *pair)
        acc_hi = _merge(*acc_hi, *_pair_attn(q_hi, k_lo, v_lo, qs_hi, ks_lo, -1, **kw))
        pair = _pair_attn(q_hi, k_hi, v_hi, qs_hi, ks_hi, my - src, **kw)
        if pair is not None:
            acc_hi = _merge(*acc_hi, *pair)
        if t + 1 < n:
            k_t, v_t, seg_t = _rotate(group, k_t, v_t, seg_t)
    out = torch.cat([_finish(acc_lo[0], acc_lo[2]), _finish(acc_hi[0], acc_hi[2])], dim=1)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Zigzag data layout helpers (host-side, numpy)
# ---------------------------------------------------------------------------


def zigzag_indices(seq_len: int, n_ranks: int) -> np.ndarray:
    """Permutation p with x[..., p] in zigzag layout: rank i's contiguous
    shard holds chunks (i, 2N-1-i) of the original sequence."""
    c = 2 * n_ranks
    if seq_len % c:
        raise ValueError(f"seq_len {seq_len} not divisible by 2*n_ranks={c}")
    cs = seq_len // c
    order = []
    for i in range(n_ranks):
        order.extend(range(i * cs, (i + 1) * cs))
        order.extend(range((c - 1 - i) * cs, (c - i) * cs))
    return np.asarray(order, np.int64)


def inverse_zigzag_indices(seq_len: int, n_ranks: int) -> np.ndarray:
    p = zigzag_indices(seq_len, n_ranks)
    inv = np.empty_like(p)
    inv[p] = np.arange(seq_len)
    return inv


def shift_labels(batch):
    """The batch with `labels_next` in place of `labels`: labels_next[t]
    supervises position t (loss_fn's shift, padding gated), so a batch cut
    along the sequence keeps each position's target."""
    labels, seg = batch["labels"], batch["segment_ids"]
    b = labels.shape[0]
    nxt = np.concatenate([labels[:, 1:], np.full((b, 1), IGNORE_INDEX, labels.dtype)], axis=1)
    seg_next = np.concatenate([seg[:, 1:], np.zeros((b, 1), seg.dtype)], axis=1)
    out = {k: v for k, v in batch.items() if k != "labels"}
    out["labels_next"] = np.where(seg_next != 0, nxt, IGNORE_INDEX)
    return out


def zigzag_shift_batch(batch, n_ranks: int):
    """Host transform for zigzag SP training: pre-shift labels
    (`shift_labels`), then permute every per-position array into the zigzag
    layout. The loss becomes a positionwise CE, which the permutation does
    not change."""
    out = shift_labels(batch)
    perm = zigzag_indices(out["labels_next"].shape[1], n_ranks)
    for key in ("tokens", "img_src", "positions", "segment_ids", "labels_next"):
        out[key] = np.ascontiguousarray(out[key][:, perm])
    return out


# ---------------------------------------------------------------------------
# The ring context that ops.attention consults for attn_impl="ring".
# ---------------------------------------------------------------------------

_RING_CONTEXT: Optional[Tuple] = None  # (group, local impl, schedule)


def enable_ring_attention(mesh, *, axis_name: str = "seq", impl: str = "flash",
                          schedule: str = "zigzag") -> None:
    """Register the group (a DeviceMesh's `axis_name`, or a process group)
    that attn_impl="ring" runs over; mesh=None clears it."""
    global _RING_CONTEXT
    if schedule not in SCHEDULES:
        raise ValueError(f"ring schedule {schedule!r}: one of {SCHEDULES}")
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
    version takes the global arrays and shard_maps them). With "zigzag" the
    inputs are in the zigzag layout already (`zigzag_indices`)."""
    group = group_of(mesh, axis_name)

    def fn(q, k, v, q_seg=None, kv_seg=None):
        return ring_attention(q, k, v, group=group, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                              impl=impl, schedule=schedule)

    return fn
