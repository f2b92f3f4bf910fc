"""Single-token GQA decode attention over the bf16 KV cache (K9) and over the
int8 KV cache (K4), PyTorch side.

Counterpart of `radvlm_tpu/ops/decode_attention.py::decode_attention_stacked`
and `decode_attention_stacked_q8`.
The cache keeps the JAX package's stacked layout [L, B, Smax, Hkv*D]; the
kernel (`csrc/decode_attention.cu`) reads layer `l` through the view
`ck[l]`, which is free in PyTorch - the TPU's scalar-prefetched layer index
has nothing left to do. A query attends every slot whose segment id is not 0.

`decode_attention_plain` / `decode_attention_q8_plain` are the plain
PyTorch versions. A wrapper runs its plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from radvlm_tpu_torch import kernels

_SPLIT_GRAIN = 64  # the kernel's key tile


def decode_attention_plain(
    q: torch.Tensor,  # [B, H, D]
    ck: torch.Tensor,  # [B, S, Hkv*D], one layer
    cv: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    *,
    num_kv_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of K9: f32 scores scaled after the dot, p = 0 where the
    slot's segment is 0, f32 p in the PV sum, 0 for a row with no slot."""
    b, h, d = q.shape
    s = ck.shape[1]
    g = h // num_kv_heads
    kf = ck.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    vf = cv.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) * scale
    valid = (kv_segment_ids != 0)[:, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhs,bshd->bhd", p, vf) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def _num_splits(batch: int, hkv: int, s: int, device: torch.device) -> int:
    """Enough CTAs for about two per SM, with chunks of whole key tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-2 * sms // (batch * hkv)))
    return max(1, min(want, -(-s // _SPLIT_GRAIN)))


def _split_plan(b: int, hkv: int, s: int, device: torch.device):
    """(nsplit, chunk): whole key tiles per CTA, about two CTAs per SM."""
    nsplit = _num_splits(b, hkv, s, device)
    chunk = -(-s // nsplit)
    chunk = -(-chunk // _SPLIT_GRAIN) * _SPLIT_GRAIN
    return -(-s // chunk), chunk


def _check_decode_shapes(name, q, ck, cv, kv_segment_ids, num_kv_heads):
    b, h, d = q.shape
    s = ck.shape[1]
    if ck.shape != cv.shape or ck.shape != (b, s, num_kv_heads * d) or kv_segment_ids.shape != (b, s):
        raise ValueError(
            f"{name}: cache {ck.shape} / segment ids {kv_segment_ids.shape} "
            f"do not match q {q.shape} with {num_kv_heads} kv heads"
        )


def decode_attention_stacked(
    q: torch.Tensor,  # [B, H, D]
    ck_all: torch.Tensor,  # [L, B, S, Hkv*D], the whole stacked cache
    cv_all: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    layer_idx: int,
    *,
    num_kv_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K9 wrapper: single-token GQA attention over layer `layer_idx` of the
    stacked cache. Returns [B, H, D]."""
    b, h, d = q.shape
    scale = float(d ** -0.5 if scale is None else scale)
    ck, cv = ck_all[layer_idx], cv_all[layer_idx]  # views, no copy
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, ck, cv, kv_segment_ids, num_kv_heads=num_kv_heads, scale=scale
        )
    _check_decode_shapes("decode_attention", q, ck, cv, kv_segment_ids, num_kv_heads)
    s = ck.shape[1]
    q = q.contiguous()
    seg = kv_segment_ids.to(torch.int32).contiguous()
    kernels.require_cuda_tensors("decode_attention", q, ck, cv, seg)
    for t in (q, ck, cv):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"decode_attention: the kernel takes bf16, got {t.dtype}")
    if d > 128 or d % 2 or h % num_kv_heads or h // num_kv_heads > 8:
        raise ValueError(
            "decode_attention: the kernel takes an even head_dim <= 128 and up to "
            f"8 query heads per kv head, got D={d}, H={h}, Hkv={num_kv_heads}"
        )
    nsplit, chunk = _split_plan(b, num_kv_heads, s, q.device)
    part_o = torch.empty((b, h, nsplit, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = kernels.lib().radvlm_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), seg.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, s, h, num_kv_heads, d, nsplit, chunk, scale,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, "decode_attention")
    kernels.count_launch("decode_attention")
    return out


def decode_attention_q8_plain(
    q: torch.Tensor,  # [B, H, D]
    ck: torch.Tensor,  # [B, S, Hkv*D] int8, one layer
    cv: torch.Tensor,
    k_scale: torch.Tensor,  # [B, Hkv, S] f32
    v_scale: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    *,
    num_kv_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of K4: f32 scores (q . k_int8) * ks[t] * scale, p = 0
    where the slot's segment is 0, p * vs[t] in f32 against the int8 V rows,
    0 for a row with no slot."""
    b, h, d = q.shape
    s = ck.shape[1]
    g = h // num_kv_heads
    kf = ck.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    vf = cv.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    ks = k_scale.float().repeat_interleave(g, dim=1)  # [B, H, S]
    vs = v_scale.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kf) * ks * scale
    valid = (kv_segment_ids != 0)[:, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhs,bshd->bhd", p * vs, vf) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def decode_attention_stacked_q8(
    q: torch.Tensor,  # [B, H, D]
    ck_all: torch.Tensor,  # [L, B, S, Hkv*D] int8, the whole stacked cache
    cv_all: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    layer_idx: int,
    *,
    num_kv_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K4 wrapper: single-token GQA attention over layer `layer_idx` of the
    stacked int8 cache. Returns [B, H, D] in q's dtype."""
    b, h, d = q.shape
    scale = float(d ** -0.5 if scale is None else scale)
    ck, cv = ck_all[layer_idx], cv_all[layer_idx]  # views, no copy
    ks, vs = k_scale[layer_idx], v_scale[layer_idx]
    if q.device.type == "cpu":
        return decode_attention_q8_plain(
            q, ck, cv, ks, vs, kv_segment_ids, num_kv_heads=num_kv_heads, scale=scale
        )
    _check_decode_shapes("decode_attention_q8", q, ck, cv, kv_segment_ids, num_kv_heads)
    s = ck.shape[1]
    if ks.shape != (b, num_kv_heads, s) or vs.shape != ks.shape:
        raise ValueError(
            f"decode_attention_q8: scales {tuple(ks.shape)} / {tuple(vs.shape)}, "
            f"expected {(b, num_kv_heads, s)}"
        )
    q = q.contiguous()
    seg = kv_segment_ids.to(torch.int32).contiguous()
    kernels.require_dtype("decode_attention_q8", torch.bfloat16, q=q)
    kernels.require_dtype("decode_attention_q8", torch.int8, ck=ck, cv=cv)
    kernels.require_dtype("decode_attention_q8", torch.float32, k_scale=ks, v_scale=vs)
    kernels.require_cuda_tensors("decode_attention_q8", ck, cv, align=16)
    kernels.require_cuda_tensors("decode_attention_q8", q, ks, vs, seg)
    if d > 128 or d % 16 or h % num_kv_heads or h // num_kv_heads > 8:
        raise ValueError(
            "decode_attention_q8: the kernel takes a head_dim <= 128 that is a multiple "
            f"of 16 and up to 8 query heads per kv head, got D={d}, H={h}, "
            f"Hkv={num_kv_heads}"
        )
    nsplit, chunk = _split_plan(b, num_kv_heads, s, q.device)
    part_o = torch.empty((b, h, nsplit, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = kernels.lib().radvlm_decode_attention_q8(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        seg.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, s, h, num_kv_heads, d, nsplit, chunk, scale,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, "decode_attention_q8")
    kernels.count_launch("decode_attention_q8")
    return out
