"""Single-token GQA decode attention over the bf16 KV cache (K9), PyTorch side.

Counterpart of `radvlm_tpu/ops/decode_attention.py::decode_attention_stacked`.
The cache keeps the JAX package's stacked layout [L, B, Smax, Hkv*D]; the
kernel (`csrc/decode_attention.cu`) reads layer `l` through the view
`ck[l]`, which is free in PyTorch - the TPU's scalar-prefetched layer index
has nothing left to do. A query attends every slot whose segment id is not 0.

`decode_attention_plain` is the plain PyTorch version. The wrapper runs it
only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises.
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
    s = ck.shape[1]
    if ck.shape != cv.shape or ck.shape != (b, s, num_kv_heads * d) or kv_segment_ids.shape != (b, s):
        raise ValueError(
            f"decode_attention: cache {ck.shape} / segment ids {kv_segment_ids.shape} "
            f"do not match q {q.shape} with {num_kv_heads} kv heads"
        )
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
    nsplit = _num_splits(b, num_kv_heads, s, q.device)
    chunk = -(-s // nsplit)
    chunk = -(-chunk // _SPLIT_GRAIN) * _SPLIT_GRAIN
    nsplit = -(-s // chunk)
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
