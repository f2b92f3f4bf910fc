"""GQA decode attention over the bf16 KV cache (K9) and over the int8 KV
cache (K4), one query per slot, and their windowed variants K10 and K11:
the W = spec_k + 1 queries of a speculative verify step, where query j of
slot b sits at cache index `window_idx[b] + j` and sees the keys at indices
<= it. PyTorch side.

Counterpart of `radvlm_tpu/ops/decode_attention.py::decode_attention_stacked`,
`decode_attention_stacked_q8`, `decode_attention_stacked_window` and
`decode_attention_stacked_window_q8`.
The cache keeps the JAX package's stacked layout [L, B, Smax, Hkv*D]; the
kernel (`csrc/decode_attention.cu`) reads layer `l` through the view
`ck[l]`, which is free in PyTorch - the TPU's scalar-prefetched layer index
has nothing left to do. A query attends every slot whose segment id is not 0.

`decode_attention_plain`, `decode_attention_q8_plain`,
`decode_attention_window_plain` and `decode_attention_window_q8_plain` are
the plain PyTorch versions. A wrapper runs its plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from radvlm_tpu_torch import kernels

_SPLIT_GRAIN = 64  # the kernel's key tile
MAX_HEAD_DIM = 128  # the widest head the kernels take
MAX_GROUP = 8  # the most query heads a kv head the kernels take


def kernel_takes(head_dim: int, num_heads: int, num_kv_heads: int, quantized: bool) -> bool:
    """The head shapes the decode kernels take: K9 / K10 (bf16 cache) an even
    head_dim <= 128, K4 / K11 (int8 cache, 16-byte copies of a key row) a
    head_dim <= 128 that is a multiple of 16; both a GQA group of at most 8.
    The wrappers raise on a CUDA tensor outside it, and
    `models.qwen2.decode_kernel_eligible` routes such a config to the plain
    path."""
    grain = 16 if quantized else 2
    return (head_dim <= MAX_HEAD_DIM and head_dim % grain == 0
            and num_heads % num_kv_heads == 0 and num_heads // num_kv_heads <= MAX_GROUP)


def _require_heads(name: str, d: int, h: int, num_kv_heads: int, quantized: bool) -> None:
    if not kernel_takes(d, h, num_kv_heads, quantized):
        what = "a multiple of 16" if quantized else "even"
        raise ValueError(
            f"{name}: the kernel takes a head_dim <= {MAX_HEAD_DIM} that is {what} and up to "
            f"{MAX_GROUP} query heads per kv head, got D={d}, H={h}, Hkv={num_kv_heads}"
        )


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


def _split_plan(b: int, hkv: int, s: int, sms: int):
    """(nsplit, chunk): the key chunks of K9 / K4 and their windows on a card
    of `sms` SMs. Enough CTAs (nsplit x B x Hkv) for about two per SM, each
    chunk whole 64-key tiles. Depends on the cache's shape and the SM count,
    never on the window's width, so a window row is summed over the same
    chunks as the one-query kernel's row."""
    want = max(1, -(-2 * sms // (b * hkv)))
    nsplit = max(1, min(want, -(-s // _SPLIT_GRAIN)))
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
    _require_heads("decode_attention", d, h, num_kv_heads, False)
    nsplit, chunk = _split_plan(b, num_kv_heads, s, kernels.sm_count(q.device))
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
    _require_heads("decode_attention_q8", d, h, num_kv_heads, True)
    nsplit, chunk = _split_plan(b, num_kv_heads, s, kernels.sm_count(q.device))
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


MAX_WINDOW = 16  # the widest verify window K10 / K11 take


def _window_visible(kv_segment_ids: torch.Tensor, window_idx: torch.Tensor, w: int) -> torch.Tensor:
    """[B, W, 1, S] bool: key t is visible to window row j of slot b when its
    segment id is not 0 and t <= window_idx[b] + j (a cache index, not a
    position)."""
    s = kv_segment_ids.shape[1]
    dev = kv_segment_ids.device
    last = window_idx.long()[:, None] + torch.arange(w, device=dev)[None]  # [B, W]
    causal = torch.arange(s, device=dev)[None, None, :] <= last[:, :, None]
    return ((kv_segment_ids != 0)[:, None, :] & causal)[:, :, None, :]


def _window_softmax(scores: torch.Tensor, visible: torch.Tensor):
    """(p, l) of masked f32 scores [B, W, H, S]: p = 0 where not visible, and
    a row with no visible key has l = 0."""
    scores = scores.masked_fill(~visible, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m)
    return p, p.sum(dim=-1, keepdim=True)


def decode_attention_window_plain(
    q: torch.Tensor,  # [B, W, H, D]
    ck: torch.Tensor,  # [B, S, Hkv*D], one layer
    cv: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    window_idx: torch.Tensor,  # [B]
    *,
    num_kv_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of K10: K9's arithmetic for each of the W query rows,
    row j masked to the keys at cache indices <= window_idx + j."""
    b, w, h, d = q.shape
    s = ck.shape[1]
    g = h // num_kv_heads
    kf = ck.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    vf = cv.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bwhd,bshd->bwhs", q.float(), kf) * scale
    p, l = _window_softmax(scores, _window_visible(kv_segment_ids, window_idx, w))
    o = torch.einsum("bwhs,bshd->bwhd", p, vf) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def decode_attention_window_q8_plain(
    q: torch.Tensor,  # [B, W, H, D]
    ck: torch.Tensor,  # [B, S, Hkv*D] int8, one layer
    cv: torch.Tensor,
    k_scale: torch.Tensor,  # [B, Hkv, S] f32
    v_scale: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    window_idx: torch.Tensor,  # [B]
    *,
    num_kv_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain version of K11: K4's arithmetic for each of the W query rows.
    The scales above a window hold stale values: a masked key's p * vs is 0
    by selection, not by multiplying with 0."""
    b, w, h, d = q.shape
    s = ck.shape[1]
    g = h // num_kv_heads
    kf = ck.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    vf = cv.reshape(b, s, num_kv_heads, d).float().repeat_interleave(g, dim=2)
    ks = k_scale.float().repeat_interleave(g, dim=1)[:, None]  # [B, 1, H, S]
    vs = v_scale.float().repeat_interleave(g, dim=1)[:, None]
    visible = _window_visible(kv_segment_ids, window_idx, w)
    scores = torch.einsum("bwhd,bshd->bwhs", q.float(), kf) * ks * scale
    p, l = _window_softmax(scores, visible)
    pv = torch.where(visible, p * vs, torch.zeros_like(p))
    o = torch.einsum("bwhs,bshd->bwhd", pv, vf) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def _check_window(name, q, ck, cv, kv_segment_ids, window_idx, num_kv_heads):
    b, w, h, d = q.shape
    if not 1 < w <= MAX_WINDOW:
        raise ValueError(f"{name}: the kernel takes a window of 2..{MAX_WINDOW} queries, got {w}")
    _check_decode_shapes(name, q[:, 0], ck, cv, kv_segment_ids, num_kv_heads)
    if window_idx.shape != (b,) or window_idx.dtype != torch.int32:
        raise ValueError(
            f"{name}: window_idx must be int32 [{b}], got {window_idx.dtype} "
            f"{tuple(window_idx.shape)}"
        )


def _window_scratch(q, nsplit):
    b, w, h, d = q.shape
    part_o = torch.empty((b, w, h, nsplit, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, w, h, nsplit, 2), dtype=torch.float32, device=q.device)
    return part_o, part_ml, torch.empty_like(q)


def decode_attention_stacked_window(
    q: torch.Tensor,  # [B, W, H, D] verify-window queries
    ck_all: torch.Tensor,  # [L, B, S, Hkv*D], the whole stacked cache
    cv_all: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    layer_idx: int,
    window_idx: torch.Tensor,  # [B] int32 cache index of window row 0
    *,
    num_kv_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K10 wrapper: W-query GQA attention over layer `layer_idx` of the
    stacked bf16 cache. Returns [B, W, H, D]."""
    b, w, h, d = q.shape
    scale = float(d ** -0.5 if scale is None else scale)
    ck, cv = ck_all[layer_idx], cv_all[layer_idx]  # views, no copy
    if q.device.type == "cpu":
        return decode_attention_window_plain(
            q, ck, cv, kv_segment_ids, window_idx, num_kv_heads=num_kv_heads, scale=scale
        )
    name = "decode_attention_window"
    _check_window(name, q, ck, cv, kv_segment_ids, window_idx, num_kv_heads)
    s = ck.shape[1]
    q = q.contiguous()
    seg = kv_segment_ids.to(torch.int32).contiguous()
    kernels.require_dtype(name, torch.bfloat16, q=q, ck=ck, cv=cv)
    kernels.require_cuda_tensors(name, q, ck, cv, seg, window_idx)
    _require_heads(name, d, h, num_kv_heads, False)
    nsplit, chunk = _split_plan(b, num_kv_heads, s, kernels.sm_count(q.device))  # K9's plan
    part_o, part_ml, out = _window_scratch(q, nsplit)
    err = kernels.lib().radvlm_decode_attention_window(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), seg.data_ptr(), window_idx.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, s, h, num_kv_heads, d, w, nsplit, chunk, scale,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, name)
    kernels.count_launch(name)
    return out


def decode_attention_stacked_window_q8(
    q: torch.Tensor,  # [B, W, H, D]
    ck_all: torch.Tensor,  # [L, B, S, Hkv*D] int8
    cv_all: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    kv_segment_ids: torch.Tensor,  # [B, S]
    layer_idx: int,
    window_idx: torch.Tensor,  # [B] int32
    *,
    num_kv_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K11 wrapper: W-query GQA attention over layer `layer_idx` of the
    stacked int8 cache. Returns [B, W, H, D] in q's dtype."""
    b, w, h, d = q.shape
    scale = float(d ** -0.5 if scale is None else scale)
    ck, cv = ck_all[layer_idx], cv_all[layer_idx]  # views, no copy
    ks, vs = k_scale[layer_idx], v_scale[layer_idx]
    if q.device.type == "cpu":
        return decode_attention_window_q8_plain(
            q, ck, cv, ks, vs, kv_segment_ids, window_idx, num_kv_heads=num_kv_heads,
            scale=scale,
        )
    name = "decode_attention_window_q8"
    _check_window(name, q, ck, cv, kv_segment_ids, window_idx, num_kv_heads)
    s = ck.shape[1]
    if ks.shape != (b, num_kv_heads, s) or vs.shape != ks.shape:
        raise ValueError(
            f"{name}: scales {tuple(ks.shape)} / {tuple(vs.shape)}, "
            f"expected {(b, num_kv_heads, s)}"
        )
    q = q.contiguous()
    seg = kv_segment_ids.to(torch.int32).contiguous()
    kernels.require_dtype(name, torch.bfloat16, q=q)
    kernels.require_dtype(name, torch.int8, ck=ck, cv=cv)
    kernels.require_dtype(name, torch.float32, k_scale=ks, v_scale=vs)
    kernels.require_cuda_tensors(name, ck, cv, align=16)
    kernels.require_cuda_tensors(name, q, ks, vs, seg, window_idx)
    _require_heads(name, d, h, num_kv_heads, True)
    nsplit, chunk = _split_plan(b, num_kv_heads, s, kernels.sm_count(q.device))  # K4's plan
    part_o, part_ml, out = _window_scratch(q, nsplit)
    err = kernels.lib().radvlm_decode_attention_window_q8(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        seg.data_ptr(), window_idx.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, s, h, num_kv_heads, d, w, nsplit, chunk, scale,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, name)
    kernels.count_launch(name)
    return out
