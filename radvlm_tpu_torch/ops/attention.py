"""Attention ops in PyTorch: the plain reference and the dispatch to the
hand-written kernels (counterpart of `radvlm_tpu/ops/attention.py`).

Layout convention everywhere: [batch, seq, heads, head_dim] ("BSHD").
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from radvlm_tpu_torch.ops.flash_attention import kernel_takes

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

Offset = Union[int, torch.Tensor]


def make_attention_mask(
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool,
    q_offset: Offset = 0,
    window: int = 0,
) -> torch.Tensor:
    """Boolean [B, 1, Sq, Sk] mask, True = attend. Segment id 0 is padding;
    `q_offset` (scalar or per-row [B]) shifts query positions; `window` > 0
    keeps keys in (q_pos - window, q_pos]."""
    seg_mask = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]) & (
        q_segment_ids[:, :, None] != 0
    )
    if causal:
        sq, sk = q_segment_ids.shape[1], kv_segment_ids.shape[1]
        dev = q_segment_ids.device
        k_pos = torch.arange(sk, device=dev)[None, None, :]
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
            q_pos = torch.arange(sq, device=dev)[None, :, None] + q_offset[:, None, None]
        else:
            q_pos = (torch.arange(sq, device=dev)[:, None] + q_offset)[None]
        seg_mask = seg_mask & (q_pos >= k_pos)
        if window:
            seg_mask = seg_mask & (q_pos - k_pos < window)
    return seg_mask[:, None, :, :]


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] (head j reads kv head j // n_rep)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def alibi_head_slopes(num_heads: int, alibi_bias_max: int = 8) -> torch.Tensor:
    """Per-head ALiBi slopes, HF MPT convention."""
    p2 = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, p2 + 1, dtype=torch.float32) * (alibi_bias_max / p2)
    slopes = 1.0 / torch.pow(2.0, base)
    if p2 != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:num_heads]
    return slopes


def alibi_bias(num_heads: int, sk: int, alibi_bias_max: int = 8) -> torch.Tensor:
    """[1, H, 1, Sk] key-position ALiBi bias: slope * (k - (Sk-1))."""
    slopes = alibi_head_slopes(num_heads, alibi_bias_max)
    pos = torch.arange(sk, dtype=torch.float32) - (sk - 1)
    return (slopes[:, None] * pos[None, :])[None, :, None, :]


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention. q [B,Sq,H,D], k/v [B,Sk,Hkv,D], mask [B,1,Sq,Sk] bool.

    Softmax in f32 whatever the input dtype; masked logits take the finite
    DEFAULT_MASK_VALUE (so a fully masked row averages v, as in the JAX
    package); probabilities are cast to v's dtype before the PV product."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.to(logits.device, torch.float32)
    if mask is not None:
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_eligible(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    q_offset: Offset = 0,
    impl: str = "auto",
    window: int = 0,
    alibi: int = 0,
) -> bool:
    """Do the hand-written attention kernels (K1/K2, and K7/K8 under a
    gradient) serve this call?

    The one predicate `mha` and `generation.engine.kernel_provenance` both
    call. What the JAX package itself routes to XLA stays plain (a sliding
    window, ALiBi, a non-zero query offset, impl="xla"), and so does a head
    dim the kernels do not take (`flash_attention.kernel_takes`: above 128,
    or odd), which the JAX package's flash route takes on the TPU. On a CPU
    tensor the kernels' wrappers run their plain versions; on a CUDA tensor
    they launch the kernel or raise, so this predicate holds exactly where
    they launch."""
    if impl == "xla" or window or alibi or not kernel_takes(q.shape[-1]):
        return False
    return isinstance(q_offset, int) and q_offset == 0 and k.shape[1] >= q.shape[1]


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: Offset = 0,
    scale: Optional[float] = None,
    impl: str = "auto",
    window: int = 0,
    alibi: int = 0,
) -> torch.Tensor:
    """Multi-head attention entry point used by all models.

    impl: "auto"/"flash" take the kernels (`ops.flash_attention`) where
    `flash_eligible` holds, "xla" forces the plain path (the name is the JAX
    package's). "ring" (sequence-parallel ring attention) has no port yet.
    Where q, k or v needs a gradient the kernel route is K2 with the lse
    forward and K7 / K8 backward, the tower's calls included (K1 serves them
    only without a gradient); the plain route differentiates through
    `mha_reference` by autograd, as the JAX package's XLA path does.
    """
    if impl == "ring":
        raise NotImplementedError(
            "ring attention is not ported yet (ROADMAP M12, parallel/ring.py)"
        )
    if flash_eligible(q, k, q_offset=q_offset, impl=impl, window=window, alibi=alibi):
        from radvlm_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v,
            q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids,
            causal=causal,
            scale=scale,
        )
    mask = None
    if q_segment_ids is not None:
        mask = make_attention_mask(q_segment_ids, kv_segment_ids, causal, q_offset, window)
    elif causal:
        b = q.shape[0]
        ones_q = torch.ones((b, q.shape[1]), dtype=torch.int32, device=q.device)
        ones_k = torch.ones((b, k.shape[1]), dtype=torch.int32, device=q.device)
        mask = make_attention_mask(ones_q, ones_k, causal, q_offset, window)
    bias = alibi_bias(q.shape[2], k.shape[1], alibi) if alibi else None
    return mha_reference(q, k, v, mask=mask, scale=scale, bias=bias)


def llama3_scale_inv_freq(
    inv_freq: torch.Tensor,
    *,
    factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_position: int,
) -> torch.Tensor:
    """Llama-3.1 frequency-dependent rope remap (HF `_compute_llama3_parameters`)."""
    low_wavelen = original_max_position / low_freq_factor
    high_wavelen = original_max_position / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(mid, smoothed, scaled)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    llama3: Optional[dict] = None,
) -> torch.Tensor:
    """Rotary embedding, HF split-half convention, computed in f32 and cast
    back. x [B, S, H, D], positions [B, S] (int, or f32 for linear scaling);
    `llama3` (kwargs of `llama3_scale_inv_freq`) selects Llama-3.1 scaling."""
    d = x.shape[-1]
    half = d // 2
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) * 2.0 / d)
    )
    if llama3 is not None:
        inv_freq = llama3_scale_inv_freq(inv_freq, **llama3)
    freqs = positions[..., None].to(torch.float32) * inv_freq  # [B, S, half]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm with f32 statistics; `offset=1.0` applies (1 + w)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:
        w = w + offset
    return (x * w).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """LayerNorm with f32 statistics; bias=None is the weight-only variant."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)
