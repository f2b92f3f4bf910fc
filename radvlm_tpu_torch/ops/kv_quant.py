"""int8 KV-cache quantization (counterpart of `radvlm_tpu/ops/kv_quant.py`).

Per (token, kv head) symmetric scales: each written cache row [Hkv*D]
carries Hkv f32 scales, stored [..., Hkv, S] (S minor) as in the JAX
package. Plain PyTorch, bit-exact with the JAX functions: the scale is
max(amax / 127, 1e-12) (a division, unlike `quantize_rows`), `torch.round`
rounds half to even, the quotient is clipped to +-127. The decode kernel K4
reads the cache without dequantizing it; `dequantize_kv` serves the plain
attention path (prefill into a cache, a query offset).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _quantize_heads(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf [..., Hkv, D] f32 -> (int8 [..., Hkv, D], scales [..., Hkv])."""
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor, num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., S, Hkv*D] -> (int8 same shape, scales [..., Hkv, S] f32)."""
    *lead, s, hd = x.shape
    q, scale = _quantize_heads(x.float().reshape(*lead, s, num_kv_heads, hd // num_kv_heads))
    return q.reshape(*lead, s, hd), scale.transpose(-1, -2).contiguous()


def quantize_kv_row(x: torch.Tensor, num_kv_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token write: [B, Hkv*D] -> (int8 [B, Hkv*D], scales [B, Hkv])."""
    b, hd = x.shape
    q, scale = _quantize_heads(x.float().reshape(b, num_kv_heads, hd // num_kv_heads))
    return q.reshape(b, hd), scale


def dequantize_kv(
    q: torch.Tensor, scale: torch.Tensor, num_kv_heads: int, dtype=torch.bfloat16
) -> torch.Tensor:
    """[..., S, Hkv*D] int8 + [..., Hkv, S] scales -> dense [..., S, Hkv*D]."""
    *lead, s, hd = q.shape
    sc = scale.transpose(-1, -2)[..., None]  # [..., S, Hkv, 1]
    out = q.float().reshape(*lead, s, num_kv_heads, hd // num_kv_heads) * sc
    return out.reshape(*lead, s, hd).to(dtype)
