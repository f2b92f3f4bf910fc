"""EVA-CLIP vision tower (EVA-02 / EVA-CLIP-8B families) in PyTorch
(counterpart of `radvlm_tpu/models/eva.py`).

Every block runs, no final norm, the class token dropped. The knobs:

- `subln` (EVA-02): q / k / v without weight biases (q and v carry their
  own biases, k none; `qkv_bias`), a norm after attention (`inner_ln`) and
  one inside the MLP (`ffn_ln`);
- `swiglu` (EVA-02): w3(ffn_ln(silu(w1 x) * w2 x)); else fc1 -> exact GELU
  -> (ffn_ln) -> fc2;
- `rope` (EVA-02): 2D axial rotary embedding of the patch tokens' q and k
  (the class token passes through), interleaved pairs, with the fine-tune
  interpolation `rope_intp_freq`; the tables are computed in float64 numpy
  as the JAX package computes them;
- `postnorm`: the norm after the sublayer instead of before;
- `norm="rms"` (EVA-CLIP-8B): T5-style weight-only RMSNorm;
- layerscale: `gamma_1` / `gamma_2` per block.

Attention goes through `ops.attention.mha` with the explicit scale
head_dim^-0.5 (K1 on the card: 577 tokens at D = 64 for EVA02-L-336, 257 at
D = 128 for EVA-CLIP-8B).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.models.layers import Linear, empty_param
from radvlm_tpu_torch.models.siglip import patchify
from radvlm_tpu_torch.ops.attention import layer_norm, mha, rms_norm

# EVA transforms normalize with the OpenAI CLIP stats.
EVA_MEAN = (0.48145466, 0.4578275, 0.40821073)
EVA_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class EVAVisionConfig:
    """EVA ViT config (EVA02-CLIP-L-14-336 defaults)."""

    kind: str = "eva"
    hidden_size: int = 1024
    head_dim: int = 64
    num_layers: int = 24
    intermediate_size: int = 2730  # int(width * mlp_ratio), torch truncation
    image_size: int = 336
    patch_size: int = 14
    qkv_bias: bool = True
    subln: bool = True
    swiglu: bool = True
    postnorm: bool = False
    rope: bool = True
    rope_pt_seq_len: int = 16  # pretrain grid side (224/14)
    rope_intp_freq: bool = True
    norm: str = "layernorm"  # "layernorm" | "rms" (EVA-CLIP-8B)
    ls_init_value: Optional[float] = None  # layerscale (gamma_1/gamma_2)
    layer_norm_eps: float = 1e-6
    mean: Tuple[float, float, float] = EVA_MEAN
    std: Tuple[float, float, float] = EVA_STD

    @property
    def num_heads(self) -> int:
        return self.hidden_size // self.head_dim

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_tile(self) -> int:
        return self.patches_per_side ** 2  # cls dropped ("patch")

    @property
    def feature_size(self) -> int:
        return self.hidden_size


def rope_tables(cfg: EVAVisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [grid*grid, head_dim] f32: per-axis angles over dim =
    head_dim // 2 (each frequency twice, for the interleaved pair), row and
    column halves concatenated; float64 until the cast."""
    dim = cfg.head_dim // 2
    pt = cfg.rope_pt_seq_len
    ft = cfg.patches_per_side if cfg.rope_intp_freq else pt
    t = np.arange(ft, dtype=np.float64) / ft * pt
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    f = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)  # [ft, dim]
    full = np.concatenate(
        [np.broadcast_to(f[:, None, :], (ft, ft, f.shape[-1])),
         np.broadcast_to(f[None, :, :], (ft, ft, f.shape[-1]))],
        axis=-1,
    ).reshape(ft * ft, 2 * f.shape[-1])  # row-major grid, [S, head_dim]
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope(cfg: EVAVisionConfig, device: torch.device, dtype: torch.dtype):
    cos, sin = rope_tables(cfg)
    return (torch.from_numpy(cos).to(device, dtype)[None, :, None, :],
            torch.from_numpy(sin).to(device, dtype)[None, :, None, :])


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: (x0, x1) -> (-x1, x0)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _norm(cfg: EVAVisionConfig, x: torch.Tensor, scale, bias) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, scale, cfg.layer_norm_eps)
    return layer_norm(x, scale, bias, cfg.layer_norm_eps)


class EVALayer(nn.Module):
    TREE = {
        "ln1_scale": ("ln1", "scale"), "ln1_bias": ("ln1", "bias"),
        "ln2_scale": ("ln2", "scale"), "ln2_bias": ("ln2", "bias"),
        "q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"), "o": ("attn", "o"),
        "inner_ln_scale": ("attn", "inner_ln", "scale"),
        "inner_ln_bias": ("attn", "inner_ln", "bias"),
        "w1": ("mlp", "w1"), "w2": ("mlp", "w2"), "w3": ("mlp", "w3"),
        "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2"),
        "ffn_ln_scale": ("mlp", "ffn_ln", "scale"), "ffn_ln_bias": ("mlp", "ffn_ln", "bias"),
        "gamma_1": ("gamma_1",), "gamma_2": ("gamma_2",),
    }

    def __init__(self, cfg: EVAVisionConfig, *, device=None, dtype=None):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        rms = cfg.norm == "rms"

        def norm(name, width):
            setattr(self, f"{name}_scale", empty_param(width, **kw))
            setattr(self, f"{name}_bias", None if rms else empty_param(width, **kw))

        norm("ln1", d)
        norm("ln2", d)
        self.q = Linear.empty(d, d, cfg.qkv_bias, **kw)
        self.k = Linear.empty(d, d, False, **kw)
        self.v = Linear.empty(d, d, cfg.qkv_bias, **kw)
        self.o = Linear.empty(d, d, True, **kw)
        if cfg.subln:
            norm("inner_ln", d)
            norm("ffn_ln", f)
        if cfg.swiglu:
            self.w1 = Linear.empty(d, f, True, **kw)
            self.w2 = Linear.empty(d, f, True, **kw)
            self.w3 = Linear.empty(f, d, True, **kw)
        else:
            self.fc1 = Linear.empty(d, f, True, **kw)
            self.fc2 = Linear.empty(f, d, True, **kw)
        if cfg.ls_init_value is not None:
            self.gamma_1, self.gamma_2 = empty_param(d, **kw), empty_param(d, **kw)

    def attend(self, cfg: EVAVisionConfig, y: torch.Tensor, attn_impl: str) -> torch.Tensor:
        b, s, d = y.shape
        h, hd = cfg.num_heads, cfg.head_dim
        q, k, v = (p(y).reshape(b, s, h, hd) for p in (self.q, self.k, self.v))
        if cfg.rope:
            cos, sin = _rope(cfg, y.device, y.dtype)

            def rot(t):  # the patch tokens only; cls (index 0) passes through
                body = t[:, 1:] * cos + _rotate_half(t[:, 1:]) * sin
                return torch.cat([t[:, :1], body], dim=1)

            q, k = rot(q), rot(k)
        attn = mha(q, k, v, causal=False, impl=attn_impl, scale=hd ** -0.5).reshape(b, s, d)
        if cfg.subln:
            attn = _norm(cfg, attn, self.inner_ln_scale, self.inner_ln_bias)
        return self.o(attn)

    def feed(self, cfg: EVAVisionConfig, y: torch.Tensor) -> torch.Tensor:
        if cfg.swiglu:
            hid = F.silu(self.w1(y)) * self.w2(y)
            out = self.w3
        else:
            hid = F.gelu(self.fc1(y))
            out = self.fc2
        if cfg.subln:
            hid = _norm(cfg, hid, self.ffn_ln_scale, self.ffn_ln_bias)
        return out(hid)

    def forward(self, x: torch.Tensor, cfg: EVAVisionConfig, attn_impl: str = "auto"):
        g1, g2 = getattr(self, "gamma_1", None), getattr(self, "gamma_2", None)
        if cfg.postnorm:
            a = _norm(cfg, self.attend(cfg, x, attn_impl), self.ln1_scale, self.ln1_bias)
            x = x + (a if g1 is None else g1 * a)
            m = _norm(cfg, self.feed(cfg, x), self.ln2_scale, self.ln2_bias)
        else:
            a = self.attend(cfg, _norm(cfg, x, self.ln1_scale, self.ln1_bias), attn_impl)
            x = x + (a if g1 is None else g1 * a)
            m = self.feed(cfg, _norm(cfg, x, self.ln2_scale, self.ln2_bias))
        return x + (m if g2 is None else g2 * m)


class EVATower(nn.Module):
    TREE = {"patch_embed": ("patch_embed",), "class_embed": ("class_embed",),
            "pos_embed": ("pos_embed",)}

    def __init__(self, cfg: EVAVisionConfig, *, device=None, dtype=None):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = Linear.empty(p * p * 3, d, True, **kw)
        self.class_embed = empty_param(d, **kw)
        self.pos_embed = empty_param(cfg.tokens_per_tile + 1, d, **kw)
        self.layers = nn.ModuleList(EVALayer(cfg, **kw) for _ in range(cfg.num_layers))


def forward(tower: EVATower, cfg: EVAVisionConfig, pixels: torch.Tensor, *,
            attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """pixels [B, S, S, 3] normalized -> [B, tokens_per_tile, hidden_size]:
    the last block's tokens, cls dropped, no final norm."""
    if attn_impl == "ring":
        attn_impl = "auto"
    x = tower.patch_embed(patchify(pixels, cfg.patch_size))
    cls = tower.class_embed.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + tower.pos_embed[None]
    remat = remat and torch.is_grad_enabled()
    for layer in tower.layers:
        if remat:
            x = checkpoint(layer, x, cfg, attn_impl, use_reentrant=False)
        else:
            x = layer(x, cfg, attn_impl)
    return x[:, 1:]
