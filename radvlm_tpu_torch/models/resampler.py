"""Vision-token resamplers in PyTorch (counterpart of
`radvlm_tpu/models/resampler.py`): they sit between the tower and the
projector and reduce the tokens a tile gives the decoder.

- `identity` (RadVLM) and `masked_drop` at inference pass the features on;
- `spatial_pool`: stride-s average or max pooling of the square grid, rows
  and columns past `out * s` cropped (the 27 x 27 grid at stride 2);
- `masked_drop` in training zeroes a random `drop_ratio` share of each
  tile's tokens (the keep mask `uniform >= drop_ratio`, drawn from a
  `torch.Generator`; shapes stay static);
- `perceiver`: learned latents cross-attending to the features (tanh GELU);
- `qformer`: BLIP-2's query transformer over a bert-base trunk
  (`ln_vision` with eps 1e-5, the bert norms with 1e-12, cross-attention
  every `depth` layers, post-LN).

The perceiver's and the Q-Former's attention are plain einsums in f32
softmax, as in the JAX package (not `mha`: no kernel serves them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from radvlm_tpu_torch.config import ResamplerConfig
from radvlm_tpu_torch.models.layers import Linear, empty_param
from radvlm_tpu_torch.ops.attention import layer_norm

__all__ = ["ResamplerConfig", "build", "output_dim", "output_tokens", "forward"]


def output_dim(cfg: ResamplerConfig, dim: int) -> int:
    """Feature width after resampling (what the projector takes): the
    Q-Former's hidden size, else the tower's width."""
    return cfg.qformer_hidden if cfg.kind == "qformer" else dim


def output_tokens(cfg: ResamplerConfig, tokens_per_tile: int) -> int:
    if cfg.kind in ("identity", "masked_drop"):
        return tokens_per_tile  # masked_drop keeps the whole grid
    if cfg.kind in ("perceiver", "qformer"):
        return cfg.num_latents
    side = math.isqrt(tokens_per_tile)
    return (side // cfg.stride) ** 2


class PerceiverLayer(nn.Module):
    TREE = {
        "norm_media_scale": ("norm_media", "scale"), "norm_media_bias": ("norm_media", "bias"),
        "norm_latents_scale": ("norm_latents", "scale"),
        "norm_latents_bias": ("norm_latents", "bias"),
        "to_q": ("to_q",), "to_kv": ("to_kv",), "to_out": ("to_out",),
        "ff_norm_scale": ("ff_norm", "scale"), "ff_norm_bias": ("ff_norm", "bias"),
        "ff1": ("ff1",), "ff2": ("ff2",),
    }
    BARE = ("to_q", "to_kv", "to_out", "ff1", "ff2")  # kernels with no {kernel} node

    def __init__(self, cfg: ResamplerConfig, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = cfg.num_heads * cfg.head_dim
        for name in ("norm_media", "norm_latents", "ff_norm"):
            setattr(self, f"{name}_scale", empty_param(dim, **kw))
            setattr(self, f"{name}_bias", empty_param(dim, **kw))
        self.to_q = Linear.empty(dim, inner, False, **kw)
        self.to_kv = Linear.empty(dim, 2 * inner, False, **kw)
        self.to_out = Linear.empty(inner, dim, False, **kw)
        self.ff1 = Linear.empty(dim, cfg.ff_mult * dim, False, **kw)
        self.ff2 = Linear.empty(cfg.ff_mult * dim, dim, False, **kw)

    def forward(self, latents, feats, cfg: ResamplerConfig):
        n = feats.shape[0]
        h, hd = cfg.num_heads, cfg.head_dim
        x = layer_norm(feats, self.norm_media_scale, self.norm_media_bias, 1e-5)
        lat = layer_norm(latents, self.norm_latents_scale, self.norm_latents_bias, 1e-5)
        q = self.to_q(lat).reshape(n, -1, h, hd)
        k, v = self.to_kv(torch.cat([x, lat], dim=1)).chunk(2, dim=-1)
        k, v = k.reshape(n, -1, h, hd), v.reshape(n, -1, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(n, -1, h * hd)
        latents = latents + self.to_out(out)
        y = layer_norm(latents, self.ff_norm_scale, self.ff_norm_bias, 1e-5)
        return latents + self.ff2(F.gelu(self.ff1(y), approximate="tanh"))


class Perceiver(nn.Module):
    TREE = {"latents": ("latents",), "norm_scale": ("norm", "scale"),
            "norm_bias": ("norm", "bias")}

    def __init__(self, cfg: ResamplerConfig, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latents = empty_param(cfg.num_latents, dim, **kw)
        self.norm_scale, self.norm_bias = empty_param(dim, **kw), empty_param(dim, **kw)
        self.layers = nn.ModuleList(PerceiverLayer(cfg, dim, **kw) for _ in range(cfg.depth))

    def forward(self, cfg: ResamplerConfig, feats: torch.Tensor) -> torch.Tensor:
        latents = self.latents.to(feats.dtype).expand(feats.shape[0], -1, -1)
        for layer in self.layers:
            latents = layer(latents, feats, cfg)
        return layer_norm(latents, self.norm_scale, self.norm_bias, 1e-5)


class QFormerLayer(nn.Module):
    """One bert layer on the query path: self-attention, cross-attention to
    the image features in every `depth`-th layer, the query FFN; each
    sublayer dense -> residual -> LayerNorm."""

    TREE = {f"{blk}_{name}": (blk, name) for blk in ("self", "cross")
            for name in ("q", "k", "v", "out")}
    TREE.update({f"{blk}_ln_{p}": (blk, "ln", p) for blk in ("self", "cross", "ffn")
                 for p in ("scale", "bias")})
    TREE.update(ffn_up=("ffn", "up"), ffn_down=("ffn", "down"))

    def __init__(self, cfg: ResamplerConfig, dim: int, cross: bool, *, device=None, dtype=None):
        super().__init__()
        h, kw = cfg.qformer_hidden, dict(device=device, dtype=dtype)
        blocks = ("self", "cross") if cross else ("self",)
        for blk in blocks:
            kv_in = dim if blk == "cross" else h
            setattr(self, f"{blk}_q", Linear.empty(h, h, True, **kw))
            setattr(self, f"{blk}_k", Linear.empty(kv_in, h, True, **kw))
            setattr(self, f"{blk}_v", Linear.empty(kv_in, h, True, **kw))
            setattr(self, f"{blk}_out", Linear.empty(h, h, True, **kw))
        for blk in blocks + ("ffn",):
            setattr(self, f"{blk}_ln_scale", empty_param(h, **kw))
            setattr(self, f"{blk}_ln_bias", empty_param(h, **kw))
        self.ffn_up = Linear.empty(h, cfg.qformer_intermediate, True, **kw)
        self.ffn_down = Linear.empty(cfg.qformer_intermediate, h, True, **kw)

    def _attend(self, blk: str, cfg: ResamplerConfig, q_in, kv_in):
        n, heads = q_in.shape[0], cfg.qformer_heads
        hd = cfg.qformer_hidden // heads

        def proj(name, x):
            return getattr(self, f"{blk}_{name}")(x).reshape(n, -1, heads, hd)

        q, k, v = proj("q", q_in), proj("k", kv_in), proj("v", kv_in)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        attn = torch.softmax(logits.float(), dim=-1).to(q_in.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(n, -1, cfg.qformer_hidden)
        out = getattr(self, f"{blk}_out")(ctx)
        return layer_norm(out + q_in, getattr(self, f"{blk}_ln_scale"),
                          getattr(self, f"{blk}_ln_bias"), cfg.qformer_eps)

    def forward(self, q, x, cfg: ResamplerConfig):
        q = self._attend("self", cfg, q, q)
        if hasattr(self, "cross_q"):
            q = self._attend("cross", cfg, q, x)
        y = self.ffn_down(F.gelu(self.ffn_up(q)))
        return layer_norm(y + q, self.ffn_ln_scale, self.ffn_ln_bias, cfg.qformer_eps)


class QFormer(nn.Module):
    TREE = {"ln_vision_scale": ("ln_vision", "scale"), "ln_vision_bias": ("ln_vision", "bias"),
            "query_tokens": ("query_tokens",), "emb_ln_scale": ("emb_ln", "scale"),
            "emb_ln_bias": ("emb_ln", "bias")}
    STACKED = False  # the JAX tree holds a list of layers

    def __init__(self, cfg: ResamplerConfig, dim: int, *, device=None, dtype=None):
        super().__init__()
        h, kw = cfg.qformer_hidden, dict(device=device, dtype=dtype)
        self.ln_vision_scale, self.ln_vision_bias = empty_param(dim, **kw), empty_param(dim, **kw)
        self.query_tokens = empty_param(cfg.num_latents, h, **kw)
        self.emb_ln_scale, self.emb_ln_bias = empty_param(h, **kw), empty_param(h, **kw)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, dim, i % cfg.depth == 0, **kw) for i in range(cfg.qformer_layers))

    def forward(self, cfg: ResamplerConfig, feats: torch.Tensor) -> torch.Tensor:
        """feats [N, T, D] -> [N, num_latents, qformer_hidden] (the
        reference's attention masks are all ones: no mask)."""
        x = layer_norm(feats, self.ln_vision_scale, self.ln_vision_bias, 1e-5)
        q = self.query_tokens.to(feats.dtype).expand(feats.shape[0], -1, -1)
        q = layer_norm(q, self.emb_ln_scale, self.emb_ln_bias, cfg.qformer_eps)
        for layer in self.layers:
            q = layer(q, x, cfg)
        return q


def build(cfg: ResamplerConfig, dim: int, *, device=None, dtype=None) -> Optional[nn.Module]:
    """The resampler's module for tower width `dim`, uninitialised; None for
    the parameter-free kinds."""
    if cfg.kind == "perceiver":
        return Perceiver(cfg, dim, device=device, dtype=dtype)
    if cfg.kind == "qformer":
        return QFormer(cfg, dim, device=device, dtype=dtype)
    if cfg.kind in ("identity", "spatial_pool", "masked_drop"):
        return None
    raise NotImplementedError(f"resampler {cfg.kind!r} not implemented")


def draw_uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """masked_drop's uniform draw [N, T] in [0, 1)."""
    return torch.rand(shape, generator=generator, device=device)


def forward(module: Optional[nn.Module], cfg: ResamplerConfig, feats: torch.Tensor, *,
            generator: Optional[torch.Generator] = None, training: bool = False) -> torch.Tensor:
    """feats [N, T, D] per-tile features (T a square grid for the spatial
    kinds). masked_drop drops only when `training` and given a generator."""
    if cfg.kind == "identity":
        return feats
    if cfg.kind in ("perceiver", "qformer"):
        return module(cfg, feats)
    if cfg.kind == "masked_drop":
        if not training or generator is None:
            return feats
        n, t, _ = feats.shape
        keep = draw_uniform(generator, (n, t), feats.device) >= cfg.drop_ratio
        return feats * keep[..., None].to(feats.dtype)
    if cfg.kind != "spatial_pool":
        raise NotImplementedError(f"resampler {cfg.kind!r} not implemented")
    n, t, d = feats.shape
    side = math.isqrt(t)
    if side * side != t:
        raise ValueError(f"spatial_pool needs a square grid, got {t} tokens")
    s = cfg.stride
    out = side // s
    x = feats.reshape(n, side, side, d)[:, : out * s, : out * s].reshape(n, out, s, out, s, d)
    if cfg.mode == "average":
        return x.mean(dim=(2, 4)).reshape(n, out * out, d)
    return x.amax(dim=(2, 4)).reshape(n, out * out, d)
