"""CLIP ViT vision tower in PyTorch, with the S2 multi-scale wrapper
(counterpart of `radvlm_tpu/models/clip.py`).

An OpenAI CLIP ViT (`openai/clip-vit-large-patch14-336` class) read at
`select_layer=-2` with the class token dropped: a patch matmul with no bias,
a class token and learned positions over cls + patches, `pre_ln`, pre-norm
blocks with quick_gelu, and `x[:, 1:]` on output with no post-LN.
`num_layers` counts the layers that run (23 of a 24-layer checkpoint).
Attention goes through `ops.attention.mha` (K1 on the card: every tile is
577 tokens, no mask), every matmul through `Linear` / `QLinear`.

S2 (`_forward_s2`): the tower runs at several scales; a larger scale is cut
into base-size crops, the crops' feature grids are put back together and
resized to the base grid, and the scales are concatenated channel-wise.
Both resizes are bilinear with antialiasing, as `jax.image.resize` does by
default (without it a 2x or 3x downsample differs by whole units), and run
in f32.

`ViTLayer` (a pre-norm block with biases everywhere) is shared with the
ImageBind trunk, whose GELU is the exact one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.models.layers import Linear, empty_param
from radvlm_tpu_torch.models.siglip import VIT_LAYER_TREE, patchify
from radvlm_tpu_torch.ops.attention import layer_norm, mha

# HF CLIPImageProcessor normalization (openai/clip-vit-large-patch14-336).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision tower config (ViT-L/14-336 defaults, select_layer=-2)."""

    kind: str = "clip"
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23  # 24 pretrained layers, select_layer=-2 -> run 23
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # S2 scales (multiples of image_size); () disables S2. E.g. (336, 672, 1008).
    s2_scales: Tuple[int, ...] = ()
    mean: Tuple[float, float, float] = CLIP_MEAN
    std: Tuple[float, float, float] = CLIP_STD

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size  # 24

    @property
    def tokens_per_tile(self) -> int:
        return self.patches_per_side ** 2  # 576

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def feature_size(self) -> int:
        """Per-token output width (channels concatenated over S2 scales)."""
        return self.hidden_size * max(len(self.s2_scales), 1)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


class ViTLayer(nn.Module):
    """Pre-norm block: LN -> q/k/v -> attention -> o, LN -> fc1 -> act -> fc2."""

    TREE = VIT_LAYER_TREE

    def __init__(self, d: int, f: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1_scale, self.ln1_bias = empty_param(d, **kw), empty_param(d, **kw)
        self.ln2_scale, self.ln2_bias = empty_param(d, **kw), empty_param(d, **kw)
        self.q = Linear.empty(d, d, True, **kw)
        self.k = Linear.empty(d, d, True, **kw)
        self.v = Linear.empty(d, d, True, **kw)
        self.o = Linear.empty(d, d, True, **kw)
        self.fc1 = Linear.empty(d, f, True, **kw)
        self.fc2 = Linear.empty(f, d, True, **kw)

    def forward(self, x: torch.Tensor, num_heads: int, eps: float,
                act: Callable[[torch.Tensor], torch.Tensor], attn_impl: str = "auto"):
        b, s, d = x.shape
        hd = d // num_heads
        y = layer_norm(x, self.ln1_scale, self.ln1_bias, eps)
        q, k, v = (p(y).reshape(b, s, num_heads, hd) for p in (self.q, self.k, self.v))
        x = x + self.o(mha(q, k, v, causal=False, impl=attn_impl).reshape(b, s, d))
        y = layer_norm(x, self.ln2_scale, self.ln2_bias, eps)
        return x + self.fc2(act(self.fc1(y)))


class CLIPTower(nn.Module):
    """Patch matmul (no bias), class token, positions over cls + patches,
    pre-LN and `num_layers` `ViTLayer`s; ImageBind's trunk subclasses it."""

    TREE = {
        "patch_embed": ("patch_embed",), "class_embed": ("class_embed",),
        "pos_embed": ("pos_embed",),
        "pre_ln_scale": ("pre_ln", "scale"), "pre_ln_bias": ("pre_ln", "bias"),
    }

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        p, d = cfg.patch_size, cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = Linear.empty(p * p * 3, d, False, **kw)
        self.class_embed = empty_param(d, **kw)
        self.pos_embed = empty_param(cfg.patches_per_side ** 2 + 1, d, **kw)
        self.pre_ln_scale, self.pre_ln_bias = empty_param(d, **kw), empty_param(d, **kw)
        self.layers = nn.ModuleList(
            ViTLayer(d, cfg.intermediate_size, **kw) for _ in range(cfg.num_layers))


def encode_cls(tower: CLIPTower, cfg, pixels: torch.Tensor, act, *, attn_impl: str = "auto",
               remat: bool = False) -> torch.Tensor:
    """[B, S, S, 3] normalized -> [B, 1 + patches, D]: the blocks' output,
    class token first."""
    x = tower.patch_embed(patchify(pixels, cfg.patch_size))
    cls = tower.class_embed.to(x.dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + tower.pos_embed[None]
    eps = cfg.layer_norm_eps
    x = layer_norm(x, tower.pre_ln_scale, tower.pre_ln_bias, eps)
    remat = remat and torch.is_grad_enabled()
    for layer in tower.layers:
        if remat:
            x = checkpoint(layer, x, cfg.num_heads, eps, act, attn_impl, use_reentrant=False)
        else:
            x = layer(x, cfg.num_heads, eps, act, attn_impl)
    return x


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C]: bilinear, half-pixel centres,
    antialiased when it shrinks, in f32 (`jax.image.resize(..., "bilinear")`)."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def s2_crops(cfg: CLIPVisionConfig) -> int:
    """Base-size crops the tower runs per tile: 1, or the sum over S2 scales
    of (scale / image_size)^2."""
    if not cfg.s2_scales:
        return 1
    return sum((s // cfg.image_size) ** 2 for s in cfg.s2_scales)


def forward(tower: CLIPTower, cfg: CLIPVisionConfig, pixels: torch.Tensor, *,
            attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """pixels [B, S, S, 3] normalized, S == image_size -> [B, tokens_per_tile,
    feature_size] (channels concatenated over S2 scales)."""
    if attn_impl == "ring":
        attn_impl = "auto"  # tiles are a fixed few hundred tokens

    def encode(px):
        return encode_cls(tower, cfg, px, quick_gelu, attn_impl=attn_impl, remat=remat)[:, 1:]

    if not cfg.s2_scales:
        return encode(pixels)
    return _forward_s2(encode, cfg, pixels)


def _forward_s2(encode, cfg: CLIPVisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """s2wrapper `multiscale_forward`: per scale, resize the input, split it
    into base-size crops (row major), run the tower on all of them at once,
    reassemble the crops' grids and resize back to the base grid; then
    concatenate the scales channel-wise."""
    b, c = pixels.shape[0], pixels.shape[-1]
    base, g = cfg.image_size, cfg.patches_per_side
    outs = []
    for scale in cfg.s2_scales:
        n = scale // base  # crops per side
        x = resize_bilinear(pixels, scale) if scale != pixels.shape[1] else pixels
        crops = x.reshape(b, n, base, n, base, c).permute(0, 1, 3, 2, 4, 5)
        feats = encode(crops.reshape(b * n * n, base, base, c))
        d = feats.shape[-1]
        grid = feats.reshape(b, n, n, g, g, d).permute(0, 1, 3, 2, 4, 5)
        grid = grid.reshape(b, n * g, n * g, d)
        if n > 1:
            grid = resize_bilinear(grid, g)
        outs.append(grid.reshape(b, g * g, d))
    return torch.cat(outs, dim=-1)
