"""ImageBind vision tower in PyTorch, the `imagebind_huge` branch of the tower
dispatch (counterpart of `radvlm_tpu/models/imagebind.py`).

The trunk is CLIP's (`models/clip.py`: patch matmul, class token, positions,
pre-LN, pre-norm blocks) with the exact GELU; the Conv3d stem over an image
repeated to two frames collapses to a 2D patch matmul with the temporal taps
summed (`collapse_video_stem`). The head is LayerNorm -> class token ->
Linear(1280 -> 1024, no bias), then an L2 normalization: one pooled
joint-space token per image, [B, 1, 1024]. The trunk's attention is K1 on the
card at 257 tokens and head_dim 80.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from radvlm_tpu_torch.models.clip import CLIPTower, encode_cls, exact_gelu
from radvlm_tpu_torch.models.layers import Linear, empty_param
from radvlm_tpu_torch.ops.attention import layer_norm

# The imagebind preprocessor normalizes with the CLIP stats.
IMAGEBIND_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGEBIND_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageBindVisionConfig:
    """imagebind_huge vision trunk + head."""

    kind: str = "imagebind"
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1024  # joint embedding space (head output)
    layer_norm_eps: float = 1e-6
    mean = IMAGEBIND_MEAN
    std = IMAGEBIND_STD

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size  # 16

    @property
    def tokens_per_tile(self) -> int:
        return 1  # one pooled joint-space token per image

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def feature_size(self) -> int:
        return self.embed_dim


def collapse_video_stem(conv3d_kernel) -> np.ndarray:
    """[D, C, T, p, p] Conv3d kernel -> [p*p*C, D] patchify matmul kernel for
    still images: every temporal tap sees the same frame, so the taps sum."""
    w = np.asarray(conv3d_kernel).sum(axis=2)  # [D, C, p, p]
    return np.transpose(w, (2, 3, 1, 0)).reshape(-1, w.shape[0])


class ImageBindTower(CLIPTower):
    TREE = dict(CLIPTower.TREE, head_ln_scale=("head", "ln", "scale"),
                head_ln_bias=("head", "ln", "bias"), head_proj=("head", "proj"))

    def __init__(self, cfg: ImageBindVisionConfig, *, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        d, kw = cfg.hidden_size, dict(device=device, dtype=dtype)
        self.head_ln_scale, self.head_ln_bias = empty_param(d, **kw), empty_param(d, **kw)
        self.head_proj = Linear.empty(d, cfg.embed_dim, False, **kw)


def forward(tower: ImageBindTower, cfg: ImageBindVisionConfig, pixels: torch.Tensor, *,
            attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """pixels [B, S, S, 3] normalized -> [B, 1, embed_dim], L2-normalized."""
    if attn_impl == "ring":
        attn_impl = "auto"
    x = encode_cls(tower, cfg, pixels, exact_gelu, attn_impl=attn_impl, remat=remat)
    h = layer_norm(x, tower.head_ln_scale, tower.head_ln_bias, cfg.layer_norm_eps)
    pooled = tower.head_proj(h[:, 0, :])
    norm = torch.linalg.vector_norm(pooled.float(), dim=-1, keepdim=True).clamp_min(1e-8)
    return (pooled / norm.to(pooled.dtype))[:, None, :]
