"""Vision tower dispatch (counterpart of `radvlm_tpu/models/towers.py`).

Only SigLIP, the RadVLM tower, is ported; CLIP, EVA and ImageBind raise
(ROADMAP M10).
"""

from __future__ import annotations

from radvlm_tpu_torch.models import siglip
from radvlm_tpu_torch.ops.image_ops import SIGLIP_MEAN, SIGLIP_STD


def kind(vision_cfg) -> str:
    return getattr(vision_cfg, "kind", "siglip")


def _require_siglip(vision_cfg) -> None:
    if kind(vision_cfg) != "siglip":
        raise NotImplementedError(
            f"vision tower {kind(vision_cfg)!r} is not ported (ROADMAP M10)"
        )


def feature_size(vision_cfg) -> int:
    return getattr(vision_cfg, "feature_size", vision_cfg.hidden_size)


def mean_std(vision_cfg):
    """Per-tower pixel normalization (SigLIP: 0.5/0.5)."""
    mean = getattr(vision_cfg, "mean", None)
    std = getattr(vision_cfg, "std", None)
    if mean is None:
        return SIGLIP_MEAN, SIGLIP_STD
    return tuple(mean), tuple(std)


def build(vision_cfg, *, device=None, dtype=None) -> siglip.SigLIPTower:
    """An uninitialised tower module for `vision_cfg`."""
    _require_siglip(vision_cfg)
    return siglip.SigLIPTower(vision_cfg, device=device, dtype=dtype)


def forward(tower, vision_cfg, pixels, *, attn_impl: str = "auto"):
    _require_siglip(vision_cfg)
    return siglip.forward(tower, vision_cfg, pixels, attn_impl=attn_impl)
