"""Vision tower dispatch (counterpart of `radvlm_tpu/models/towers.py`): the
reference's `build_vision_tower` string dispatch and the four tower kinds,
SigLIP (RadVLM's), CLIP / CLIP+S2, EVA and ImageBind, selected by the
config's `kind`. Every tower maps pixels [B, S, S, 3] to
[B, tokens_per_tile, feature_size(cfg)]; everything downstream (resampler,
projector, anyres merge, splice) reads only that.
"""

from __future__ import annotations

import dataclasses
import json
import os

from radvlm_tpu_torch.config import SigLIPConfig
from radvlm_tpu_torch.models import clip, eva, imagebind, siglip
from radvlm_tpu_torch.ops.image_ops import SIGLIP_MEAN, SIGLIP_STD


def kind(vision_cfg) -> str:
    return getattr(vision_cfg, "kind", "siglip")


# open_clip hub models the reference names; the structure is CLIP's ViT
# (`hf_import.import_open_clip` reads the weight layout).
_OPEN_CLIP_MODELS = {
    # name: (hidden, intermediate, pretrained_layers, heads, image, patch)
    "ViT-H-14-378-quickgelu": (1280, 5120, 32, 16, 378, 14),
    "ViT-H-14-quickgelu": (1280, 5120, 32, 16, 224, 14),
    "ViT-L-14-336-quickgelu": (1024, 4096, 24, 16, 336, 14),
}


def _eva_config(name: str) -> eva.EVAVisionConfig:
    """The EVA-CLIP vision configs the reference's EVA towers name;
    intermediate_size is torch's truncation int(width * mlp_ratio)."""
    eva02 = dict(qkv_bias=True, subln=True, swiglu=True, rope=True,
                 rope_pt_seq_len=16, rope_intp_freq=True, norm="layernorm")
    eva8b = dict(qkv_bias=False, subln=False, swiglu=False, rope=False, norm="rms")
    table = {
        "EVA02-CLIP-L-14-336": dict(
            hidden_size=1024, head_dim=64, num_layers=24,
            intermediate_size=int(1024 * 2.6667), image_size=336, patch_size=14, **eva02),
        "EVA02-CLIP-L-14": dict(
            hidden_size=1024, head_dim=64, num_layers=24,
            intermediate_size=int(1024 * 2.6667), image_size=224, patch_size=14, **eva02),
        "EVA02-CLIP-B-16": dict(
            hidden_size=768, head_dim=64, num_layers=12,
            intermediate_size=int(768 * 2.6667), image_size=224, patch_size=16, **eva02),
        "EVA-CLIP-8B": dict(
            hidden_size=4096, head_dim=128, num_layers=32,
            intermediate_size=4096 * 5, image_size=224, patch_size=14, **eva8b),
        "EVA-CLIP-8B-plus": dict(
            hidden_size=4096, head_dim=128, num_layers=32,
            intermediate_size=4096 * 5, image_size=448, patch_size=14, **eva8b),
    }
    key = next((k for k in table if k.lower() in name.lower()
                and not (k == "EVA-CLIP-8B" and "plus" in name.lower())), None)
    if key is None:
        raise ValueError(f"unknown EVA tower {name!r}; known: {sorted(table)}")
    return eva.EVAVisionConfig(**table[key])


def config_from_tower_name(name: str, *, select_layer: int = -2, s2: bool = False,
                           s2_scales=()):
    """Tower name -> vision config, the reference's dispatch:

    - "imagebind_huge" -> ImageBind trunk + head;
    - "open_clip_hub:<model>" -> an open_clip visual transformer (CLIP);
    - "hf:<dir>" -> an HF vision config directory (clip_vision_model or
      siglip_vision_model);
    - a name containing "siglip" -> SigLIP;
    - an absolute path, "openai...", "laion..." or "...ShareGPT4V..." ->
      CLIP ViT-L/14-336 (S2 when `s2`);
    - "...internal-eva...", "...eva02...", "EVA-CLIP-8B(-plus)" -> EVA.

    `select_layer=-2` runs all but the last pretrained layer (only negative
    values); SigLIP, ImageBind and EVA ignore it, as the reference does."""
    if select_layer >= 0:
        raise ValueError(
            f"select_layer must be negative (hidden_states[-k]); got {select_layer}")
    drop = -select_layer - 1  # -2 -> run all but the last layer
    scales = tuple(s2_scales) if s2 else ()
    if name == "imagebind_huge":
        return imagebind.ImageBindVisionConfig()
    if name.startswith("open_clip_hub:"):
        model = name[len("open_clip_hub:"):]
        if model not in _OPEN_CLIP_MODELS:
            raise ValueError(
                f"unknown open_clip model {model!r}; known: {sorted(_OPEN_CLIP_MODELS)}")
        h, ffn, layers, heads, img, patch = _OPEN_CLIP_MODELS[model]
        return clip.CLIPVisionConfig(
            hidden_size=h, intermediate_size=ffn, num_layers=layers - drop, num_heads=heads,
            image_size=img, patch_size=patch, s2_scales=scales)
    if name.startswith("hf:"):
        with open(os.path.join(name[3:], "config.json")) as f:
            data = json.load(f)
        vis = data.get("vision_config", data)
        mt = vis.get("model_type", data.get("model_type", ""))
        if mt == "clip_vision_model":
            return clip.CLIPVisionConfig(
                hidden_size=vis.get("hidden_size", 1024),
                intermediate_size=vis.get("intermediate_size", 4096),
                num_layers=vis.get("num_hidden_layers", 24) - drop,
                num_heads=vis.get("num_attention_heads", 16),
                image_size=vis.get("image_size", 336),
                patch_size=vis.get("patch_size", 14),
            )
        if mt == "siglip_vision_model":
            return SigLIPConfig(
                hidden_size=vis.get("hidden_size", 1152),
                intermediate_size=vis.get("intermediate_size", 4304),
                num_layers=vis.get("num_hidden_layers", 27) - drop,
                num_heads=vis.get("num_attention_heads", 16),
                image_size=vis.get("image_size", 384),
                patch_size=vis.get("patch_size", 14),
            )
        raise ValueError(f"hf: tower arch {mt!r} unsupported (clip/siglip vision models)")
    if "siglip" in name.lower():
        return SigLIPConfig()
    if os.path.isabs(name) or name.startswith(("openai", "laion")) or "ShareGPT4V" in name:
        return clip.CLIPVisionConfig(num_layers=24 - drop, s2_scales=scales)
    if ("internal-eva" in name.lower() or "eva02" in name.lower()
            or name in ("EVA-CLIP-8B", "EVA-CLIP-8B-plus")):
        return _eva_config(name)
    raise ValueError(f"Unknown vision tower: {name}")


def feature_size(vision_cfg) -> int:
    return getattr(vision_cfg, "feature_size", vision_cfg.hidden_size)


def mean_std(vision_cfg):
    """Per-tower pixel normalization (SigLIP: 0.5 / 0.5; the others: the
    OpenAI CLIP stats)."""
    mean = getattr(vision_cfg, "mean", None)
    std = getattr(vision_cfg, "std", None)
    if mean is None:
        return SIGLIP_MEAN, SIGLIP_STD
    return tuple(mean), tuple(std)


def sequence_length(vision_cfg) -> int:
    """Tokens one tower pass attends over: the patches, and the class token
    where the tower has one (CLIP, EVA, ImageBind)."""
    patches = vision_cfg.patches_per_side ** 2
    return patches if kind(vision_cfg) == "siglip" else patches + 1


def passes_per_tile(vision_cfg) -> int:
    """Tower passes (base-size crops) per tile: more than 1 only under S2."""
    return clip.s2_crops(vision_cfg) if kind(vision_cfg) == "clip" else 1


def with_tower(model_cfg, name: str, *, select_layer: int = -2, s2: bool = False,
               s2_scales=()):
    """`model_cfg` rebuilt around the named tower (the training CLI's
    `--vision-tower` / `--mm-vision-select-layer`): the anyres tile size
    follows the tower's input size, and a one-token tower (ImageBind) forces
    `image_aspect_ratio="pad"`, since anyres merging needs a feature grid."""
    vis = config_from_tower_name(name, select_layer=select_layer, s2=s2, s2_scales=s2_scales)
    kwargs = {"image_aspect_ratio": "pad"} if vis.tokens_per_tile == 1 else {}
    return dataclasses.replace(
        model_cfg, vision=vis,
        anyres=dataclasses.replace(model_cfg.anyres, tile_size=vis.image_size), **kwargs)


_MODULES = {"siglip": (siglip, siglip.SigLIPTower), "clip": (clip, clip.CLIPTower),
            "eva": (eva, eva.EVATower), "imagebind": (imagebind, imagebind.ImageBindTower)}


def _module(vision_cfg):
    k = kind(vision_cfg)
    if k not in _MODULES:
        raise ValueError(f"unknown vision tower kind: {k!r}")
    return _MODULES[k]


def build(vision_cfg, *, device=None, dtype=None):
    """An uninitialised tower module for `vision_cfg`."""
    return _module(vision_cfg)[1](vision_cfg, device=device, dtype=dtype)


def forward(tower, vision_cfg, pixels, *, attn_impl: str = "auto", remat: bool = False):
    return _module(vision_cfg)[0].forward(tower, vision_cfg, pixels, attn_impl=attn_impl,
                                          remat=remat)
