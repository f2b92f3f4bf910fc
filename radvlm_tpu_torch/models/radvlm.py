"""RadVLM in PyTorch: SigLIP tower + projector + Qwen2 (counterpart of
`radvlm_tpu/models/radvlm.py`).

1. every tile of the batch runs through tower + projector in one call
   (`encode_tiles`);
2. the per-image anyres merge is the host-planned weighted gather
   (`merge_image_features`, `models/anyres.py`);
3. the splice at image positions is a `torch.where` over the host-computed
   index map `img_src` (`splice_embeds`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from radvlm_tpu_torch.config import RadVLMConfig, tokens_per_tile
from radvlm_tpu_torch.models import qwen2, siglip, towers
from radvlm_tpu_torch.models.anyres import apply_merge
from radvlm_tpu_torch.models.layers import empty_param
from radvlm_tpu_torch.models.projector import Projector
from radvlm_tpu_torch.ops.image_ops import normalize_tiles_device


class RadVLM(nn.Module):
    def __init__(self, cfg: RadVLMConfig, *, device=None, dtype=None):
        super().__init__()
        tokens_per_tile(cfg)  # raises for a resampler that is not ported
        kw = dict(device=device, dtype=dtype)
        self.vision_tower = towers.build(cfg.vision, **kw)
        self.projector = Projector(
            cfg.projector, towers.feature_size(cfg.vision), cfg.text.hidden_size, **kw
        )
        self.text = qwen2.Qwen2Decoder(cfg.text, **kw)
        self.image_newline = empty_param(cfg.text.hidden_size, **kw)

    @property
    def device(self) -> torch.device:
        return self.image_newline.device


def fuse_for_inference(model: RadVLM, cfg: Optional[RadVLMConfig] = None) -> RadVLM:
    """Fuse the decoder's q/k/v and gate/up projections, and with `cfg` the
    SigLIP tower's q/k/v, in place. Call once after loading weights."""
    qwen2.fuse_projections(model.text)
    if cfg is not None and towers.kind(cfg.vision) == "siglip":
        siglip.fuse_projections(model.vision_tower)
    return model


def encode_tiles(
    model: RadVLM, cfg: RadVLMConfig, tiles: torch.Tensor, *, attn_impl: str = "auto"
) -> torch.Tensor:
    """[N, ts, ts, 3] -> [N, 729, D_text]: tower + projector, one batch.

    uint8 tiles normalize on the device in f32, then cast once to the tower's
    dtype when its weights are bf16 (otherwise f32 pixels would promote every
    tower activation, attention included, to f32)."""
    mean, std = towers.mean_std(cfg.vision)
    tiles = normalize_tiles_device(tiles, mean=mean, std=std)
    if tiles.dtype == torch.float32 and any(
        p.dtype == torch.bfloat16 for p in model.vision_tower.parameters()
    ):
        tiles = tiles.to(torch.bfloat16)
    feats = towers.forward(model.vision_tower, cfg.vision, tiles, attn_impl=attn_impl)
    return model.projector(feats)


def merge_image_features(
    model: RadVLM,
    tile_feats: torch.Tensor,
    merge_indices: torch.Tensor,
    merge_weights: torch.Tensor,
) -> torch.Tensor:
    """tile_feats [B, T, tpt, D]; merge_* [B, N, 4] -> [B, N, D]."""
    return torch.stack([
        apply_merge(f, model.image_newline, i, w)
        for f, i, w in zip(tile_feats, merge_indices, merge_weights)
    ])


def splice_embeds(
    model: RadVLM,
    tokens: torch.Tensor,
    img_src: torch.Tensor,
    merged: torch.Tensor,
    cfg: Optional[RadVLMConfig] = None,
) -> torch.Tensor:
    """Text embedding with image-token substitution. tokens/img_src [B, L]
    (img_src -1 for text, else a row of `merged` [B, N, D])."""
    text_emb = qwen2.embed_tokens(model.text, tokens, cfg.text if cfg is not None else None)
    if cfg is not None and cfg.text.embed_normalizer:
        merged = merged * torch.tensor(cfg.text.hidden_size ** 0.5, dtype=text_emb.dtype)
    safe = img_src.long().clamp(0, merged.shape[1] - 1)
    img_emb = torch.gather(
        merged, 1, safe[..., None].expand(-1, -1, merged.shape[-1])
    )
    return torch.where((img_src >= 0)[..., None], img_emb.to(text_emb.dtype), text_emb)


def forward(
    model: RadVLM,
    cfg: RadVLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    kv_cache=None,
    cache_index=None,
    cache_segment_ids=None,
    return_hidden: bool = False,
    collect_kv: bool = False,
):
    """Full multimodal forward. batch keys: tiles [B,T,ts,ts,3],
    merge_indices/weights [B,N,4], tokens/img_src/positions/segment_ids [B,L].
    Returns (logits [B,L,V] or hidden, cache) as `qwen2.forward`."""
    b, t = batch["tiles"].shape[:2]
    flat_tiles = batch["tiles"].reshape((b * t,) + tuple(batch["tiles"].shape[2:]))
    tile_feats = encode_tiles(model, cfg, flat_tiles, attn_impl=attn_impl)
    tile_feats = tile_feats.reshape(b, t, tokens_per_tile(cfg), -1)
    merged = merge_image_features(
        model, tile_feats, batch["merge_indices"], batch["merge_weights"]
    )
    embeds = splice_embeds(model, batch["tokens"], batch["img_src"], merged, cfg)
    return qwen2.forward(
        model.text,
        cfg.text,
        input_embeds=embeds,
        positions=batch["positions"],
        segment_ids=batch["segment_ids"],
        kv_cache=kv_cache,
        cache_index=cache_index,
        cache_segment_ids=cache_segment_ids,
        attn_impl=attn_impl,
        return_hidden=return_hidden,
        collect_kv=collect_kv,
    )
