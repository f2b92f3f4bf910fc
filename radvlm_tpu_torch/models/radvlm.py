"""RadVLM in PyTorch: vision tower + resampler + projector + decoder
(counterpart of `radvlm_tpu/models/radvlm.py`).

1. every tile of the batch runs through tower, resampler and projector in
   one call (`encode_tiles`);
2. the per-image anyres merge is the host-planned weighted gather
   (`merge_image_features`, `models/anyres.py`);
3. the splice at image positions is a `torch.where` over the host-computed
   index map `img_src` (`splice_embeds`).

`loss_fn` is the training loss: next-token cross entropy over the supervised
positions, the unembedding taken in chunks of 1024 positions that are
recomputed in the backward, so the [B, L, vocab] f32 logits never exist.
`token_logprobs` gives the same positions' log-probabilities one by one, in
the same chunks (the DPO and GRPO losses).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.config import IGNORE_INDEX, RadVLMConfig, tokens_per_tile
from radvlm_tpu_torch.models import qwen2, resampler, siglip, towers
from radvlm_tpu_torch.models.anyres import apply_merge
from radvlm_tpu_torch.models.layers import empty_param
from radvlm_tpu_torch.models.projector import Projector
from radvlm_tpu_torch.ops.image_ops import normalize_tiles_device
from radvlm_tpu_torch.parallel import sharding


class RadVLM(nn.Module):
    def __init__(self, cfg: RadVLMConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.vision_tower = towers.build(cfg.vision, **kw)
        width = towers.feature_size(cfg.vision)
        # None for the parameter-free kinds (identity, spatial_pool, masked_drop).
        self.resampler = resampler.build(cfg.resampler, width, **kw)
        # The projector takes the width after the resampler (the Q-Former's).
        self.projector = Projector(
            cfg.projector, resampler.output_dim(cfg.resampler, width), cfg.text.hidden_size, **kw
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
    model: RadVLM, cfg: RadVLMConfig, tiles: torch.Tensor, *, attn_impl: str = "auto",
    remat: bool = False, resampler_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[N, ts, ts, 3] -> [N, tokens_per_tile, D_text]: tower, resampler and
    projector, one batch. A `resampler_generator` means training (masked_drop
    draws its keep mask from it).

    uint8 tiles normalize on the device in f32, then cast once to the tower's
    dtype when its weights are bf16 (otherwise f32 pixels would promote every
    tower activation, attention included, to f32)."""
    mean, std = towers.mean_std(cfg.vision)
    tiles = normalize_tiles_device(tiles, mean=mean, std=std)
    if tiles.dtype == torch.float32 and any(
        p.dtype == torch.bfloat16 for p in model.vision_tower.parameters()
    ):
        tiles = tiles.to(torch.bfloat16)
    feats = towers.forward(model.vision_tower, cfg.vision, tiles, attn_impl=attn_impl,
                           remat=remat)
    feats = resampler.forward(model.resampler, cfg.resampler, feats,
                              generator=resampler_generator,
                              training=resampler_generator is not None)
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


def input_embeds(
    model: RadVLM,
    cfg: RadVLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    remat: bool = False,
    resampler_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The decoder's input [B, L, D]: every tile through the tower,
    resampler and projector, the anyres merge, and the splice into the text
    embedding."""
    b, t = batch["tiles"].shape[:2]
    flat_tiles = batch["tiles"].reshape((b * t,) + tuple(batch["tiles"].shape[2:]))
    tile_feats = encode_tiles(model, cfg, flat_tiles, attn_impl=attn_impl, remat=remat,
                              resampler_generator=resampler_generator)
    tile_feats = tile_feats.reshape(b, t, tokens_per_tile(cfg), -1)
    merged = merge_image_features(
        model, tile_feats, batch["merge_indices"], batch["merge_weights"]
    )
    return splice_embeds(model, batch["tokens"], batch["img_src"], merged, cfg)


def forward(
    model: RadVLM,
    cfg: RadVLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    remat: bool = False,
    kv_cache=None,
    cache_index=None,
    cache_segment_ids=None,
    return_hidden: bool = False,
    collect_kv: bool = False,
    return_aux: bool = False,
    resampler_generator: Optional[torch.Generator] = None,
):
    """Full multimodal forward. batch keys: tiles [B,T,ts,ts,3],
    merge_indices/weights [B,N,4], tokens/img_src/positions/segment_ids [B,L].
    Returns (logits [B,L,V] or hidden, cache) as `qwen2.forward`, and with
    `return_aux` (MoE training) the router loss as a third element. `remat`
    rematerialises every tower and decoder layer in the backward;
    `resampler_generator` is masked_drop's stream in training."""
    embeds = input_embeds(model, cfg, batch, attn_impl=attn_impl, remat=remat,
                          resampler_generator=resampler_generator)
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
        remat=remat,
        return_hidden=return_hidden,
        collect_kv=collect_kv,
        return_aux=return_aux,
    )


CE_CHUNK = 1024


def _chunk_logp(model: RadVLM, cfg: RadVLMConfig, hidden, labels) -> torch.Tensor:
    """log p(label) at each position of one block: unembed, f32
    log_softmax, gather."""
    logits = qwen2.unembed(model.text, cfg.text, hidden)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _chunk_nll(model: RadVLM, cfg: RadVLMConfig, hidden, labels, mask) -> torch.Tensor:
    """Summed NLL of one block of positions."""
    return -torch.sum(_chunk_logp(model, cfg, hidden, labels) * mask)


def _chunked_ce(model: RadVLM, cfg: RadVLMConfig, hidden: torch.Tensor,
                safe_labels: torch.Tensor, mask: torch.Tensor,
                chunk: int = CE_CHUNK) -> torch.Tensor:
    """Summed token NLL with the unembedding and log_softmax taken in
    sequence chunks under a (non-reentrant) checkpoint, so the whole
    [B, L, vocab] logits tensor never exists: one [B, chunk, V] block is
    alive at a time and is recomputed in the backward. hidden [B, L, D],
    safe_labels [B, L] (0 where unsupervised), mask [B, L] bool. The same
    f32 log_softmax per position as the unchunked form."""
    l = hidden.shape[1]
    if l <= chunk:
        return _chunk_nll(model, cfg, hidden, safe_labels, mask)
    total = hidden.new_zeros((), dtype=torch.float32)
    for s in range(0, l, chunk):
        total = total + checkpoint(
            _chunk_nll, model, cfg, hidden[:, s:s + chunk], safe_labels[:, s:s + chunk],
            mask[:, s:s + chunk], use_reentrant=False)
    return total


def _shifted(batch: Dict[str, torch.Tensor]):
    """(safe labels, mask) of next-token prediction: labels[i] supervises
    position i - 1, IGNORE_INDEX and segment 0 never count."""
    shift_labels = batch["labels"][:, 1:]
    mask = (shift_labels != IGNORE_INDEX) & (batch["segment_ids"][:, 1:] != 0)
    return torch.where(mask, shift_labels, torch.zeros_like(shift_labels)), mask


def token_logprobs(
    model: RadVLM,
    cfg: RadVLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = True,
    attn_impl: str = "auto",
    chunk: int = CE_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token log p(labels[i] | prefix) over the shifted positions:
    ([B, L-1] f32 log-probabilities, [B, L-1] f32 mask). The counterpart of
    the JAX package's `grpo.token_logprobs` over `radvlm.forward`'s logits
    (the same shift, mask and f32 log_softmax per position; unsupervised
    positions hold log p(token 0), as there). The unembedding runs in
    `chunk`-position blocks, each under a non-reentrant checkpoint when a
    gradient is taken (as `_chunked_ce`), so no [B, L, vocab] logits tensor
    ever exists."""
    hidden, _ = forward(model, cfg, batch, remat=remat, attn_impl=attn_impl, return_hidden=True)
    hidden = hidden[:, :-1]
    safe_labels, mask = _shifted(batch)
    grad = torch.is_grad_enabled() and hidden.requires_grad
    parts = []
    for s in range(0, hidden.shape[1], chunk):
        args = (model, cfg, hidden[:, s:s + chunk], safe_labels[:, s:s + chunk])
        parts.append(checkpoint(_chunk_logp, *args, use_reentrant=False) if grad
                     else _chunk_logp(*args))
    return torch.cat(parts, dim=1), mask.float()


def loss_fn(
    model: RadVLM,
    cfg: RadVLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    remat: bool = True,
    attn_impl: str = "auto",
    chunk: int = CE_CHUNK,
    resampler_generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy with IGNORE_INDEX masking: labels[i]
    supervises logits[i - 1], positions of segment 0 never count. A batch
    with "labels_next" instead of "labels" is shifted already
    (labels_next[i] supervises logits[i], segment gating folded in).
    Returns (loss, {"loss", "tokens"}); the loss is the mean over the
    supervised tokens (at least 1), over the global batch under the
    training mesh (`parallel/sharding.py`). An MoE decoder with `router_aux_coef`
    > 0 adds that times the router's load-balancing loss (the mean over the
    layers), reported as "moe_aux" ("loss" is then the sum).
    `resampler_generator` (the JAX `rng`) turns masked_drop on."""
    moe_aux = bool(cfg.text.num_experts) and cfg.text.router_aux_coef > 0
    out = forward(model, cfg, batch, remat=remat, attn_impl=attn_impl, return_hidden=True,
                  return_aux=moe_aux, resampler_generator=resampler_generator)
    hidden = out[0]
    if "labels_next" in batch:
        shift_labels = batch["labels_next"]
        mask = shift_labels != IGNORE_INDEX
        safe_labels = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
    else:
        hidden = hidden[:, :-1]
        safe_labels, mask = _shifted(batch)
    total = _chunked_ce(model, cfg, hidden, safe_labels, mask, chunk)
    # Under the training mesh a rank holds part of the batch: its summed loss
    # over the GLOBAL token count, so the ranks' gradients sum to the
    # one-device step's (the identity outside a mesh).
    mg = sharding.mesh_of(model)
    count = sharding.batch_all_reduce(mask.sum(), mg).clamp_min(1)
    loss = total / count
    reported = sharding.batch_all_reduce(total.detach(), mg) / count
    if moe_aux:
        loss = loss + cfg.text.router_aux_coef * out[2]
        reported = reported + cfg.text.router_aux_coef * out[2].detach()
    metrics = {"loss": reported, "tokens": count}
    if moe_aux:
        metrics["moe_aux"] = out[2].detach()
    return loss, metrics
