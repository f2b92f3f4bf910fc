"""Qwen2 decoder in PyTorch (counterpart of `radvlm_tpu/models/qwen2.py`),
the dense rope families: RMSNorm, rotary embeddings, GQA with optional QKV
bias, SwiGLU/GeGLU MLP.

The JAX layer scan becomes a Python loop over `layers`. The KV cache keeps
the JAX package's stacked layout [L, B, Smax, Hkv*D] (kv heads folded into
the minor dim); prefill runs cache-less and collects each layer's roped K/V
(`collect_kv`), decode writes the new token's K/V into the cache IN PLACE and
reads it through the K9 decode kernel. Not ported yet (they raise): MoE, the
ALiBi/LayerNorm MPT family, the int8 cache, per-row and window cache writes,
sequence-parallel decode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from radvlm_tpu_torch.config import Qwen2Config
from radvlm_tpu_torch.models.layers import Linear, empty_param, fuse_linears
from radvlm_tpu_torch.ops.attention import apply_rope, mha, rms_norm
from radvlm_tpu_torch.ops.decode_attention import decode_attention_stacked

Cache = Tuple[torch.Tensor, torch.Tensor]


def _check_supported(cfg: Qwen2Config) -> None:
    if cfg.num_experts:
        raise NotImplementedError("MoE decoders are not ported (ROADMAP M10)")
    if cfg.pos_embedding != "rope" or cfg.norm_kind != "rmsnorm" or not cfg.mlp_gated:
        raise NotImplementedError("the MPT family (ALiBi) is not ported (ROADMAP M10)")


class Qwen2Block(nn.Module):
    def __init__(self, cfg: Qwen2Config, *, device=None, dtype=None):
        super().__init__()
        d, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.ln1, self.ln2 = empty_param(d, **kw), empty_param(d, **kw)
        bias = cfg.attention_bias
        # Unfused; `fuse_projections` replaces q/k/v by `qkv`, gate/up by `gateup`.
        self.q = Linear.empty(d, h * hd, bias, **kw)
        self.k = Linear.empty(d, hkv * hd, bias, **kw)
        self.v = Linear.empty(d, hkv * hd, bias, **kw)
        self.o = Linear.empty(h * hd, d, False, **kw)
        self.gate = Linear.empty(d, f, False, **kw)
        self.up = Linear.empty(d, f, False, **kw)
        self.down = Linear.empty(f, d, False, **kw)


class Qwen2Decoder(nn.Module):
    def __init__(self, cfg: Qwen2Config, *, device=None, dtype=None):
        super().__init__()
        _check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = empty_param(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(Qwen2Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.norm = empty_param(cfg.hidden_size, **kw)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else Linear.empty(cfg.hidden_size, cfg.vocab_size, False, **kw)
        )


def fuse_projections(model: Qwen2Decoder) -> Qwen2Decoder:
    """Fuse q/k/v into `qkv` and gate/up into `gateup`, in place (output-axis
    concat). Inference-time transform: fewer, wider decode matmuls."""
    for blk in model.layers:
        if hasattr(blk, "qkv"):
            continue
        blk.qkv = fuse_linears([blk.q, blk.k, blk.v])
        blk.gateup = fuse_linears([blk.gate, blk.up])
        del blk.q, blk.k, blk.v, blk.gate, blk.up
    return model


def _norm(cfg: Qwen2Config, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, w, cfg.rms_norm_eps, 1.0 if cfg.rms_norm_offset else 0.0)


def _act(cfg: Qwen2Config, x: torch.Tensor) -> torch.Tensor:
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu(x)
    return F.silu(x)


def _qkv(cfg: Qwen2Config, blk: Qwen2Block, y: torch.Tensor, positions: torch.Tensor):
    b, s, _ = y.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hasattr(blk, "qkv"):
        q, k, v = blk.qkv(y).split([h * hd, hkv * hd, hkv * hd], dim=-1)
    else:
        q, k, v = blk.q(y), blk.k(y), blk.v(y)
    q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
    llama3 = None
    if cfg.rope_scaling_type == "llama3":
        llama3 = dict(
            factor=cfg.rope_scaling,
            low_freq_factor=cfg.rope_low_freq_factor,
            high_freq_factor=cfg.rope_high_freq_factor,
            original_max_position=cfg.rope_original_max_position,
        )
    elif cfg.rope_scaling != 1.0:  # "linear"
        positions = positions.float() / cfg.rope_scaling
    q = apply_rope(q, positions, cfg.rope_theta, llama3)
    k = apply_rope(k, positions, cfg.rope_theta, llama3)
    return q, k, v


def decode_kernel_eligible(cfg: Qwen2Config, cache_max_len: int, attn_impl: str) -> bool:
    """Does the K9 decode kernel serve this config? The one predicate that
    both `_block_cached` and `generation.engine.kernel_provenance` call.
    Excluded, as in the JAX package: a sliding window, a non-rope position
    scheme, impl="xla". On a CPU tensor the wrapper runs the plain version;
    on a CUDA tensor it launches the kernel or raises for a shape the
    kernel does not take."""
    return (
        attn_impl in ("auto", "flash")
        and cache_max_len > 0
        and cfg.sliding_window == 0
        and cfg.pos_embedding == "rope"
    )


def _finish_block(cfg: Qwen2Config, blk: Qwen2Block, res: torch.Tensor, attn: torch.Tensor):
    b, s = attn.shape[:2]
    x = res + blk.o(attn.reshape(b, s, -1))
    y = _norm(cfg, x, blk.ln2)
    if hasattr(blk, "gateup"):
        gate, up = blk.gateup(y).chunk(2, dim=-1)
    else:
        gate, up = blk.gate(y), blk.up(y)
    return x + blk.down(_act(cfg, gate) * up)


def _block(
    cfg: Qwen2Config,
    blk: Qwen2Block,
    x: torch.Tensor,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
    collect_kv: bool = False,
):
    """One decoder block, no cache. With collect_kv also returns the roped
    (k, v) as bf16 [B, S, Hkv*D] - the cache is bf16 whatever the weights."""
    y = _norm(cfg, x, blk.ln1)
    q, k, v = _qkv(cfg, blk, y, positions)
    attn = mha(
        q, k, v,
        q_segment_ids=segment_ids,
        kv_segment_ids=segment_ids,
        causal=True,
        impl=attn_impl,
        window=cfg.sliding_window,
    )
    out = _finish_block(cfg, blk, x, attn)
    if not collect_kv:
        return out
    b, s = x.shape[:2]
    hkv_d = cfg.num_kv_heads * cfg.head_dim
    return out, (
        k.reshape(b, s, hkv_d).to(torch.bfloat16),
        v.reshape(b, s, hkv_d).to(torch.bfloat16),
    )


def _block_cached(
    cfg: Qwen2Config,
    blk: Qwen2Block,
    layer_idx: int,
    x: torch.Tensor,
    cache: Cache,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    cache_index: int,
    cache_segment_ids: torch.Tensor,
    attn_impl: str,
) -> torch.Tensor:
    """One decoder block against the stacked bf16 cache. Writes the new
    tokens' K/V at [layer_idx, :, cache_index:cache_index+s] IN PLACE, then
    attends: single-token decode through the K9 kernel, else plain attention
    with the query block at offset `cache_index`."""
    if len(cache) != 2:
        raise NotImplementedError("the int8 KV cache is not ported (ROADMAP M4/M9)")
    if not isinstance(cache_index, int):
        raise NotImplementedError(
            "per-row cache writes (continuous batching, speculative verify) "
            "are not ported (ROADMAP M5/M7)"
        )
    ck_all, cv_all = cache
    y = _norm(cfg, x, blk.ln1)
    q, k, v = _qkv(cfg, blk, y, positions)
    b, s = x.shape[:2]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    ck_all[layer_idx, :, cache_index : cache_index + s] = k.reshape(b, s, hkv * hd)
    cv_all[layer_idx, :, cache_index : cache_index + s] = v.reshape(b, s, hkv * hd)
    smax = ck_all.shape[2]
    if s == 1 and decode_kernel_eligible(cfg, smax, attn_impl):
        attn = decode_attention_stacked(
            q[:, 0], ck_all, cv_all, cache_segment_ids, layer_idx, num_kv_heads=hkv
        )[:, None]
    else:
        attn = mha(
            q,
            ck_all[layer_idx].reshape(b, smax, hkv, hd),
            cv_all[layer_idx].reshape(b, smax, hkv, hd),
            q_segment_ids=segment_ids,
            kv_segment_ids=cache_segment_ids,
            causal=True,
            q_offset=cache_index,
            impl=attn_impl,
            window=cfg.sliding_window,
        )
    return _finish_block(cfg, blk, x, attn)


def embed_tokens(
    model: Qwen2Decoder, input_ids: torch.Tensor, cfg: Optional[Qwen2Config] = None
) -> torch.Tensor:
    out = F.embedding(input_ids.long(), model.embed)
    if cfg is not None and cfg.embed_normalizer:
        out = out * torch.tensor(cfg.hidden_size ** 0.5, dtype=out.dtype)
    return out


def forward(
    model: Qwen2Decoder,
    cfg: Qwen2Config,
    *,
    input_embeds: torch.Tensor,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    cache_segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    return_hidden: bool = False,
    collect_kv: bool = False,
):
    """Run the decoder stack. input_embeds [B, S, D].

    With kv_cache (stacked (k, v), each [L, B, Smax, Hkv*D], updated in
    place), cache_index is the scalar write offset and cache_segment_ids
    [B, Smax] the segment ids of the cache contents. Returns
    (logits_or_hidden [B, S, V|D], cache): the same cache tensors, or with
    collect_kv the prompt's stacked K/V [L, B, S, Hkv*D] in bf16."""
    x = input_embeds
    new_cache = None
    if kv_cache is not None:
        for i, blk in enumerate(model.layers):
            x = _block_cached(
                cfg, blk, i, x, kv_cache, positions, segment_ids,
                cache_index, cache_segment_ids, attn_impl,
            )
        new_cache = kv_cache
    else:
        ks, vs = [], []
        for blk in model.layers:
            out = _block(cfg, blk, x, positions, segment_ids, attn_impl, collect_kv)
            if collect_kv:
                x, (k, v) = out
                ks.append(k)
                vs.append(v)
            else:
                x = out
        if collect_kv:
            new_cache = (torch.stack(ks), torch.stack(vs))
    x = _norm(cfg, x, model.norm)
    return (x if return_hidden else unembed(model, cfg, x)), new_cache


def unembed(model: Qwen2Decoder, cfg: Qwen2Config, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        return F.linear(hidden, model.embed)
    return model.lm_head(hidden)


def init_kv_cache(
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    """Zeroed stacked cache, layout [L, B, Smax, Hkv*D]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )
