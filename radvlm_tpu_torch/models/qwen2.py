"""Qwen2 decoder in PyTorch (counterpart of `radvlm_tpu/models/qwen2.py`),
the dense rope families: RMSNorm, rotary embeddings, GQA with optional QKV
bias, SwiGLU/GeGLU MLP.

The JAX layer scan becomes a Python loop over `layers`. The KV cache keeps
the JAX package's stacked layout [L, B, Smax, Hkv*D] (kv heads folded into
the minor dim), bf16 (k, v) or int8 (k, v, k_scale, v_scale) with scales
[L, B, Hkv, Smax]; prefill runs cache-less and collects each layer's roped
K/V (`collect_kv`), decode writes the new token's K/V into the cache IN
PLACE - at one index for every row, or at each row's own index (continuous
batching) - and reads it through the K9 (bf16) or K4 (int8) decode kernel; a
per-row window of 2..16 tokens (the verify step of speculative decoding) is
written at each row's own offset and read through K10 / K11. Projections
are `Linear` or, for int8 / int4 weights, `QLinear` / `Q4Linear`
(`ops.quant.qmm` / `q4mm`); the token embedding may be int8 with one scale
per row. Not ported yet (they raise):
MoE, the ALiBi/LayerNorm MPT family, sequence-parallel decode.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.config import Qwen2Config
from radvlm_tpu_torch.models.layers import Linear, QLinear, empty_param, fuse_linears
from radvlm_tpu_torch.ops.attention import apply_rope, mha, rms_norm
from radvlm_tpu_torch.ops.decode_attention import (
    MAX_WINDOW,
    decode_attention_stacked,
    decode_attention_stacked_q8,
    decode_attention_stacked_window,
    decode_attention_stacked_window_q8,
)
from radvlm_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv, quantize_kv_row
from radvlm_tpu_torch.ops.quant import dequantize_array

# (k, v) bf16, or (k, v) int8 + (k_scale, v_scale) f32.
Cache = Tuple[torch.Tensor, ...]
# A scalar write offset, or one per row ([B] int tensor).
CacheIndex = Union[int, torch.Tensor]


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
        self.embed_scale = None  # [V, 1] f32 when `embed` is int8

    def set_int8_embedding(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the embedding by int8 rows [V, D] with one f32 scale per
        row [V, 1] (the JAX package's quantized embedding node)."""
        self.embed = nn.Parameter(q, requires_grad=False)
        self.embed_scale = nn.Parameter(scale.float(), requires_grad=False)


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


def _proj(lin, x: torch.Tensor, w8a8: Optional[bool]) -> torch.Tensor:
    """A projection; `w8a8` reaches int8 weights only (`QLinear`): a
    `Q4Linear` never quantizes its activations."""
    return lin(x, w8a8=w8a8) if isinstance(lin, QLinear) else lin(x)


def _qkv(cfg: Qwen2Config, blk: Qwen2Block, y: torch.Tensor, positions: torch.Tensor,
         w8a8: Optional[bool] = None):
    b, s, _ = y.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hasattr(blk, "qkv"):
        q, k, v = _proj(blk.qkv, y, w8a8).split([h * hd, hkv * hd, hkv * hd], dim=-1)
    else:
        q, k, v = (_proj(p, y, w8a8) for p in (blk.q, blk.k, blk.v))
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


def cached_attention_route(cfg: Qwen2Config, cache_max_len: int, attn_impl: str, s: int,
                           per_row: bool, quantized: bool) -> str:
    """Which attention `_block_cached` runs for `s` new tokens per row: the
    one predicate of its dispatch, which `generation.engine.kernel_provenance`
    calls too. "kernel" / "kernel_q8": one token through K9 / K4;
    "window" / "window_q8": a per-row window of 2..16 tokens (speculative
    verify) through K10 / K11; "plain": plain attention over the
    (dequantized) layer with the query offset - longer windows (a resume
    delta), a scalar offset, or a config the kernels exclude."""
    if decode_kernel_eligible(cfg, cache_max_len, attn_impl):
        suffix = "_q8" if quantized else ""
        if s == 1:
            return "kernel" + suffix
        if per_row and 1 < s <= MAX_WINDOW:
            return "window" + suffix
    return "plain"


def _finish_block(cfg: Qwen2Config, blk: Qwen2Block, res: torch.Tensor, attn: torch.Tensor,
                  w8a8: Optional[bool] = None):
    b, s = attn.shape[:2]
    x = res + _proj(blk.o, attn.reshape(b, s, -1), w8a8)
    y = _norm(cfg, x, blk.ln2)
    if hasattr(blk, "gateup"):
        gate, up = _proj(blk.gateup, y, w8a8).chunk(2, dim=-1)
    else:
        gate, up = _proj(blk.gate, y, w8a8), _proj(blk.up, y, w8a8)
    return x + _proj(blk.down, _act(cfg, gate) * up, w8a8)


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
    cache_index: CacheIndex,
    cache_segment_ids: torch.Tensor,
    attn_impl: str,
) -> torch.Tensor:
    """One decoder block against the stacked cache, bf16 (k, v) or int8
    (k, v, k_scale, v_scale). Writes the new tokens' K/V at `cache_index`
    IN PLACE (int8: quantized per (token, kv head) first): a scalar index
    writes [cache_index, cache_index+s) of every row; a [B] tensor writes
    each row's s tokens at [cache_index[b], cache_index[b]+s) (continuous
    batching at s == 1; the verify window of speculative decoding and the
    delta of a resumed conversation at s > 1). Then attends as
    `cached_attention_route` says: single-token decode through K9 / K4, a
    per-row window of up to 16 tokens through K10 / K11, else plain
    attention over the (dequantized) layer with the query block at offset
    `cache_index`.

    A window's entries past the accepted prefix stay in the cache as stale
    K/V (and scales) until the next window overwrites them: it starts at
    most s indices later and spans s, and the causal mask keys on the cache
    index, so no query reaches them first.

    Projections keep the activations unquantized here (w8a8=False), as the
    JAX package's stacked decode matmuls do."""
    quantized = len(cache) == 4
    per_row = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
    ck_all, cv_all = cache[0], cache[1]
    y = _norm(cfg, x, blk.ln1)
    q, k, v = _qkv(cfg, blk, y, positions, w8a8=False)
    b, s = x.shape[:2]
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    kv_dtype = torch.bfloat16 if quantized else ck_all.dtype
    k_flat = k.reshape(b, s, hkv * hd).to(kv_dtype)
    v_flat = v.reshape(b, s, hkv * hd).to(kv_dtype)
    if per_row and s > 1:
        rows = torch.arange(b, device=x.device)[:, None]  # [B, 1]
        idxw = cache_index.long()[:, None] + torch.arange(s, device=x.device)[None]  # [B, s]
        if quantized:
            (kq, ksc), (vq, vsc) = quantize_kv(k_flat, hkv), quantize_kv(v_flat, hkv)
            ck_all[layer_idx, rows, idxw] = kq
            cv_all[layer_idx, rows, idxw] = vq
            # [L, B, Hkv, S][l, rows, :, idxw]: the advanced dims come first,
            # so the values are [B, s, Hkv] (made contiguous for the scatter).
            cache[2][layer_idx, rows, :, idxw] = ksc.transpose(1, 2).contiguous()
            cache[3][layer_idx, rows, :, idxw] = vsc.transpose(1, 2).contiguous()
        else:
            ck_all[layer_idx, rows, idxw] = k_flat
            cv_all[layer_idx, rows, idxw] = v_flat
    elif per_row:
        rows = torch.arange(b, device=x.device)
        idx = cache_index.long()
        if quantized:
            (kq, ksc), (vq, vsc) = quantize_kv_row(k_flat[:, 0], hkv), quantize_kv_row(v_flat[:, 0], hkv)
            ck_all[layer_idx, rows, idx] = kq
            cv_all[layer_idx, rows, idx] = vq
            # [L, B, Hkv, S][l, rows, :, idx]: the advanced dims come first -> [B, Hkv].
            cache[2][layer_idx, rows, :, idx] = ksc
            cache[3][layer_idx, rows, :, idx] = vsc
        else:
            ck_all[layer_idx, rows, idx] = k_flat[:, 0]
            cv_all[layer_idx, rows, idx] = v_flat[:, 0]
    else:
        span = slice(cache_index, cache_index + s)
        if quantized:
            (kq, ksc), (vq, vsc) = quantize_kv(k_flat, hkv), quantize_kv(v_flat, hkv)
            ck_all[layer_idx, :, span] = kq
            cv_all[layer_idx, :, span] = vq
            cache[2][layer_idx, :, :, span] = ksc
            cache[3][layer_idx, :, :, span] = vsc
        else:
            ck_all[layer_idx, :, span] = k_flat
            cv_all[layer_idx, :, span] = v_flat
    smax = ck_all.shape[2]
    route = cached_attention_route(cfg, smax, attn_impl, s, per_row, quantized)
    if route == "kernel_q8":
        attn = decode_attention_stacked_q8(
            q[:, 0], ck_all, cv_all, cache[2], cache[3], cache_segment_ids, layer_idx,
            num_kv_heads=hkv,
        )[:, None]
    elif route == "kernel":
        attn = decode_attention_stacked(
            q[:, 0], ck_all, cv_all, cache_segment_ids, layer_idx, num_kv_heads=hkv
        )[:, None]
    elif route == "window_q8":
        attn = decode_attention_stacked_window_q8(
            q, ck_all, cv_all, cache[2], cache[3], cache_segment_ids, layer_idx,
            cache_index.to(torch.int32), num_kv_heads=hkv,
        )
    elif route == "window":
        attn = decode_attention_stacked_window(
            q, ck_all, cv_all, cache_segment_ids, layer_idx, cache_index.to(torch.int32),
            num_kv_heads=hkv,
        )
    else:
        ck, cv = ck_all[layer_idx], cv_all[layer_idx]
        if quantized:
            ck = dequantize_kv(ck, cache[2][layer_idx], hkv)
            cv = dequantize_kv(cv, cache[3][layer_idx], hkv)
        attn = mha(
            q,
            ck.reshape(b, smax, hkv, hd),
            cv.reshape(b, smax, hkv, hd),
            q_segment_ids=segment_ids,
            kv_segment_ids=cache_segment_ids,
            causal=True,
            q_offset=cache_index,
            impl=attn_impl,
            window=cfg.sliding_window,
        )
    return _finish_block(cfg, blk, x, attn, w8a8=False)


def embed_tokens(
    model: Qwen2Decoder, input_ids: torch.Tensor, cfg: Optional[Qwen2Config] = None
) -> torch.Tensor:
    ids = input_ids.long()
    if model.embed_scale is not None:
        # int8 embedding: gather rows and their scales, dequantize only those.
        out = (F.embedding(ids, model.embed).float() * F.embedding(ids, model.embed_scale))
        out = out.to(model.norm.dtype)
    else:
        out = F.embedding(ids, model.embed)
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
    cache_index: Optional[CacheIndex] = None,
    cache_segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = False,
    return_hidden: bool = False,
    collect_kv: bool = False,
):
    """Run the decoder stack. input_embeds [B, S, D].

    `remat` (training, cache-less path) rematerialises each layer in the
    backward and saves nothing inside it, as the JAX package's
    `jax.checkpoint(..., nothing_saveable)`: non-reentrant
    `torch.utils.checkpoint`, so the first forward already sees which
    inputs need a gradient and takes the same attention kernel as the
    recompute.

    With kv_cache (stacked (k, v), each [L, B, Smax, Hkv*D], or the int8
    4-tuple; updated in place), cache_index is the scalar write offset or a
    [B] tensor of per-row offsets, and cache_segment_ids [B, Smax]
    the segment ids of the cache contents. Returns
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
        remat = remat and torch.is_grad_enabled() and not collect_kv
        for blk in model.layers:
            if remat:
                out = checkpoint(_block, cfg, blk, x, positions, segment_ids, attn_impl,
                                 use_reentrant=False)
            else:
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
        emb = model.embed
        if model.embed_scale is not None:  # per-row scales: dequantize, transpose
            emb = dequantize_array(emb, model.embed_scale, hidden.dtype)
        return F.linear(hidden, emb)
    # Logits keep weight-only precision: per-token activation quantization
    # could flip a near-tie argmax.
    return _proj(model.lm_head, hidden, False)


def init_kv_cache(
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Cache:
    """Zeroed stacked cache, layout [L, B, Smax, Hkv*D]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def init_kv_cache_q8(cfg: Qwen2Config, batch: int, max_len: int, device=None) -> Cache:
    """Zeroed int8 cache: (k, v) int8 [L, B, Smax, Hkv*D] and per-(token,
    kv head) scales (k_scale, v_scale) f32 [L, B, Hkv, Smax]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads * cfg.head_dim)
    sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len)
    return (
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(sshape, dtype=torch.float32, device=device),
        torch.zeros(sshape, dtype=torch.float32, device=device),
    )
