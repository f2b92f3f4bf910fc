"""Qwen2 decoder in PyTorch (counterpart of `radvlm_tpu/models/qwen2.py`):
one decoder for every family the config describes. The rope families
(Qwen2, Llama, Mistral, Gemma): RMSNorm, rotary embeddings, GQA with
optional QKV bias, a SwiGLU / GeGLU MLP. MPT: ALiBi instead of rope, a
weight-only LayerNorm, a non-gated exact-GELU MLP (`up -> act -> down`).
MoE (Qwen2-MoE, Mixtral): the MLP of every layer is a `MoE` block, a
softmax router over the experts, top-k, and the experts' SwiGLUs stacked
[E, in, out] (the JAX layout of one layer), plus Qwen2-MoE's shared expert
behind a sigmoid gate. As in the JAX package, the experts are plain
matrix products outside any kernel (cuBLAS on the card), and they stay
dense when the model is quantized.

The JAX layer scan becomes a Python loop over `layers`. The KV cache keeps
the JAX package's stacked layout [L, B, Smax, Hkv*D] (kv heads folded into
the minor dim), bf16 (k, v) or int8 (k, v, k_scale, v_scale) with scales
[L, B, Hkv, Smax]; prefill runs cache-less and collects each layer's roped
K/V (`collect_kv`), decode writes the new token's K/V into the cache IN
PLACE - at one index for every row, or at each row's own index (continuous
batching) - and reads it through the K9 (bf16) or K4 (int8) decode kernel; a
per-row window of 2..16 tokens (the verify step of speculative decoding) is
written at each row's own offset and read through K10 / K11. ALiBi and a
sliding window take plain attention (the kernels have neither). Projections
are `Linear` or, for int8 / int4 weights, `QLinear` / `Q4Linear`
(`ops.quant.qmm` / `q4mm`); the token embedding may be int8 with one scale
per row.

Under the tensor-parallel context (`parallel/tp.py`) a rank holds its slice
of the layers and `_finish_block` all-reduces the o and down products (in
training differentiably, with `tp.copy_to` at the column-parallel inputs);
under the training mesh (`parallel/sharding.py`) `_block` gathers the
block's ZeRO-3 units and `_moe_mlp` computes this rank's experts; under
the sequence-parallel decode context (`parallel/sp_decode.py`) the cache is
the rank's block of the sequence and `_block_cached` merges the ranks'
partial attention.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.config import Qwen2Config
from radvlm_tpu_torch.models.layers import Linear, QLinear, empty_param, fuse_linears
from radvlm_tpu_torch.ops.attention import apply_rope, layer_norm, mha, rms_norm
from radvlm_tpu_torch.ops.decode_attention import (
    MAX_WINDOW,
    decode_attention_stacked,
    decode_attention_stacked_q8,
    decode_attention_stacked_window,
    decode_attention_stacked_window_q8,
    kernel_takes as decode_kernel_takes,
)
from radvlm_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv, quantize_kv_row
from radvlm_tpu_torch.ops.quant import dequantize_array
from radvlm_tpu_torch.parallel import sharding, sp_decode, tp

# (k, v) bf16, or (k, v) int8 + (k_scale, v_scale) f32.
Cache = Tuple[torch.Tensor, ...]
# A scalar write offset, or one per row ([B] int tensor).
CacheIndex = Union[int, torch.Tensor]


class SharedExpert(nn.Module):
    """Qwen2-MoE's always-on expert: a SwiGLU of width
    `shared_expert_intermediate_size`."""

    def __init__(self, d: int, m: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.gate = Linear.empty(d, m, False, **kw)
        self.up = Linear.empty(d, m, False, **kw)
        self.down = Linear.empty(m, d, False, **kw)


class MoE(nn.Module):
    """The sparse MLP of one layer (the JAX package's `mlp/moe` node): the
    router `Linear(d, E)`, the experts' SwiGLU tables `gate` / `up`
    [E, d, m] and `down` [E, m, d] (kernels in [in, out] layout, as in the
    JAX tree), and for Qwen2-MoE `shared` with `shared_gate` `Linear(d, 1)`.
    Mixtral (`shared_expert_intermediate_size == 0`) has no shared expert."""

    def __init__(self, cfg: Qwen2Config, *, device=None, dtype=None):
        super().__init__()
        d, e, m = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
        ms = cfg.shared_expert_intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.router = Linear.empty(d, e, False, **kw)
        self.gate = empty_param(e, d, m, **kw)
        self.up = empty_param(e, d, m, **kw)
        self.down = empty_param(e, m, d, **kw)
        self.shared = SharedExpert(d, ms, **kw) if ms else None
        self.shared_gate = Linear.empty(d, 1, False, **kw) if ms else None


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
        if cfg.num_experts:
            self.moe = MoE(cfg, **kw)
            return
        if cfg.mlp_gated:  # MPT's ffn has no gate branch
            self.gate = Linear.empty(d, f, False, **kw)
        self.up = Linear.empty(d, f, False, **kw)
        self.down = Linear.empty(f, d, False, **kw)


class Qwen2Decoder(nn.Module):
    def __init__(self, cfg: Qwen2Config, *, device=None, dtype=None):
        super().__init__()
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
    concat). Inference-time transform: fewer, wider decode matmuls. An MoE
    MLP has no dense gate/up pair (its experts stay in their tables) and
    MPT's non-gated MLP is one `up` matmul already: only their attention
    projections fuse, as in the JAX package."""
    for blk in model.layers:
        if hasattr(blk, "qkv"):
            continue
        blk.qkv = fuse_linears([blk.q, blk.k, blk.v])
        del blk.q, blk.k, blk.v
        if hasattr(blk, "gate"):
            blk.gateup = fuse_linears([blk.gate, blk.up])
            del blk.gate, blk.up
    return model


def _norm(cfg: Qwen2Config, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm for the rope families (Gemma's (1 + w) with the offset), the
    weight-only LayerNorm for MPT (HF MptBlock's norm_1 / norm_2, no bias)."""
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, w, None, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps, 1.0 if cfg.rms_norm_offset else 0.0)


def _act(cfg: Qwen2Config, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU's silu (Qwen2, Llama, Mistral), GeGLU's tanh GELU (Gemma),
    MPT's exact GELU."""
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
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, llama3)
        k = apply_rope(k, positions, cfg.rope_theta, llama3)
    return q, k, v


def _alibi(cfg: Qwen2Config) -> int:
    """`mha`'s `alibi` argument: bias_max for MPT, 0 (off) for rope."""
    return cfg.alibi_bias_max if cfg.pos_embedding == "alibi" else 0


def decode_kernel_eligible(cfg: Qwen2Config, cache_max_len: int, attn_impl: str,
                           quantized: bool = False) -> bool:
    """Do the decode kernels serve this config: K9 / K10 over the bf16 cache,
    K4 / K11 over the int8 one (`quantized`)? The one predicate that both
    `_block_cached` and `generation.engine.kernel_provenance` call.
    Excluded, as in the JAX package: a sliding window, a non-rope position
    scheme, impl="xla". Excluded too: a head shape the kernels do not take
    (`decode_attention.kernel_takes`: head_dim above 128, and for the int8
    cache one that is no multiple of 16; a GQA group above 8), which the
    JAX package's decode route takes on the TPU. On a CPU tensor the
    wrappers run their plain versions; on a CUDA tensor they launch the
    kernel or raise, so this predicate holds exactly where they launch."""
    return (
        attn_impl in ("auto", "flash")
        and cache_max_len > 0
        and cfg.sliding_window == 0
        and cfg.pos_embedding == "rope"
        and decode_kernel_takes(cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, quantized)
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
    if decode_kernel_eligible(cfg, cache_max_len, attn_impl, quantized):
        suffix = "_q8" if quantized else ""
        if s == 1:
            return "kernel" + suffix
        if per_row and 1 < s <= MAX_WINDOW:
            return "window" + suffix
    return "plain"


def _moe_mlp(cfg: Qwen2Config, moe: MoE, y: torch.Tensor):
    """The sparse MoE block (HF `Qwen2MoeSparseMoeBlock` /
    `MixtralSparseMoeBlock`): (out [b, s, d], aux f32 scalar).

    The router's softmax over the experts runs in f32, then top-k, the
    weights renormalised where `norm_topk_prob` (Mixtral always). Two modes,
    as the JAX package's (`cfg.moe_capacity_factor`):
    - 0, exact: every expert computes every token, and the sparse top-k
      weights combine them (serving and evaluation);
    - > 0, capacity: the GShard dispatch. Top-k picks are ranked rank-major
      (every token's first pick, then every second), each takes the next
      place of its expert, and picks past C = ceil(T k / E x factor) are
      dropped.
    Qwen2-MoE adds the shared expert scaled by sigmoid(shared_gate(y)).
    aux is the Switch / GShard load-balancing term E sum_e f_e P_e: f the
    share of top-k picks of expert e, P its mean router probability.

    Under the training mesh (`parallel/sharding.py`) the tokens are this
    rank's share of the global batch, and the global arithmetic is kept:
    f and P average over the batch ranks, capacity mode counts C from the
    global token count and ranks a pick after the picks before it in the
    global order (`sharding.row_offsets`: rows of the earlier ranks, and
    under seq > 1 the earlier sequence blocks of the same row). Over
    `expert` the tables hold this rank's E_local experts: the rank computes
    them on its tokens, and the shares sum (`tp.reduce_from`); x and the
    top-k weights enter through `tp.copy_to`, so their gradients sum the
    experts' parts. Over `tensor` every expert (and the shared expert)
    holds its slice of the m channels, gate / up column-parallel, down
    row-parallel: the products are partial sums, summed the same way."""
    b, s, d = y.shape
    t = b * s
    x = y.reshape(t, d)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(moe.router(y).reshape(t, e).float(), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)  # [T, k]
    if cfg.norm_topk_prob:
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-20)
    vals = vals.to(x.dtype)
    oh = F.one_hot(idx, e).float()  # [T, k, E]
    mg = sharding.mesh_of(moe)
    group = None if mg is None else mg.group("expert")
    tgroup = None if mg is None else mg.group("tensor")
    lo = 0 if group is None else mg.index["expert"] * moe.gate.shape[0]
    mine = slice(lo, lo + moe.gate.shape[0])
    xl = tp.copy_to(tp.copy_to(x, group), tgroup)
    vl = tp.copy_to(tp.copy_to(vals, group), tgroup)
    if cfg.moe_capacity_factor <= 0:
        h = torch.matmul(xl, moe.gate)  # [E_local, T, m]
        u = torch.matmul(xl, moe.up)
        eo = torch.matmul(F.silu(h) * u, moe.down)  # [E_local, T, d]
        w_te = torch.einsum("tke,tk->te", oh.to(vl.dtype), vl)
        out = torch.einsum("etd,te->td", eo, w_te[:, mine])
    else:
        t_all = t * sharding.batch_size(mg)
        cap = max(1, int(math.ceil(t_all * k / e * cfg.moe_capacity_factor)))
        ohm = oh.transpose(0, 1).reshape(k * t, e)
        before = torch.cumsum(ohm, dim=0) - ohm
        rows = oh.reshape(b, s, k, e).sum(1).transpose(0, 1)  # [k, b, E] picks a row
        offsets = sharding.row_offsets(rows, mg).repeat_interleave(s, dim=1)
        before = before + offsets.reshape(k * t, e)
        my_pos = (before * ohm).sum(-1).reshape(k, t).t().to(torch.int64)  # [T, k]
        keep = (my_pos < cap).to(x.dtype)
        # A dropped pick's place (>= cap) has no column: its one-hot row is 0.
        pos_oh = F.one_hot(my_pos.clamp_max(cap), cap + 1)[..., :cap].to(x.dtype)  # [T, k, C]
        ohx = oh[..., mine].to(x.dtype)
        disp = torch.einsum("tke,tkc,tk->tec", ohx, pos_oh, keep)
        comb = torch.einsum("tke,tkc,tk->tec", ohx, pos_oh, keep * vl)
        xe = torch.einsum("tec,td->ecd", disp, xl)
        h = torch.matmul(xe, moe.gate)  # [E_local, C, m]
        u = torch.matmul(xe, moe.up)
        eo = torch.matmul(F.silu(h) * u, moe.down)  # [E_local, C, d]
        out = torch.einsum("tec,ecd->td", comb, eo)
    out = tp.reduce_from(tp.reduce_from(out, group), tgroup)
    if moe.shared is not None:
        # One node before the shared expert with or without a tensor group,
        # so y's gradient sums its parts in the same order either way.
        ys = y.view_as(y) if tgroup is None else tp.copy_to(y, tgroup)
        sh = moe.shared.down(F.silu(moe.shared.gate(ys)) * moe.shared.up(ys))
        sh = tp.reduce_from(sh, tgroup).reshape(t, d)
        sgate = torch.sigmoid(moe.shared_gate(y).reshape(t, 1).float()).to(x.dtype)
        out = out + sgate * sh
    n = sharding.batch_size(mg)
    p_mean = sharding.batch_reduce_from(probs.mean(0), mg) / n
    f_mean = sharding.batch_all_reduce(oh.sum(1).mean(0), mg) / n
    aux = e * torch.sum(p_mean * f_mean)
    return out.reshape(b, s, d), aux


def _tp_group(blk: Qwen2Block):
    """The block's tensor group: the training mesh's (`sharding.mesh_of`)
    or the serving context's (`tp.active`); None without one."""
    mg = sharding.mesh_of(blk)
    return tp.context() if mg is None else mg.group("tensor")


def _finish_block(cfg: Qwen2Config, blk: Qwen2Block, res: torch.Tensor, attn: torch.Tensor,
                  w8a8: Optional[bool] = None):
    """The o projection and the MLP of a block: (out, aux), aux the layer's
    MoE router loss, None for a dense MLP. Under the tensor-parallel context
    o and down are row-parallel: their products are partial sums, summed over
    the ranks here (`tp.reduce_from`, the identity outside it), the
    block's only two collectives; the MLP's input enters the column-parallel
    gate / up through `tp.copy_to` (the identity without a gradient)."""
    b, s = attn.shape[:2]
    group = _tp_group(blk)
    x = res + tp.reduce_from(_proj(blk.o, attn.reshape(b, s, -1), w8a8), group)
    y = _norm(cfg, x, blk.ln2)
    if hasattr(blk, "moe"):
        out, aux = _moe_mlp(cfg, blk.moe, y)
        return x + out, aux
    y = tp.copy_to(y, group)
    if not cfg.mlp_gated:  # MPT: up -> act -> down
        return x + tp.reduce_from(_proj(blk.down, _act(cfg, _proj(blk.up, y, w8a8)), w8a8),
                                  group), None
    if hasattr(blk, "gateup"):
        gate, up = _proj(blk.gateup, y, w8a8).chunk(2, dim=-1)
    else:
        gate, up = _proj(blk.gate, y, w8a8), _proj(blk.up, y, w8a8)
    return x + tp.reduce_from(_proj(blk.down, _act(cfg, gate) * up, w8a8), group), None


def _block(
    cfg: Qwen2Config,
    blk: Qwen2Block,
    x: torch.Tensor,
    positions: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
    collect_kv: bool = False,
):
    """One decoder block, no cache: (out, kv, aux). kv is the roped (k, v)
    as bf16 [B, S, Hkv*D] with collect_kv (the cache is bf16 whatever the
    weights), else None; aux the layer's MoE router loss, None for a dense
    MLP. A block sharded over fsdp gathers its parameters for the call."""
    with sharding.unit_scope(blk):
        y = tp.copy_to(_norm(cfg, x, blk.ln1), _tp_group(blk))
        q, k, v = _qkv(cfg, blk, y, positions)
        attn = mha(
            q, k, v,
            q_segment_ids=segment_ids,
            kv_segment_ids=segment_ids,
            causal=True,
            impl=attn_impl,
            window=cfg.sliding_window,
            alibi=_alibi(cfg),
        )
        out, aux = _finish_block(cfg, blk, x, attn)
    kv = None
    if collect_kv:
        b, s = x.shape[:2]
        hkv_d = cfg.num_kv_heads * cfg.head_dim
        kv = (k.reshape(b, s, hkv_d).to(torch.bfloat16),
              v.reshape(b, s, hkv_d).to(torch.bfloat16))
    return out, kv, aux


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
    sp_group = sp_decode.context()
    if sp_group is not None:
        attn = sp_decode.block_attention(cfg, layer_idx, cache, q, k_flat, v_flat, cache_index,
                                         cache_segment_ids, sp_group)
        return _finish_block(cfg, blk, x, attn, w8a8=False)[0]
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
            alibi=_alibi(cfg),
        )
    return _finish_block(cfg, blk, x, attn, w8a8=False)[0]


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
    return_aux: bool = False,
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
    collect_kv the prompt's stacked K/V [L, B, S, Hkv*D] in bf16. With
    `return_aux` (the training path, no cache) a third element: the mean
    over the layers of the MoE router loss (0 for a dense decoder)."""
    if return_aux and kv_cache is not None:
        raise ValueError("return_aux is a training-path (no-cache) feature")
    x = input_embeds
    new_cache = None
    auxes = []
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
                x, kv, aux = checkpoint(_block, cfg, blk, x, positions, segment_ids, attn_impl,
                                        False, use_reentrant=False)
            else:
                x, kv, aux = _block(cfg, blk, x, positions, segment_ids, attn_impl, collect_kv)
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
            if return_aux:
                auxes.append(x.new_zeros((), dtype=torch.float32) if aux is None else aux)
        if collect_kv:
            new_cache = (torch.stack(ks), torch.stack(vs))
    x = _norm(cfg, x, model.norm)
    out = x if return_hidden else unembed(model, cfg, x)
    if return_aux:
        return out, new_cache, torch.stack(auxes).mean()
    return out, new_cache


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
