"""Autoregressive generation in PyTorch (counterpart of
`radvlm_tpu/generation/engine.py`).

Prefill runs the prompt cache-less and splices the collected K/V into a
preallocated cache, bf16 or int8 (`cache_format`); decode is one
`decode_step` per token, updating the cache in place, at one write index
for the batch or one per row (the continuous engine). The JAX `while_loop`
becomes a host loop.

Batching convention: prompts are LEFT-padded (`multimodal.collate(
left_pad=True)`), so every row's last prompt token sits at index L-1; decode
writes at the uniform cache index L+step while rotary positions stay per row
(lengths[i]+step). The cache length is rounded up to a multiple of 128.

Sequence-parallel generation (`make_sp_prefill_fn`, `make_sp_generate_fn`)
runs one process per rank of a `seq` group: the ring prefill over the
prompt's blocks, then decode over a cache split along the sequence.

Sampling: greedy, or temperature/top-k/top-p with a `torch.Generator` (it
cannot reproduce `jax.random`'s draws; greedy tokens are comparable), for
the batch (`sample_token`) or per row (`sample_token_vec`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.generation.graphs import chunk_route
from radvlm_tpu_torch.models import qwen2, radvlm, towers
from radvlm_tpu_torch.models.layers import Q4Linear, QLinear
from radvlm_tpu_torch.ops.attention import flash_eligible
from radvlm_tpu_torch.ops.flash_attention import tower_eligible
from radvlm_tpu_torch.ops.int4_matmul import GROUP
from radvlm_tpu_torch.ops.kv_quant import quantize_kv
from radvlm_tpu_torch.ops.quant import qmm_route, w8a8_impl_name

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    eos_token_ids: Tuple[int, ...] = ()
    pad_token_id: int = 0
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> disabled
    top_p: float = 1.0  # 1 -> disabled


def sample_token(
    logits: torch.Tensor, gen: GenerationConfig, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / gen.temperature
    if gen.top_k > 0:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < gen.top_p
        threshold = torch.where(keep, sorted_logits, float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sampling_logits(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]; <= 0 -> greedy for that row
    top_p: torch.Tensor,  # [B]; >= 1 -> disabled for that row
    top_k: int = 0,
) -> torch.Tensor:
    """Per-row tempered logits with -inf outside each row's top-k/top-p
    keep set: the JAX `sample_token_vec`'s masking, step for step."""
    t = temperature.float().clamp_min(1e-6)[:, None]
    lg = logits.float() / t
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    p = top_p.float().clamp_min(1e-6)[:, None]
    sorted_logits = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < p  # the first token always stays
    threshold = torch.where(keep, sorted_logits, float("inf")).amin(-1, keepdim=True)
    return lg.masked_fill(lg < threshold, float("-inf"))


def sample_token_vec(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    top_k: int = 0,
) -> torch.Tensor:
    """Per-ROW temperature/top-p (and top-k) sampling for the continuous
    engine: logits [B, V] -> token ids [B] (int64); rows with temperature
    <= 0 take the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    probs = torch.softmax(sampling_logits(logits, temperature, top_p, top_k), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


def cache_length(prompt_len: int, max_new_tokens: int) -> int:
    return ((prompt_len + max_new_tokens + 127) // 128) * 128


@torch.inference_mode()
def prefill(
    model: radvlm.RadVLM,
    cfg: RadVLMConfig,
    batch: Batch,
    max_len: int,
    *,
    attn_impl: str = "auto",
    cache_format: str = "bf16",
):
    """Encode images and run the prompt through the decoder, filling the
    cache: bf16 (k, v) whatever the weights' dtype, as in the JAX package,
    or with cache_format="int8" the 4-tuple (k, v int8 + per-(token,
    kv-head) scales), the prompt's K/V quantized once here.

    batch: left-padded collate() output (torch tensors on the model's device)
    with padded length L <= max_len. Returns (cache, cache_segment_ids
    [B, max_len], last_logits [B, V])."""
    if cache_format not in ("bf16", "int8"):
        raise ValueError(f"cache_format must be 'bf16' or 'int8', got {cache_format!r}")
    l = batch["tokens"].shape[1]
    hidden, (ks, vs) = radvlm.forward(
        model, cfg, batch, attn_impl=attn_impl, return_hidden=True, collect_kv=True
    )
    cache, cache_seg = _prompt_cache(cfg, ks, vs, batch["segment_ids"], max_len, cache_format)
    logits = qwen2.unembed(model.text, cfg.text, hidden[:, l - 1])
    return cache, cache_seg, logits


def _prompt_cache(cfg: RadVLMConfig, ks: torch.Tensor, vs: torch.Tensor, seg: torch.Tensor,
                  max_len: int, cache_format: str):
    """The cache of a prompt's stacked K/V [L, B, l, Hkv*D] (bf16, or
    quantized once to int8) and its segment ids, at `max_len` positions."""
    b, l = seg.shape
    cache_seg = torch.zeros((b, max_len), dtype=seg.dtype, device=seg.device)
    cache_seg[:, :l] = seg
    if cache_format == "int8":
        hkv = cfg.text.num_kv_heads
        cache = qwen2.init_kv_cache_q8(cfg.text, b, max_len, device=ks.device)
        (kq, ksc), (vq, vsc) = quantize_kv(ks, hkv), quantize_kv(vs, hkv)
        for c, part in zip(cache[:2], (kq, vq)):
            c[:, :, :l] = part
        for c, part in zip(cache[2:], (ksc, vsc)):
            c[..., :l] = part
    else:
        cache = qwen2.init_kv_cache(cfg.text, b, max_len, device=ks.device)
        cache[0][:, :, :l] = ks
        cache[1][:, :, :l] = vs
    return cache, cache_seg


# Per-token batch arrays that the sequence-parallel prefill splits over the
# `seq` group; the images and merge plans stay whole on every rank.
SEQ_KEYS = ("tokens", "img_src", "positions", "segment_ids")


def _gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_sp_prefill_fn(cfg: RadVLMConfig, mesh, *, axis_name: str = "seq",
                       local_impl: str = "flash"):
    """Sequence-parallel prefill: ring attention over the mesh's `seq` group.

    prefill_fn(model, batch, max_len) -> (cache, cache_seg, last_logits),
    the contract of `prefill`, on every rank of the group. Every rank holds
    the whole (left-padded) batch and runs the decoder over its contiguous
    block of the padded prompt (rank i: [i*l/n, (i+1)*l/n)), whose length
    must divide by the group's size; the tower and the merge run whole on
    every rank. The blocks' K/V are all-gathered into the replicated prompt
    cache, and the last position's hidden state (the last rank's) into the
    logits. The ring context is saved and restored around the call, so a
    trainer's registered context survives an evaluation pass."""
    from radvlm_tpu_torch.parallel import ring as ring_mod

    group = ring_mod.group_of(mesh, axis_name)

    @torch.inference_mode()
    def prefill_fn(model, batch: Batch, max_len: int):
        prev = ring_mod._RING_CONTEXT
        ring_mod.enable_ring_attention(group, impl=local_impl, schedule="contiguous")
        try:
            b, l = batch["tokens"].shape
            n, r = dist.get_world_size(group), dist.get_rank(group)
            if l % n:
                raise ValueError(f"padded prompt length {l} not divisible by seq axis {n}")
            sl = l // n
            local = {k: (v[:, r * sl:(r + 1) * sl] if k in SEQ_KEYS else v)
                     for k, v in batch.items()}
            hidden, (ks, vs) = radvlm.forward(model, cfg, local, attn_impl="ring",
                                              return_hidden=True, collect_kv=True)
            ks, vs = _gather_seq(ks, group, 2), _gather_seq(vs, group, 2)
            last = _gather_seq(hidden[:, -1:], group, 1)[:, -1]  # the last rank's last row
            cache, cache_seg = _prompt_cache(cfg, ks, vs, batch["segment_ids"], max_len, "bf16")
            return cache, cache_seg, qwen2.unembed(model.text, cfg.text, last)
        finally:
            ring_mod._RING_CONTEXT = prev

    return prefill_fn


def make_sp_generate_fn(cfg: RadVLMConfig, mesh, gen: "GenerationConfig", *,
                        axis_name: str = "seq", local_impl: str = "flash",
                        kv_quant: bool = False):
    """Fully sequence-parallel generation for long multimodal contexts: the
    ring prefill (`make_sp_prefill_fn`), then decode over a cache split
    along the sequence (`parallel.sp_decode.make_sp_decode_step`). After the
    prefill each rank keeps only its block of the cache, int8-quantized with
    `kv_quant`.

    generate(model, batch, generator=None) -> {"tokens": [B, max_new],
    "num_tokens": [B]}, `make_generate_fn`'s contract (left-padded prompts),
    on every rank of the group."""
    from radvlm_tpu_torch.parallel.ring import group_of
    from radvlm_tpu_torch.parallel.sp_decode import make_sp_decode_step

    sp_prefill = make_sp_prefill_fn(cfg, mesh, axis_name=axis_name, local_impl=local_impl)
    sp_step = make_sp_decode_step(cfg.text, mesh, axis_name=axis_name, kv_quant=kv_quant)
    group = group_of(mesh, axis_name)

    @torch.inference_mode()
    def generate(model, batch: Batch, generator: Optional[torch.Generator] = None):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b, l = batch["tokens"].shape
        max_len = l + gen.max_new_tokens
        if max_len % n:
            max_len += n - max_len % n
        cache, cache_seg, logits = sp_prefill(model, batch, max_len)
        if kv_quant:
            # The prompt's K/V quantized once (prefill(cache_format="int8")'s
            # contract), then split like the bf16 cache.
            hkv = cfg.text.num_kv_heads
            (kq, ksc), (vq, vsc) = quantize_kv(cache[0], hkv), quantize_kv(cache[1], hkv)
            cache = (kq, vq, ksc, vsc)
        s_local = max_len // n
        own = slice(r * s_local, (r + 1) * s_local)
        cache = tuple(c[:, :, own].contiguous() if i < 2 else c[..., own].contiguous()
                      for i, c in enumerate(cache))
        cache_seg = cache_seg[:, own].contiguous()
        lengths = batch["lengths"].to(logits.device)
        tok = sample_token(logits, gen, generator)
        out_toks = [tok]
        num = np.full((b,), gen.max_new_tokens, np.int64)
        done = np.zeros((b,), bool)
        eos = np.asarray(list(gen.eos_token_ids), np.int64)
        for step in range(gen.max_new_tokens - 1):
            newly = ~done & np.isin(tok.cpu().numpy(), eos)
            num[newly] = step + 1
            done |= newly
            if done.all():
                break
            cache, cache_seg, lg = sp_step(model.text, cache, cache_seg, tok, lengths + step,
                                           l + step)
            tok = sample_token(lg, gen, generator)
            out_toks.append(tok)
        toks = torch.stack(out_toks, dim=1)
        pad_id = gen.pad_token_id or 0
        toks = torch.nn.functional.pad(toks, (0, gen.max_new_tokens - toks.shape[1]),
                                       value=pad_id)
        # Past a row's count the tokens are what it decoded after its eos:
        # pad, as make_generate_fn leaves them.
        num_t = torch.as_tensor(num, device=toks.device)
        keep = torch.arange(gen.max_new_tokens, device=toks.device)[None] < num_t[:, None]
        return {"tokens": torch.where(keep, toks, torch.full_like(toks, pad_id)),
                "num_tokens": num_t}

    return generate


@torch.inference_mode()
def decode_step(
    model: radvlm.RadVLM,
    cfg: RadVLMConfig,
    cache,
    cache_seg: torch.Tensor,
    tok: torch.Tensor,
    positions: torch.Tensor,
    write_idx: qwen2.CacheIndex,
    *,
    attn_impl: str = "auto",
):
    """One decode step: tok [B], positions [B] (rope), write_idx the cache
    slot (an int for every row, or a [B] tensor, one per row). The cache and
    cache_seg are updated in place; nothing here waits on the device.
    Returns (cache, cache_seg, logits [B, V])."""
    b = tok.shape[0]
    if isinstance(write_idx, torch.Tensor):
        # A device-side 1: a Python scalar here would go up through pageable
        # memory and wait on the card.
        cache_seg.index_put_((torch.arange(b, device=tok.device), write_idx.long()),
                             cache_seg.new_ones(()))
    else:
        write_idx = int(write_idx)
        cache_seg[:, write_idx] = 1
    embeds = qwen2.embed_tokens(model.text, tok[:, None], cfg.text)
    logits, cache = qwen2.forward(
        model.text,
        cfg.text,
        input_embeds=embeds,
        positions=positions[:, None],
        segment_ids=torch.ones((b, 1), dtype=torch.int32, device=tok.device),
        kv_cache=cache,
        cache_index=write_idx,
        cache_segment_ids=cache_seg,
        attn_impl=attn_impl,
    )
    return cache, cache_seg, logits[:, 0]


def make_generate_fn(cfg: RadVLMConfig, gen: GenerationConfig, *, attn_impl: str = "auto"):
    """generate(model, batch, generator) -> {tokens [B, max_new], num_tokens [B]}.

    Same contract as the JAX package's: tokens after a row's eos are
    pad_token_id; the loop stops when every row is done."""

    @torch.inference_mode()
    def generate(model, batch: Batch, generator: Optional[torch.Generator] = None):
        b, l = batch["tokens"].shape
        max_len = cache_length(l, gen.max_new_tokens)
        cache, cache_seg, logits = prefill(model, cfg, batch, max_len, attn_impl=attn_impl)
        dev = logits.device
        lengths = batch["lengths"].to(dev)
        eos = torch.tensor(gen.eos_token_ids or (-1,), device=dev)
        tok = sample_token(logits, gen, generator)
        out = torch.full((b, gen.max_new_tokens), gen.pad_token_id, dtype=torch.long, device=dev)
        out[:, 0] = tok
        done = torch.isin(tok, eos)
        num = torch.ones((b,), dtype=torch.long, device=dev)
        for step in range(1, gen.max_new_tokens):
            if bool(done.all()):
                break
            cache, cache_seg, logits = decode_step(
                model, cfg, cache, cache_seg, tok, lengths + step - 1, l + step - 1,
                attn_impl=attn_impl,
            )
            nxt = sample_token(logits, gen, generator)
            nxt = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt)
            out[:, step] = nxt
            num = num + (~done).long()
            done = done | torch.isin(nxt, eos)
            tok = nxt
        return {"tokens": out, "num_tokens": num}

    return generate


def make_stream_fns(cfg: RadVLMConfig, *, attn_impl: str = "auto"):
    """(prefill_fn, step_fn) pair for host-driven token streaming.

    prefill_fn(model, batch, max_len) -> (cache, cache_seg, logits [B,V])
    step_fn(model, cache, cache_seg, tok [B], positions [B], write_idx) ->
        (cache, cache_seg, logits [B,V])"""

    def prefill_fn(model, batch, max_len: int):
        return prefill(model, cfg, batch, max_len, attn_impl=attn_impl)

    def step_fn(model, cache, cache_seg, tok, positions, write_idx):
        return decode_step(
            model, cfg, cache, cache_seg, tok, positions, write_idx, attn_impl=attn_impl
        )

    return prefill_fn, step_fn


@torch.inference_mode()
def stream_generate(
    model,
    cfg: RadVLMConfig,
    batch: Batch,
    gen: GenerationConfig,
    *,
    stream_fns=None,
    attn_impl: str = "auto",
    generator: Optional[torch.Generator] = None,
) -> Iterator[np.ndarray]:
    """Yield one [B] numpy token array per decode step."""
    if stream_fns is None:
        stream_fns = make_stream_fns(cfg, attn_impl=attn_impl)
    prefill_fn, step_fn = stream_fns
    b, l = batch["tokens"].shape
    max_len = cache_length(l, gen.max_new_tokens)
    cache, cache_seg, logits = prefill_fn(model, batch, max_len)
    lengths = batch["lengths"].to(logits.device)
    eos = list(gen.eos_token_ids)
    done = np.zeros((b,), bool)
    tok = sample_token(logits, gen, generator)
    for step in range(gen.max_new_tokens):
        tok_np = tok.cpu().numpy()
        tok_np = np.where(done, gen.pad_token_id, tok_np)
        if eos:
            done |= np.isin(tok_np, eos)
        yield tok_np
        if done.all() or step == gen.max_new_tokens - 1:
            break
        cache, cache_seg, logits = step_fn(
            model, cache, cache_seg, torch.as_tensor(tok_np, device=logits.device),
            lengths + step, l + step,
        )
        tok = sample_token(logits, gen, generator)


def trim_at_stop_strings(text: str, stop_strings: Sequence[str]) -> str:
    """Host-side stop-string trim (KeywordsStoppingCriteria semantics)."""
    cut = len(text)
    for s in stop_strings:
        i = text.find(s)
        if i >= 0:
            cut = min(cut, i)
    return text[:cut]


def kernel_provenance(
    cfg: RadVLMConfig,
    *,
    prompt_len: int,
    max_new_tokens: int,
    attn_impl: str = "auto",
    quantized: bool = False,
    cache_format: str = "bf16",
    fill_rows: int = 1,
    tiles: int = 1,
    decode_rows: int = 1,
    spec_k: int = 0,
    weight_bits: int = 8,
    tower_grad: bool = False,
    device: str = "cuda",
    tp_group=None,
    eager_chunks: bool = False,
) -> Dict[str, object]:
    """Which path each stage takes for this geometry, from the same
    predicates the dispatch calls, plus the kernels' launch counts so far.

    Attention stages read "kernel" when their kernel serves them (on a CUDA
    tensor the wrapper launches it; on a CPU tensor it runs the plain
    version) and "plain" where the dispatch routes to plain attention, as
    the JAX package routes to XLA (window, ALiBi, non-zero query offset,
    impl="xla"). With int8 weights (`quantized`), the matmul stages read
    `ops.quant.qmm_route` for their row counts: the fill's projections
    (`fill_rows` prompts of `prompt_len` tokens, and of `tiles` tower tiles
    each, all in one tower batch), the decode projections (`decode_rows`
    slots) and the lm_head (weight-only): "w8a8" (K3), "int8" (K5/K6) or
    "dequant". With `weight_bits=4` (an int4 model: its layers' projections
    are `Q4Linear`, the tower's `fc2` whose contraction dim does not divide
    by 128, and the lm_head, stay int8) the decoder's stages read the int4
    route, "int4" (K12) or "dequant", and `tower_matmul` splits into
    `tower_matmul` (int4) and `tower_matmul_int8` (fc2). `w8a8_impl` says
    which kernel a "w8a8" stage launches: "kernel" (K3 after
    `quantize_rows`), "fused" (K13), or "off" when no stage takes that
    route. With `spec_k` (a speculative engine) the verify window's
    stages are added: its attention over spec_k + 1 queries per slot
    ("window" K10, "window_q8" K11, or "plain") and its matmuls at
    `decode_rows * (spec_k + 1)` rows. With `tower_grad` (training with a
    tunable tower) the tower's attention reads "kernel_lse": K2 with the lse
    and the K7 / K8 backward instead of K1, which writes no lse, where the
    kernels take its head dim under a gradient (else "plain").
    `train_attention` is the decoder's attention under a gradient (SFT, DPO,
    GRPO's updates) at `prompt_len`: "kernel_lse" (K2 with the lse, K7 /
    K8 backward) wherever the prefill's route is "kernel", the backward
    kernels taking the forward's head dims (up to 256, Gemma-2B's), else
    "plain". The tower's attention and matmuls are judged at the tower's own
    sequence length (`towers.sequence_length`: the patches and a class
    token, before any resampler) and S2 crop count; `resampler_attention`
    reads "plain" for the perceiver and the Q-Former and "none" for the
    other resamplers.
    `decode_chunk` is how a continuous engine on `device` (with
    `tp_group`, `eager_chunks`) runs its decode chunks:
    `graphs.chunk_route`, "graph" or "eager: <why>"."""
    v, t = cfg.vision, cfg.text
    n = towers.sequence_length(v)  # the tower's own tokens, its class token included
    meta = torch.device("meta")
    q_tower = torch.empty((1, n, v.num_heads, v.head_dim), device=meta)
    q_text = torch.empty((1, prompt_len, t.num_heads, t.head_dim), device=meta)
    k_text = torch.empty((1, prompt_len, t.num_kv_heads, t.head_dim), device=meta)
    tower_flash = flash_eligible(q_tower, q_tower, impl=attn_impl)
    tower = tower_flash and tower_eligible(q_tower, q_tower, None, False, tower_grad)
    text_kw = dict(impl=attn_impl, window=t.sliding_window,
                   alibi=t.alibi_bias_max if t.pos_embedding == "alibi" else 0)
    prefill_ok = flash_eligible(q_text, k_text, **text_kw)
    max_len = cache_length(prompt_len, max_new_tokens)
    int8_cache = cache_format == "int8"
    out: Dict[str, object] = {
        "tower_attention": ("kernel" if tower
                            else "kernel_lse" if tower_flash and tower_grad else "plain"),
        # The perceiver's and the Q-Former's attention are plain einsums, as
        # in the JAX package; the other resamplers attend over nothing.
        "resampler_attention": ("plain" if cfg.resampler.kind in ("perceiver", "qformer")
                                else "none"),
        "prefill_attention": "kernel" if prefill_ok else "plain",
        "train_attention": "kernel_lse" if prefill_ok else "plain",
        "decode_attention": qwen2.cached_attention_route(
            t, max_len, attn_impl, 1, decode_rows > 1, int8_cache),
    }
    if spec_k:
        out["verify_attention"] = qwen2.cached_attention_route(
            t, max_len, attn_impl, spec_k + 1, True, int8_cache)
    if quantized:

        def lm_head(rows: int) -> str:  # a tied int8 embedding is dequantized whole
            return "dequant" if t.tie_word_embeddings else qmm_route(rows, False)

        bits = weight_bits
        tower_rows = fill_rows * tiles * towers.passes_per_tile(v) * n
        out.update(
            tower_matmul=qmm_route(tower_rows, bits=bits),
            prefill_matmul=qmm_route(fill_rows * prompt_len, bits=bits),
            fill_lm_head=lm_head(fill_rows),
            decode_matmul=qmm_route(decode_rows, False, bits=bits),
            decode_lm_head=lm_head(decode_rows),
        )
        if bits == 4 and v.intermediate_size % GROUP:
            out["tower_matmul_int8"] = qmm_route(tower_rows)
        if spec_k:
            out.update(
                verify_matmul=qmm_route(decode_rows * (spec_k + 1), False, bits=bits),
                verify_lm_head=lm_head(decode_rows * (spec_k + 1)),
            )
        out["w8a8_impl"] = w8a8_impl_name() if "w8a8" in out.values() else "off"
    out["decode_chunk"] = chunk_route(torch.device(device), tp_group, eager_chunks)
    out["launches"] = kernels.launch_counts()
    return out


def is_quantized(model: radvlm.RadVLM) -> bool:
    return any(isinstance(m, (QLinear, Q4Linear)) for m in model.modules())


def weight_bits(model: radvlm.RadVLM) -> int:
    """4 for a model whose layers hold `Q4Linear` projections, else 8."""
    return 4 if any(isinstance(m, Q4Linear) for m in model.modules()) else 8
