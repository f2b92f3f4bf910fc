"""Tensor-parallel serving (counterpart of `radvlm_tpu/parallel/tp.py`):
the Megatron layout, one process per rank.

The JAX package runs the continuous engine's fill and decode graphs under
`shard_map` over a `tensor` mesh axis; one `shard_map` body is one rank's
program, so here every rank of the `tensor` group runs the identical engine
loop (same arguments, same requests, same host decisions) over its shard:

- attn q/k/v and mlp gate/up: column-parallel (output rows sliced: heads and
  ffn channels), with their biases and per-output-channel int8 scales;
- attn o and mlp down: row-parallel (input columns sliced). Their products
  are partial sums, reduced by ONE all_reduce per site (`maybe_all_reduce`,
  called from `qwen2._finish_block`), so activations are replicated at block
  boundaries and sharded by heads inside. W8A8 on a row-parallel layer
  quantizes the rank's LOCAL K slice, as the JAX body does;
- embeddings, lm_head, norms, vision tower, projector: replicated. The
  hidden state is bit-identical on every rank after each all_reduce, so
  every rank computes the same logits and, greedy or with one seeded
  generator per rank, picks the same token: decoding needs no collective
  beyond the two all_reduces per layer, and no rank broadcasts a token;
- KV cache: kv heads are sharded, so each rank allocates its cache at the
  local kv-head count (k/v [L, B, S, Hkv_local * D]; the int8 cache's
  scales [L, B, Hkv_local, S]). Decode attention is independent per head, so the kernels run
  unchanged at the local shapes.

The model code reads every shape from its config and the parameters, so a
rank runs the ordinary forward with `local_text_cfg` (heads, kv heads and
intermediate size divided by the tp degree).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from radvlm_tpu_torch.config import Qwen2Config
from radvlm_tpu_torch.models.layers import Linear, Q4Linear, QLinear

# A ContextVar, not a module global: the serving fleet (serve/fleet.py) runs
# engines on threads of their own beside other work, and a global set on one
# thread would turn on all_reduces in every other thread's forward.
_TP_GROUP: "contextvars.ContextVar[Optional[dist.ProcessGroup]]" = contextvars.ContextVar(
    "radvlm_tp_group", default=None)

COLUMN = ("q", "k", "v", "gate", "up")
ROW = ("o", "down")


def context() -> Optional[dist.ProcessGroup]:
    return _TP_GROUP.get()


@contextlib.contextmanager
def active(group: Optional[dist.ProcessGroup]):
    """Turn on the row-parallel all_reduces for model code run inside this
    block (None: a no-op block)."""
    token = _TP_GROUP.set(group)
    try:
        yield
    finally:
        _TP_GROUP.reset(token)


def maybe_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel product's partials over the tp group under
    `active` (in place); the identity outside it."""
    group = _TP_GROUP.get()
    if group is None:
        return x
    dist.all_reduce(x, group=group)
    return x


def local_text_cfg(cfg: Qwen2Config, tp: int) -> Qwen2Config:
    """Per-rank decoder config: heads and ffn width divided by the tp degree."""
    if tp == 1:
        return cfg
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads}, "
            f"num_kv_heads={cfg.num_kv_heads}, "
            f"intermediate_size={cfg.intermediate_size}"
        )
    if cfg.num_experts:
        raise NotImplementedError(
            "tensor-parallel serving of MoE models is not wired (use the "
            "expert axis for MoE)"
        )
    if cfg.pos_embedding == "alibi":
        # ALiBi slopes are a function of the GLOBAL head index: a per-rank
        # config would give every rank the slopes of heads 0..H/tp-1.
        raise NotImplementedError(
            "tensor-parallel serving of ALiBi (MPT) models is not wired: "
            "per-head slopes depend on global head indices"
        )
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
    )


def _part(t: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous().clone()


def _slice_linear(lin: nn.Module, name: str, tp: int, rank: int, where: str = "") -> nn.Module:
    """Rank `rank`'s part of a projection: output rows (weight, scale, bias)
    for a column-parallel one, input columns of the weight for a row-parallel
    one (its per-output-channel scale is replicated)."""
    if isinstance(lin, Q4Linear):
        raise NotImplementedError(
            "int4-packed kernels are not TP-shardable (nibble packing spans "
            "the sharded dim); use int8 or bf16 under TP")
    if getattr(lin, "lora", None) is not None:
        raise ValueError(f"{where}{name}: merge or detach LoRA adapters before sharding")
    col = name in COLUMN
    w = _part(lin.weight.data, 0 if col else 1, tp, rank)
    bias = lin.bias.data if lin.bias is not None else None
    if bias is not None and col:
        bias = _part(bias, 0, tp, rank)
    if isinstance(lin, QLinear):
        scale = _part(lin.scale.data, 0, tp, rank) if col else lin.scale.data
        return QLinear(w, scale, bias)
    return Linear(w, bias)


def shard_text_tp(decoder: nn.Module, tp: int, rank: int) -> nn.Module:
    """Slice an UNFUSED decoder's layers to rank `rank` of `tp`, in place.
    A fused tree (qkv / gateup) raises: fusion concatenates along the very
    dim being sharded, so a slice of it would mix q, k and v."""
    if tp == 1:
        return decoder
    for i, blk in enumerate(decoder.layers):
        if hasattr(blk, "qkv") or hasattr(blk, "gateup"):
            raise ValueError(
                "tensor-parallel sharding requires unfused params (q/k/v "
                "separate); skip fuse_for_inference under TP")
        if hasattr(blk, "moe"):
            raise NotImplementedError("TP over MoE layers is not wired")
        for name in COLUMN + ROW:
            if hasattr(blk, name):
                setattr(blk, name, _slice_linear(getattr(blk, name), name, tp, rank, f"layer {i} "))
    return decoder


def shard_model_tp(model: nn.Module, cfg, mesh, axis: str = "tensor"):
    """Shard a RadVLM (or a bare decoder, `cfg` a Qwen2Config) for this
    rank's place on `mesh[axis]`, in place; returns (model, local cfg).
    `cfg` is the global config.

    The rank-local layers are fused after slicing (q|k|v and gate|up of the
    local heads and channels): fused before slicing, the shards would
    interleave wrongly. The decoder remembers its shard
    (`tp_shard`), so a second call for the same place only returns the
    local config (an evaluation builds one engine per task on one model)."""
    from radvlm_tpu_torch.models import qwen2

    tp, rank = mesh[axis].size(), mesh.get_local_rank(axis)
    text_cfg = cfg.text if hasattr(cfg, "text") else cfg
    local = local_text_cfg(text_cfg, tp)
    local_cfg = dataclasses.replace(cfg, text=local) if hasattr(cfg, "text") else local
    decoder = model.text if hasattr(model, "text") else model
    done = getattr(decoder, "tp_shard", None)
    if done is not None:
        if done != (tp, rank):
            raise ValueError(f"the model is sharded as rank {done[1]} of {done[0]}, "
                             f"not rank {rank} of {tp}")
        return model, local_cfg
    shard_text_tp(decoder, tp, rank)
    decoder.tp_shard = (tp, rank)
    qwen2.fuse_projections(decoder)
    return model, local_cfg
