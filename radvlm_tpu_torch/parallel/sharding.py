"""Parameter / optimizer sharding for training over the mesh (counterpart
of `radvlm_tpu/parallel/sharding.py`: ZeRO-3 + tensor + expert parallelism).

The JAX package gives every parameter a `PartitionSpec` over the (data,
fsdp, tensor, expert) mesh and lets XLA compile the gathers and
reduce-scatters. Here the same rule table (`_RULES`, over the port's
parameter names in torch's layout: a kernel [in, out] of the JAX tree is a
weight [out, in] here, so a spec's dims come in the other order) places each
parameter over the port's `DeviceMesh`, one process per rank:

- `fsdp` is ZeRO-3 of the port's own. The parameters whose spec names
  `fsdp` are flattened into one buffer per unit (a decoder block, a SigLIP
  layer, and the rest of the model by learning-rate group), padded to a
  multiple of the fsdp degree, and each rank keeps its slice: the master
  weights, their gradients and AdamW's state exist only as slices. A block's
  unit is gathered (`all_gather_into_tensor`) when the block runs and
  dropped after it; under remat the backward's recompute gathers it again,
  and the gather's backward reduce-scatters the gradient (`_Gather`). The
  rest of the model is gathered once around the step (`model_scope`).
  Parameters without `fsdp` in their spec (norms, biases, image_newline)
  stay whole on every rank, as the JAX specs replicate them. `data` holds
  replicas (HSDP): gradients all-reduce over it.
- `tensor` is the Megatron layout of `parallel/tp.py` (q/k/v, gate/up
  column-parallel; o, down row-parallel), its collectives differentiable
  (`tp.copy_to` / `tp.reduce_from`). The vision tower, the projector, the
  token embedding and the lm_head stay whole over `tensor` (the JAX rules
  shard the tower's layers, the embedding's vocab and the lm_head's columns
  over it too: ROADMAP Queue 3), and FSDP shards them.
  Over an MoE decoder `tensor` slices the experts' m channels as the JAX
  rules do (gate / up column-wise, down row-wise; the shared expert as a
  dense MLP); the router and the shared expert's gate stay whole.
- `expert` holds each rank's share of the MoE expert tables (dim 0); the
  router and the shared expert stay whole. `qwen2._moe_mlp` computes this
  rank's experts on the tokens it holds and sums the ranks' shares.
- `seq` holds the sequence shards of ring attention (`parallel/ring.py`):
  `batch_shardings` cuts the host batch.
- `stage` holds pipeline stages (`parallel/pp.py`), which compose with
  `data` only (`check_axes`).

`shard_for_training` attaches the mesh to the model and its blocks
(`mesh_of`). A rank's loss is its tokens' summed loss over the GLOBAL token
count (`batch_all_reduce`), so the gradients summed over the batch ranks (data,
fsdp, seq) are those of the one-device step. `GradComm` makes those sums
after the backward and computes the clip's global norm with every element
counted once.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from radvlm_tpu_torch.parallel import tp
from radvlm_tpu_torch.training.optimizer import group_of

Spec = Tuple[Optional[str], ...]

# (path regex, spec over the torch tensor's dims); first match wins; no match:
# replicated. The JAX package's `_RULES`, written for the port's names.
_RULES: List[Tuple[str, Spec]] = [
    # --- Qwen2 decoder ---
    (r"text/embed$", ("tensor", "fsdp")),
    (r"text/layers/\d+/[qkv]/weight$", ("tensor", "fsdp")),
    (r"text/layers/\d+/[qkv]/bias$", ("tensor",)),
    (r"text/layers/\d+/o/weight$", ("fsdp", "tensor")),
    (r"text/layers/\d+/(gate|up)/weight$", ("tensor", "fsdp")),
    (r"text/layers/\d+/down/weight$", ("fsdp", "tensor")),
    # MoE: expert tables [E, in, out] shard over `expert`.
    (r"text/layers/\d+/moe/router/weight$", (None, "fsdp")),
    (r"text/layers/\d+/moe/(gate|up)$", ("expert", "fsdp", "tensor")),
    (r"text/layers/\d+/moe/down$", ("expert", "tensor", "fsdp")),
    (r"text/layers/\d+/moe/shared/(gate|up)/weight$", ("tensor", "fsdp")),
    (r"text/layers/\d+/moe/shared/down/weight$", ("fsdp", "tensor")),
    (r"text/layers/\d+/moe/shared_gate/weight$", (None, "fsdp")),
    (r"text/lm_head/weight$", ("tensor", "fsdp")),
    # --- SigLIP tower ---
    (r"vision_tower/patch_embed/weight$", ("fsdp", None)),
    (r"vision_tower/pos_embed$", (None, "fsdp")),
    (r"vision_tower/layers/\d+/[qkv]/weight$", ("tensor", "fsdp")),
    (r"vision_tower/layers/\d+/[qkv]/bias$", ("tensor",)),
    (r"vision_tower/layers/\d+/o/weight$", ("fsdp", "tensor")),
    (r"vision_tower/layers/\d+/fc1/weight$", ("tensor", "fsdp")),
    (r"vision_tower/layers/\d+/fc1/bias$", ("tensor",)),
    (r"vision_tower/layers/\d+/fc2/weight$", ("fsdp", "tensor")),
    # --- projector ---
    (r"projector/fcs/\d+/weight$", ("fsdp", None)),
    # everything else (norms, small biases, image_newline): replicated
]

# Bare-LLM variant (a Qwen2Decoder's own names, no "text/" prefix).
_LLM_RULES: List[Tuple[str, Spec]] = [
    (re.sub(r"^text/", "", pat), spec) for pat, spec in _RULES if pat.startswith("text/")
]

# Where the port's placement leaves `tensor` out of the rule (ROADMAP Queue 3).
_WHOLE_OVER_TENSOR = re.compile(r"^(text/embed|text/lm_head|vision_tower/|projector/)")

_SEQ_KEYS = ("tokens", "img_src", "labels", "labels_next", "segment_ids", "positions")


def path_str(name: str) -> str:
    """A parameter's dotted name as the rules' slash path."""
    return name.replace(".", "/")


def spec_for(path: str, rules: List[Tuple[str, Spec]]) -> Spec:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return ()


def param_pspecs(model: nn.Module, *, llm_only: bool = False) -> Dict[str, Spec]:
    """{parameter name: spec} of `model` (a RadVLM, or a bare decoder)."""
    rules = _LLM_RULES if llm_only else _RULES
    return {n: spec_for(path_str(n), rules) for n, _ in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter lives in the port: the dim sliced over `tensor`
    or `expert` (None: whole), and whether ZeRO-3 shards it over `fsdp`."""

    tensor_dim: Optional[int]
    expert_dim: Optional[int]
    fsdp: bool


def placement(name: str) -> Placement:
    path = path_str(name)
    spec = spec_for(path, _RULES)
    tdim = spec.index("tensor") if "tensor" in spec else None
    if _WHOLE_OVER_TENSOR.match(path):
        tdim = None
    edim = spec.index("expert") if "expert" in spec else None
    return Placement(tdim, edim, "fsdp" in spec)


# ---------------------------------------------------------------------------
# The mesh's groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshGroups:
    """This rank's view of a training mesh: per axis its process group
    (None where the axis has one rank), its index and the axis size."""

    mesh: Any
    groups: Dict[str, Optional[dist.ProcessGroup]]
    index: Dict[str, int]
    size: Dict[str, int]

    def __deepcopy__(self, memo):
        return self

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    @property
    def batch_ways(self) -> int:
        return self.size["data"] * self.size["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's block of rows: data-major over (data, fsdp), the
        order of the JAX package's P(("data", "fsdp"))."""
        return self.index["data"] * self.size["fsdp"] + self.index["fsdp"]


def mesh_groups(mesh) -> MeshGroups:
    from radvlm_tpu_torch.parallel.mesh import AXES

    groups, index, size = {}, {}, {}
    for ax in AXES:
        n = mesh[ax].size()
        size[ax] = n
        index[ax] = mesh.get_local_rank(ax) if n > 1 else 0
        groups[ax] = mesh.get_group(ax) if n > 1 else None
    check_axes(size)
    return MeshGroups(mesh, groups, index, size)


def check_axes(mesh_shape: Optional[Dict[str, int]]) -> None:
    """Refuse a mesh the port does not run, before any process group
    exists: pipeline stages compose with `data` only (the JAX package's
    `pp._check_mesh` rule and message; -1, an axis that takes the ranks
    left, passes here and is checked again once it has its size)."""
    shape = mesh_shape or {}
    if shape.get("stage", 1) in (1, -1):
        return
    for ax in ("fsdp", "seq", "tensor", "expert"):
        if shape.get(ax, 1) not in (1, -1):
            raise ValueError(
                f"PP v1 composes with `data` only; mesh axis {ax}="
                f"{shape[ax]} unsupported"
            )


def wants_mesh(mesh_shape: Optional[Dict[str, int]]) -> bool:
    """Does a run with this shape go through the mesh code: any axis above
    one, or a process group made already (a world of one counts)?"""
    return dist.is_initialized() or any(
        n not in (1, -1) for n in (mesh_shape or {}).values())


# ---------------------------------------------------------------------------
# The groups the model code reduces over
# ---------------------------------------------------------------------------

BATCH_AXES = ("data", "fsdp", "seq")


def mesh_of(module: nn.Module) -> Optional[MeshGroups]:
    """The training mesh `shard_for_training` attached to a model, a decoder
    block or an MoE block (None: not trained over a mesh). It rides on the
    module, not in a context variable: under remat a block's forward runs
    again inside the backward, on autograd's device thread for CUDA
    tensors, which sees no context variable of the caller's."""
    return module.__dict__.get("_mesh")


def _batch_groups(mg: Optional[MeshGroups]) -> List[dist.ProcessGroup]:
    if mg is None:
        return []
    return [g for g in (mg.group(a) for a in BATCH_AXES) if g is not None]


def batch_all_reduce(t: torch.Tensor, mg: Optional[MeshGroups]) -> torch.Tensor:
    """Sum of `t` over the batch axes (no gradient); `t` outside a mesh."""
    groups = _batch_groups(mg)
    if not groups:
        return t
    t = t.detach().clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def batch_reduce_from(t: torch.Tensor, mg: Optional[MeshGroups]) -> torch.Tensor:
    """Differentiable sum over the batch axes with an identity backward: a
    statistic every rank adds to its loss once (the MoE router's load), whose
    gradient each rank takes through its own tokens only."""
    for g in _batch_groups(mg):
        t = tp.reduce_from(t if tp._differentiable(t) else t.detach().clone(), g)
    return t


def batch_size(mg: Optional[MeshGroups]) -> int:
    """How many batch ranks share the global batch (1 outside a mesh)."""
    return 1 if mg is None else math.prod(mg.size[a] for a in BATCH_AXES)


def global_mean(x: torch.Tensor, mg: Optional[MeshGroups]) -> torch.Tensor:
    """The mean of x over the GLOBAL batch: this rank's sum over the
    all-reduced element count (differentiable in x). Summed over the batch
    ranks, the gradients are those of the one-device mean."""
    if mg is None:
        return x.mean()
    n = batch_all_reduce(torch.tensor(float(x.numel()), device=x.device), mg)
    return x.sum() / n


def batch_mean(x: torch.Tensor, mg: Optional[MeshGroups]) -> torch.Tensor:
    """The mean of x over the GLOBAL batch on every rank (no gradient): a
    metric."""
    return batch_all_reduce(global_mean(x.detach(), mg), mg)


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def row_offsets(counts: torch.Tensor, mg: Optional[MeshGroups]) -> torch.Tensor:
    """counts [k, R, E] of this rank's top-k picks in each of its R rows ->
    [k, R, E], the picks elsewhere that come before a row's in the GShard
    ranking, which a rank's own running count does not see. The ranking
    goes slot by slot, then over the global batch's tokens in order: rows
    data-major over (data, fsdp), and within a row the seq blocks in order,
    so under seq > 1 a row's tokens follow the earlier seq ranks' part of
    the SAME row. Outside a mesh: zeros."""
    if mg is None or (mg.batch_ways == 1 and mg.size["seq"] == 1):
        return torch.zeros_like(counts)
    parts = counts[None]
    for ax in ("seq", "fsdp", "data"):
        g = mg.group(ax)
        if g is None:
            continue
        out = parts.new_empty((mg.size[ax] * parts.shape[0],) + tuple(counts.shape))
        dist.all_gather_into_tensor(out, parts.contiguous(), group=g)
        parts = out
    k, rows, e = counts.shape
    n_seq = mg.size["seq"]
    # Global segments (batch rank, row, seq block) in ranking order.
    segs = parts.view(mg.batch_ways, n_seq, k, rows, e).permute(2, 0, 3, 1, 4)
    seg_before = _exclusive_cumsum(segs.reshape(k, -1, e), 1).view(k, mg.batch_ways, rows,
                                                                   n_seq, e)
    mine = seg_before[:, mg.batch_index, :, mg.index["seq"]]  # [k, R, E]
    slots_before = _exclusive_cumsum(segs.sum((1, 2, 3)), 0)  # [k, E]
    # This rank's own picks are counted locally: its earlier slots, and in
    # slot k its rows before r.
    local_slots = _exclusive_cumsum(counts.sum(1), 0)
    local_rows = _exclusive_cumsum(counts, 1)
    return (slots_before - local_slots)[:, None] + mine - local_rows


# ---------------------------------------------------------------------------
# Host batches
# ---------------------------------------------------------------------------


def batch_shardings(mg: MeshGroups, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's part of a host batch: its block of rows over (data,
    fsdp), and of the [B, L] token arrays its sequence block when seq > 1
    (the batch is zigzag-permuted already, `ring.zigzag_shift_batch`).
    Ranks along `tensor` and `expert` hold the same part."""
    ways, me = mg.batch_ways, mg.batch_index
    n_seq, my_seq = mg.size["seq"], mg.index["seq"]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % ways:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over "
                             f"data x fsdp = {ways} ranks")
        rows = v.shape[0] // ways
        v = v[me * rows:(me + 1) * rows]
        if n_seq > 1 and k in _SEQ_KEYS:
            if v.shape[1] % n_seq:
                raise ValueError(f"{k}: length {v.shape[1]} does not split over seq={n_seq}")
            s = v.shape[1] // n_seq
            v = v[:, my_seq * s:(my_seq + 1) * s]
        out[k] = np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v.contiguous()
    return out


# ---------------------------------------------------------------------------
# Tensor and expert slicing for training
# ---------------------------------------------------------------------------


def _narrow(t: torch.Tensor, dim: int, n: int, rank: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).clone()


def shard_experts(decoder: nn.Module, n: int, rank: int) -> None:
    """Keep this rank's experts (dim 0 of the MoE tables), in place."""
    for blk in decoder.layers:
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        for name in ("gate", "up", "down"):
            t = getattr(moe, name)
            if t.shape[0] % n:
                raise ValueError(f"expert={n} must divide num_experts={t.shape[0]}")
            setattr(moe, name, nn.Parameter(_narrow(t.data, 0, n, rank), requires_grad=False))


def _moe_tensor_cfg(cfg, n: int):
    """An MoE decoder's per-rank config over `tensor`: heads and the
    experts' widths divided by n."""
    for name in ("num_heads", "num_kv_heads", "moe_intermediate_size",
                 "shared_expert_intermediate_size"):
        if getattr(cfg, name) % n:
            raise ValueError(f"tensor={n} must divide {name}={getattr(cfg, name)}")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // n, num_kv_heads=cfg.num_kv_heads // n,
        moe_intermediate_size=cfg.moe_intermediate_size // n,
        shared_expert_intermediate_size=cfg.shared_expert_intermediate_size // n)


def shard_moe_tensor(decoder: nn.Module, n: int, rank: int) -> None:
    """Rank `rank`'s slice over `tensor` of an MoE decoder, in place: the
    attention as `tp.shard_text_tp` slices it, each expert's m channels
    ([E, d, m] gate / up on dim 2, [E, m, d] down on dim 1) and the shared
    expert as a dense MLP; the router and the shared expert's gate stay
    whole."""
    for i, blk in enumerate(decoder.layers):
        for name in ("q", "k", "v", "o"):
            setattr(blk, name, tp._slice_linear(getattr(blk, name), name, n, rank, f"layer {i} "))
        moe = blk.moe
        for name, dim in (("gate", 2), ("up", 2), ("down", 1)):
            setattr(moe, name, nn.Parameter(_narrow(getattr(moe, name).data, dim, n, rank),
                                            requires_grad=False))
        if moe.shared is not None:
            for name in ("gate", "up", "down"):
                setattr(moe.shared, name, tp._slice_linear(getattr(moe.shared, name), name, n,
                                                           rank, f"layer {i} shared "))


def shard_for_training(model: nn.Module, cfg, mg: MeshGroups):
    """Slice an unfused f32 RadVLM for this rank's place on `tensor` and
    `expert`, in place (before `mark_trainable`); returns the rank's config
    (the decoder's heads and ffn width divided by the tp degree)."""
    tp_n, ep_n = mg.size["tensor"], mg.size["expert"]
    if tp_n > 1 and cfg.text.num_experts:
        cfg = dataclasses.replace(cfg, text=_moe_tensor_cfg(cfg.text, tp_n))
        shard_moe_tensor(model.text, tp_n, mg.index["tensor"])
    elif tp_n > 1:
        local = tp.local_text_cfg(cfg.text, tp_n)
        tp.shard_text_tp(model.text, tp_n, mg.index["tensor"])
        cfg = dataclasses.replace(cfg, text=local)
    if ep_n > 1:
        if not cfg.text.num_experts:
            raise ValueError("mesh axis expert > 1 needs an MoE decoder")
        shard_experts(model.text, ep_n, mg.index["expert"])
    model.__dict__["_mesh"] = mg
    for blk in model.text.layers:
        blk.__dict__["_mesh"] = mg
        if hasattr(blk, "moe"):
            blk.moe.__dict__["_mesh"] = mg
    return cfg


# ---------------------------------------------------------------------------
# ZeRO-3 units
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """A unit's full flat buffer from the ranks' slices; the backward
    reduce-scatters (sums) the full gradient back into this rank's slice."""

    @staticmethod
    def forward(ctx, shard, group, world):
        ctx.group, ctx.world = group, world
        out = shard.new_empty(shard.numel() * world)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(g.numel() // ctx.world)
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


@dataclasses.dataclass
class _Entry:
    module: nn.Module
    attr: str
    name: str  # the parameter's name in the whole model
    shape: Tuple[int, ...]
    offset: int


class Unit:
    """One flat buffer of parameters, this rank's slice kept as `shard`
    (a leaf tensor, the optimizer's parameter where it trains)."""

    def __init__(self, key: str, entries: List[_Entry], params: List[torch.Tensor],
                 group: Optional[dist.ProcessGroup], world: int, rank: int, kind: str,
                 label: str):
        self.key, self.entries, self.kind, self.label = key, entries, kind, label
        self.group, self.world = group, world
        total = sum(p.numel() for p in params)
        chunk = -(-total // world)
        flat = torch.zeros(chunk * world, dtype=params[0].dtype, device=params[0].device)
        flat[:total] = torch.cat([p.detach().reshape(-1) for p in params])
        self.numel = total
        self.shard = flat[rank * chunk:(rank + 1) * chunk].clone()
        self.shard.requires_grad_(params[0].requires_grad)
        self._placeholder = flat.new_empty(0)
        self.release()

    def __deepcopy__(self, memo):
        new = copy.copy(self)
        memo[id(self)] = new
        new.entries = [dataclasses.replace(e, module=copy.deepcopy(e.module, memo))
                       for e in self.entries]
        new.shard = self.shard.detach().clone()
        new._placeholder = self._placeholder.clone()
        return new

    def full(self) -> torch.Tensor:
        """The whole flat buffer (differentiable into `shard` where it trains)."""
        if self.world == 1:
            return self.shard
        if torch.is_grad_enabled() and self.shard.requires_grad:
            return _Gather.apply(self.shard, self.group, self.world)
        out = self.shard.new_empty(self.shard.numel() * self.world)
        dist.all_gather_into_tensor(out, self.shard.detach().contiguous(), group=self.group)
        return out

    def materialize(self) -> None:
        flat = self.full()
        for e in self.entries:
            n = math.prod(e.shape)
            object.__setattr__(e.module, e.attr, flat[e.offset:e.offset + n].view(e.shape))

    def release(self) -> None:
        for e in self.entries:
            object.__setattr__(e.module, e.attr, self._placeholder)

    def tensors(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, whole tensor) of every entry (a gather without a gradient)."""
        with torch.no_grad():
            flat = self.full()
        for e in self.entries:
            n = math.prod(e.shape)
            yield e.name, flat[e.offset:e.offset + n].view(e.shape)


@contextlib.contextmanager
def unit_scope(module: nn.Module):
    """The module's units gathered for the block inside (a no-op for a module
    without units: every unsharded forward)."""
    units = module.__dict__.get("_zero_units")
    if not units:
        yield
        return
    for u in units:
        u.materialize()
    try:
        yield
    finally:
        for u in units:
            u.release()


@contextlib.contextmanager
def model_scope(model: nn.Module):
    """The units outside the blocks (embedding, lm_head, projector, the
    tower's stem), gathered around a whole step: the chunked loss's
    recompute reads the lm_head in the backward."""
    with unit_scope(model):
        yield


@dataclasses.dataclass
class ShardedModel:
    """What `shard_model` did to a model: its units, its whole parameters
    and their placements, and the mesh."""

    mg: MeshGroups
    units: List[Unit]
    whole: Dict[str, torch.Tensor]  # parameters every fsdp rank holds whole
    placements: Dict[str, Placement]

    def __deepcopy__(self, memo):
        new = copy.copy(self)
        memo[id(self)] = new
        new.units = copy.deepcopy(self.units, memo)
        new.whole = {}  # filled by `frozen_copy` from the copied model
        return new

    def trainable(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
        """The optimizer's parameters and their learning-rate groups."""
        params, labels = {}, {}
        for u in self.units:
            if u.shard.requires_grad:
                params[u.key], labels[u.key] = u.shard, u.label
        for n, p in self.whole.items():
            if p.requires_grad:
                params[n], labels[n] = p, group_of(n)
        return params, labels


# A kind names the axes over which a tensor's elements are split beyond
# fsdp; "summed" is a whole tensor whose gradient is partial on each tensor
# rank (a LoRA adapter of a sliced projection).
_KIND_AXES = {"whole": (), "summed": (), "tensor": ("tensor",), "expert": ("expert",),
              "tensor+expert": ("tensor", "expert")}


def sliced_dims(pl: Placement, mg: MeshGroups) -> Tuple[Optional[int], Optional[int]]:
    """(dim sliced over tensor, dim sliced over expert) of a parameter on
    this mesh; None where that axis has one rank or leaves it whole."""
    return tuple(dim if dim is not None and mg.size[ax] > 1 else None
                 for ax, dim in (("tensor", pl.tensor_dim), ("expert", pl.expert_dim)))


def _kind(pl: Placement, mg: MeshGroups) -> str:
    tdim, edim = sliced_dims(pl, mg)
    axes = [ax for ax, dim in (("tensor", tdim), ("expert", edim)) if dim is not None]
    return "+".join(axes) or "whole"


def _scope_of(name: str, layer_tower: bool) -> str:
    m = re.match(r"^(text\.layers\.\d+)\.", name)
    if m:
        return m.group(1)
    m = re.match(r"^(vision_tower\.layers\.\d+)\.", name)
    if m and layer_tower:
        return m.group(1)
    return ""


def shard_model(model: nn.Module, mg: MeshGroups, *, layer_tower: bool = True) -> ShardedModel:
    """ZeRO-3 over `fsdp`: every parameter whose placement names fsdp leaves
    the module for its unit (the module attribute holds an empty tensor
    between uses). Units: each decoder block (gathered in `qwen2._block`),
    each SigLIP layer with `layer_tower` (in `SigLIPLayer.forward`), and the
    rest of the model (`model_scope`),
    one buffer per (learning-rate group, dtype, trainable, kind); `kind`
    says how the elements split beyond fsdp (whole, tensor, expert).
    Call after the tensor / expert slicing and after `mark_trainable`."""
    fsdp_group, world, rank = mg.group("fsdp"), mg.size["fsdp"], mg.index["fsdp"]
    modules = dict(model.named_modules())
    placements, whole = {}, {}
    buckets: Dict[Tuple, List[Tuple[str, nn.Module, str, torch.Tensor]]] = {}
    for name, p in list(model.named_parameters()):
        pl = placement(name)
        placements[name] = pl
        if not pl.fsdp:
            whole[name] = p
            continue
        mod_name, _, attr = name.rpartition(".")
        scope = _scope_of(name, layer_tower)
        key = (scope, group_of(name), str(p.dtype).replace("torch.", ""),
               "train" if p.requires_grad else "frozen", _kind(pl, mg))
        buckets.setdefault(key, []).append((name, modules[mod_name], attr, p))
    units = []
    for key, items in buckets.items():
        entries, params, off = [], [], 0
        for name, mod, attr, p in items:
            entries.append(_Entry(mod, attr, name, tuple(p.shape), off))
            params.append(p)
            off += p.numel()
            del mod._parameters[attr]
        scope, label, _, _, kind = key
        unit = Unit("|".join(key), entries, params, fsdp_group, world, rank, kind, label)
        units.append(unit)
        modules[scope].__dict__.setdefault("_zero_units", []).append(unit)
    sm = ShardedModel(mg, units, whole, placements)
    model.__dict__["_zero"] = sm
    return sm


def sharded(model: nn.Module) -> Optional[ShardedModel]:
    return model.__dict__.get("_zero")


def frozen_copy(model: nn.Module) -> nn.Module:
    """A copy with storage of its own and no gradient (the DPO / GRPO
    reference); a sharded model's units are copied slice by slice."""
    ref = copy.deepcopy(model)
    for p in ref.parameters():
        p.requires_grad_(False)
        p.grad = None
    sm = sharded(ref)
    if sm is not None:
        sm.whole = dict(ref.named_parameters())
    return ref


def full_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: whole tensor} of every parameter, gathered over fsdp, and over
    tensor / expert where the parameter is sliced there (a one-device copy,
    e.g. GRPO's rollout engine). An unsharded model's own parameters."""
    sm = sharded(model)
    if sm is None:
        return {n: p.detach() for n, p in model.named_parameters()}
    out = {n: p.detach() for n, p in sm.whole.items()}
    for u in sm.units:
        for n, t in u.tensors():
            out[n] = t.clone()
    mg = sm.mg
    for n in sorted(out):
        pl = sm.placements[n]
        for ax, dim in (("tensor", pl.tensor_dim), ("expert", pl.expert_dim)):
            g = mg.group(ax)
            if g is None or dim is None:
                continue
            parts = [torch.empty_like(out[n]) for _ in range(mg.size[ax])]
            dist.all_gather(parts, out[n].contiguous(), group=g)
            out[n] = torch.cat(parts, dim=dim)
    return out


# ---------------------------------------------------------------------------
# Gradient sums and the global norm
# ---------------------------------------------------------------------------


def _all_reduce_flat(tensors: List[torch.Tensor], groups) -> None:
    """Sum every tensor over each group, one flat buffer per dtype."""
    groups = [g for g in groups if g is not None]
    if not groups or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        for g in groups:
            dist.all_reduce(flat, group=g)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


class GradComm:
    """The optimizer's collectives under a mesh. `sync` sums the gradients
    over the batch ranks: a unit's slice was reduce-scattered over fsdp by
    its gather already and sums over data and seq; a whole parameter sums
    over data, fsdp and seq, a "summed" one over tensor too. `norm` is the
    global norm with every element once: slices sum over fsdp, tensor- and
    expert-sliced elements over their axes, what ranks hold alike counts
    once."""

    def __init__(self, mg: MeshGroups, kinds: Dict[str, Tuple[bool, str]]):
        self.mg = mg
        self.kinds = kinds  # name -> (is a unit slice, kind)

    def sync(self, names: Sequence[str], grads: List[torch.Tensor]) -> None:
        g = self.mg.group
        sliced = [x for n, x in zip(names, grads) if self.kinds[n][0]]
        whole = [x for n, x in zip(names, grads) if not self.kinds[n][0]]
        summed = [x for n, x in zip(names, grads) if self.kinds[n][1] == "summed"]
        _all_reduce_flat(sliced, [g("data"), g("seq")])
        _all_reduce_flat(whole, [g("data"), g("fsdp"), g("seq")])
        _all_reduce_flat(summed, [g("tensor")])

    def norm(self, names: Sequence[str], grads: List[torch.Tensor]) -> torch.Tensor:
        dev = grads[0].device if grads else torch.device("cpu")
        # parts[kind] = (sum of squares held whole over fsdp, of fsdp slices)
        kinds = list(_KIND_AXES)
        parts = torch.zeros(len(kinds), 2, dtype=torch.float32, device=dev)
        for n, x in zip(names, grads):
            is_slice, kind = self.kinds[n]
            parts[kinds.index(kind), int(is_slice)] += x.float().pow(2).sum()
        g = self.mg.group
        for r, kind in enumerate(kinds):
            for ax in _KIND_AXES[kind]:
                if g(ax) is not None:
                    dist.all_reduce(parts[r], group=g(ax))
        sliced = parts[:, 1].sum()
        if g("fsdp") is not None:
            dist.all_reduce(sliced, group=g("fsdp"))
        return torch.sqrt(sliced + parts[:, 0].sum())


def grad_comm(sm: ShardedModel, extra: Optional[Dict[str, torch.Tensor]] = None) -> GradComm:
    """The `GradComm` of a sharded model's trainable tensors, plus `extra`
    whole ones (LoRA adapters, replicated: under tensor > 1 each rank's
    gradient is its slice's part, and they sum over tensor)."""
    kinds = {}
    for u in sm.units:
        kinds[u.key] = (True, u.kind)
    for n in sm.whole:
        kinds[n] = (False, _kind(sm.placements[n], sm.mg))
    for n in extra or {}:
        kinds[n] = (False, "summed")
    return GradComm(sm.mg, kinds)
