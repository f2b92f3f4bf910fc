"""Pipeline parallelism over the mesh's `stage` axis (counterpart of
`radvlm_tpu/parallel/pp.py`): the GPipe schedule and the interleaved one
(Megatron's virtual stages), for full finetuning and for LoRA / QLoRA.

The decoder's L layers split into S x V chunks of C = L / (S V) layers:
global stage g = v S + s covers layers [g C, (g + 1) C), and rank s of the
`stage` axis holds chunks v = 0 .. V-1 (V = 1: one contiguous block of
L / S layers). The token embedding, the vision tower, the projector, the
final norm and the lm_head stay whole on every rank; the tower and the
splice run on stage 0 only, the lm_head and the cross entropy on the last
stage only. A rank's rows split into M microbatches, and at tick t rank s
works item u = t - s: (round, chunk, slot) = (u // (S V), (u % (S V)) // S,
u % S), microbatch m = round S + slot. After every tick the activations hop
to the next rank (`_hop`); with V > 1 they hop the full ring, so stage S - 1
hands a microbatch back to stage 0 for its next chunk. The bubble is
(S - 1) / (M + S - 1) of a GPipe step and (S - 1) / (M V + S - 1) of an
interleaved one.

Gradients: a rank differentiates its last stage's summed token loss over
the GLOBAL token count, so the ranks' gradients sum to the one-device
step's. A layer's gradient sums over `data`, every other leaf's over `data`
and `stage` (stage 0 adds the tower's and the embedding's, the last stage
the head's), as the JAX psums do, and the global loss is in the metrics.
The optimizer then runs on every rank alike (`StageComm`).

Where the port differs from the JAX design, which is one SPMD program under
`shard_map` (here one process a rank):

- The tick loop is Python, and a rank runs its own work only: through a
  bubble tick it hands its input on untouched instead of computing a
  clipped microbatch nobody reads, and it picks its chunk's layers by
  index instead of `lax.switch`.
- The backward is autograd's through the tick loop. A hop is a
  `torch.autograd.Function` (`_Hop`, modelled on `ring._Rotate`) whose
  backward sends the cotangent the reverse way. Every rank's hops form one
  chain from its first tick to its loss (`_Tie` keeps a hop whose output a
  tick does not read in that chain), so every rank runs the backward's hops
  in the same order, tick by tick, as the matching sends and receives need.
- A rank holds its own decoder layers only; the others are
  `layers.Elsewhere` placeholders, so a held layer keeps its global index
  and name (`text.layers.<g>...`), which the optimizer state and the
  checkpoint use (`training/checkpoint.py` reassembles the whole stacks).
  There is no folded [V, S, C, ...] layout to undo; the tree functions
  below convert the JAX package's folded trees.
- The hop's transport follows the group's backend (`hop_transport`): NCCL
  sends CUDA tensors point to point (`batch_isend_irecv`); gloo sends CPU
  tensors point to point and a CUDA tensor through host memory (a gloo send
  of a CUDA tensor kills the process). Only the transfer goes through the
  host; the stages compute on their device.
- LoRA adapters stay whole on every rank (the [L, ...] stacks of one
  card): a rank's gradient is nonzero in its own layers' rows, and the sum
  over `stage` makes it whole and equal everywhere.
- There is no `put_batch_pp`: a rank's rows are
  `sharding.batch_shardings`' (rows over data; the stage ranks of a data
  replica hold the same rows).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import qwen2, radvlm
from radvlm_tpu_torch.models.layers import Elsewhere
from radvlm_tpu_torch.ops import quant
from radvlm_tpu_torch.parallel import sharding
from radvlm_tpu_torch.training import train_step as ts
from radvlm_tpu_torch.training.lora import (
    Adapters,
    LoraConfig,
    adapter_parameters,
    init_lora,
    merge_lora,
)
from radvlm_tpu_torch.training.optimizer import (
    Optimizer,
    TrainConfig,
    mark_trainable,
    peak_rates,
)

_LAYER_RE = re.compile(r"(^|/)text/layers/")
_LAYER_NAME = re.compile(r"^text\.layers\.\d+\.")


# ---------------------------------------------------------------------------
# The JAX-layout tree ({"text": {"layers": {...}}}, tensors or arrays)
# ---------------------------------------------------------------------------


def _map_tree(fn, tree: Any, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{path}/{k}" if path else k) for k, v in tree.items()}
    return fn(path, tree)


def _first_layer_leaf(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            found = _first_layer_leaf(v, f"{path}/{k}" if path else k)
            if found is not None:
                return found
        return None
    return tree if _LAYER_RE.search(path) else None


def fold_layers_interleaved(params: Any, stages: int, interleave: int) -> Any:
    """Reshape stacked decoder-layer leaves [L, ...] -> [V, S, C, ...]:
    chunk v of stage s (global stage v S + s, layers [(v S + s) C, ...)) at
    [v, s]. Order-preserving (a pure reshape); `unfold_layers_interleaved`
    restores the canonical stack."""
    V, S = interleave, stages

    def fold(path, x):
        if _LAYER_RE.search(path):
            if x.shape[0] % (V * S):
                raise ValueError(
                    f"num_layers={x.shape[0]} not divisible by "
                    f"stage={S} x interleave={V}"
                )
            return x.reshape((V, S, x.shape[0] // (V * S)) + tuple(x.shape[1:]))
        return x

    return _map_tree(fold, params)


def unfold_layers_interleaved(params: Any) -> Any:
    """Inverse of `fold_layers_interleaved`: [V, S, C, ...] -> [L, ...]."""

    def unfold(path, x):
        if _LAYER_RE.search(path):
            return x.reshape((x.shape[0] * x.shape[1] * x.shape[2],) + tuple(x.shape[3:]))
        return x

    return _map_tree(unfold, params)


def canonicalize_layer_stacks(params: Any, num_layers: int) -> Any:
    """Canonical [L, ...] layer stacks of a tree that may come folded
    [V, S, C, ...] (an interleaved run of the JAX package); the tree itself
    where the stacks are canonical."""
    sample = _first_layer_leaf(params)
    if sample is None or sample.shape[0] == num_layers:
        return params
    lead = sample.shape[0] * sample.shape[1] * sample.shape[2] if sample.ndim >= 3 else -1
    if lead != num_layers:
        raise ValueError(
            f"layer stack leading dims {tuple(sample.shape[:3])} do not fold to "
            f"num_layers={num_layers}"
        )
    return unfold_layers_interleaved(params)


# ---------------------------------------------------------------------------
# The mesh and the stages
# ---------------------------------------------------------------------------


def _sizes(mesh) -> Dict[str, int]:
    """Axis sizes of a `DeviceMesh` or {axis: size}."""
    from radvlm_tpu_torch.parallel.mesh import AXES

    if isinstance(mesh, dict):
        return {ax: mesh.get(ax, 1) for ax in AXES}
    return {ax: mesh[ax].size() for ax in AXES}


def _check_mesh(mesh, cfg: RadVLMConfig, *, interleave: int = 1,
                n_microbatches: Optional[int] = None) -> int:
    """The JAX package's checks, with its messages; returns the stages."""
    shape = _sizes(mesh)
    stages = shape.get("stage", 1)
    if stages < 2:
        raise ValueError("PP needs a `stage` mesh axis of size >= 2")
    if n_microbatches is not None and n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
    sharding.check_axes(shape)
    if cfg.text.num_layers % (stages * interleave):
        raise ValueError(
            f"num_layers={cfg.text.num_layers} not divisible by "
            f"stage={stages} x interleave={interleave}"
        )
    if interleave > 1 and n_microbatches is not None and n_microbatches % stages:
        raise ValueError(
            f"interleaved PP needs microbatches divisible by stages: "
            f"M={n_microbatches}, S={stages}"
        )
    if cfg.text.num_experts:
        raise ValueError("PP v1 does not support MoE router aux")
    return stages


def stage_layers(num_layers: int, stages: int, interleave: int, stage: int) -> List[List[int]]:
    """The global layer indices of each chunk v that rank `stage` holds."""
    c = num_layers // (stages * interleave)
    return [[(v * stages + stage) * c + i for i in range(c)] for v in range(interleave)]


def hold_stage(model: radvlm.RadVLM, cfg: RadVLMConfig, mesh, *, interleave: int = 1,
               n_microbatches: Optional[int] = None) -> sharding.MeshGroups:
    """Keep the decoder layers of this rank's stages, in place (the others
    become `Elsewhere`), and attach the mesh and the chunks to the model.
    Returns the rank's `MeshGroups`."""
    _check_mesh(mesh, cfg, interleave=interleave, n_microbatches=n_microbatches)
    mg = sharding.mesh_groups(mesh)
    chunks = stage_layers(cfg.text.num_layers, mg.size["stage"], interleave,
                          mg.index["stage"])
    held = {i for c in chunks for i in c}
    for i in range(len(model.text.layers)):
        if i not in held:
            model.text.layers[i] = Elsewhere()
    model.__dict__["_pp"] = (mg, [[model.text.layers[i] for i in c] for c in chunks])
    return mg


def _stage_of(model: radvlm.RadVLM):
    pp = model.__dict__.get("_pp")
    if pp is None:
        raise ValueError("the model holds no pipeline stage: call pp.hold_stage first")
    return pp


# ---------------------------------------------------------------------------
# The hop
# ---------------------------------------------------------------------------


def hop_transport(group, device) -> str:
    """How a hop over `group` moves an activation on `device`."""
    if dist.get_backend(group) == "nccl":
        return "nccl batch_isend_irecv"
    if torch.device(device).type == "cuda":
        return "gloo send/recv through host memory"
    return "gloo send/recv"


def _shift(group, t: torch.Tensor, step: int, ring: bool) -> torch.Tensor:
    """Send `t` to the rank `step` places on and receive from the rank
    `step` places back (around the ring, or along the line where an end
    sends or receives nothing: zeros)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst, src = me + step, me - step
    if ring:
        dst, src = dst % n, src % n
    t = t.contiguous()
    out = torch.zeros_like(t)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    send = t.cpu() if staged else t
    recv = torch.empty_like(send) if staged else out
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if staged and 0 <= src < n:
        out.copy_(recv)
    return out


class _Hop(torch.autograd.Function):
    """A tick's activation to the next stage, the previous stage's in; the
    backward sends the cotangent to the previous stage and takes the next
    stage's (zeros where no stage is next)."""

    @staticmethod
    def forward(ctx, y, group, ring):
        ctx.group, ctx.ring = group, ring
        return _shift(group, y, 1, ring)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.group, g, -1, ctx.ring), None, None


def _hop(group, y: torch.Tensor, ring: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and y.requires_grad:
        return _Hop.apply(y, group, ring)
    return _shift(group, y, 1, ring)


class _Tie(torch.autograd.Function):
    """x itself, with `other` kept in the backward's graph at a zero
    gradient: a hop whose arrival a tick does not read still runs its
    backward, in its place in the chain."""

    @staticmethod
    def forward(ctx, x, other):
        ctx.other = (other.shape, other.dtype, other.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.other
        return g, torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The loss and the gradients
# ---------------------------------------------------------------------------


def _run_chunk(tcfg, blocks, x, positions, segment_ids, attn_impl: str, remat: bool):
    """A chunk's layers, each rematerialised in the backward with `remat`
    (as `qwen2.forward`)."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x, _, _ = checkpoint(qwen2._block, tcfg, blk, x, positions, segment_ids, attn_impl,
                                 False, use_reentrant=False)
        else:
            x, _, _ = qwen2._block(tcfg, blk, x, positions, segment_ids, attn_impl)
    return x


def make_pp_loss_fn(mesh, cfg: RadVLMConfig, *, n_microbatches: int, remat: bool = True,
                    attn_impl: str = "auto", interleave: int = 1):
    """fn(model, batch, generator=None) -> (loss, metrics) on a model that
    holds its stage (`hold_stage`) and this rank's rows of the batch.
    `loss` is the rank's part: its summed token loss over the GLOBAL token
    count (0 off the last stage), so its gradient is the rank's
    contribution to the global one; metrics hold the global loss and token
    count. `generator` is masked_drop's stream (stage 0 draws)."""
    S = _check_mesh(mesh, cfg, interleave=interleave, n_microbatches=n_microbatches)
    M, V = n_microbatches, interleave
    tcfg = cfg.text

    def loss_fn(model, batch, generator=None):
        mg, chunks = _stage_of(model)
        s, group = mg.index["stage"], mg.group("stage")
        b, length = batch["tokens"].shape
        if b % M:
            raise ValueError(f"per-shard batch {b} not divisible by M={M}")
        mb = b // M
        dtype = model.text.norm.dtype
        # The chain's start: every tick's input descends from it, so a rank
        # whose first ticks idle still has hops in the backward's graph.
        start = torch.zeros((), dtype=dtype, device=model.device,
                            requires_grad=torch.is_grad_enabled())
        inbuf = start.expand(mb, length, tcfg.hidden_size)
        micro_e = None
        if s == 0:
            micro_e = radvlm.input_embeds(model, cfg, batch, attn_impl=attn_impl, remat=remat,
                                          resampler_generator=generator).to(dtype).split(mb)
        pos, seg, lab = (batch[k].split(mb) for k in ("positions", "segment_ids", "labels"))
        outbuf: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M * V + S - 1):
            u = t - s
            if 0 <= u < M * V:
                rnd, rem = divmod(u, S * V)
                v, m = rem // S, rnd * S + rem % S
                x = _Tie.apply(micro_e[m], inbuf) if s == 0 and v == 0 else inbuf
                y = _run_chunk(tcfg, chunks[v], x, pos[m], seg[m], attn_impl, remat).to(dtype)
                if s == S - 1 and v == V - 1:
                    outbuf[m] = y
            else:
                y = inbuf  # a bubble tick: nobody reads what it hands on
            inbuf = _hop(group, y, V > 1)

        tot = torch.zeros((), dtype=torch.float32, device=model.device)
        if s == S - 1:
            for hid, lb, sg in zip(outbuf, lab, seg):
                hidden = qwen2._norm(tcfg, hid, model.text.norm)[:, :-1]
                safe, mask = radvlm._shifted({"labels": lb, "segment_ids": sg})
                tot = tot + radvlm._chunked_ce(model, cfg, hidden, safe, mask)
        _, mask = radvlm._shifted(batch)
        count = sharding.batch_all_reduce(mask.sum().float(), mg)
        denom = count.clamp_min(1.0)
        reported = tot.detach().clone()
        for g in (mg.group("data"), group):
            if g is not None:
                dist.all_reduce(reported, group=g)
        loss = _Tie.apply(tot / denom, inbuf)  # the last hop's arrival too
        return loss, {"loss": reported / denom, "tokens": count}

    return loss_fn


class StageComm:
    """The optimizer's collectives under PP: a held layer's gradient sums
    over `data`, every other trainable tensor's over `data` and `stage`
    (whole and equal on every rank after); the global norm counts each held
    layer on its stage and the rest once. With no layers named (LoRA
    adapters: whole [L, ...] stacks) everything sums over both axes."""

    def __init__(self, mg: sharding.MeshGroups, layers: Sequence[str] = ()):
        self.mg = mg
        self.layers = set(layers)

    def sync(self, names: Sequence[str], grads: List[torch.Tensor]) -> None:
        g = self.mg.group
        own = [x for n, x in zip(names, grads) if n in self.layers]
        rest = [x for n, x in zip(names, grads) if n not in self.layers]
        sharding._all_reduce_flat(own, [g("data")])
        sharding._all_reduce_flat(rest, [g("data"), g("stage")])

    def norm(self, names: Sequence[str], grads: List[torch.Tensor]) -> torch.Tensor:
        dev = grads[0].device if grads else torch.device("cpu")
        parts = torch.zeros(2, dtype=torch.float32, device=dev)  # (rest, held layers)
        for n, x in zip(names, grads):
            parts[int(n in self.layers)] += x.float().pow(2).sum()
        if self.mg.group("stage") is not None:
            dist.all_reduce(parts[1:], group=self.mg.group("stage"))
        return torch.sqrt(parts.sum())


def _trainable(model: radvlm.RadVLM) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def make_pp_grad_fn(mesh, cfg: RadVLMConfig, *, n_microbatches: int, remat: bool = True,
                    attn_impl: str = "auto", interleave: int = 1):
    """fn(model, batch, generator=None) -> (grads, metrics): the summed
    gradients {parameter name: tensor} of this rank's trainable parameters
    (its held layers and the whole leaves), as the JAX `shard_map`'d
    fn(params, batch, rng) gives them on the rank's devices."""
    loss_fn = make_pp_loss_fn(mesh, cfg, n_microbatches=n_microbatches, remat=remat,
                              attn_impl=attn_impl, interleave=interleave)

    def grad_fn(model, batch, generator=None):
        mg, _ = _stage_of(model)
        params = _trainable(model)
        loss, metrics = loss_fn(model, batch, generator)
        loss.backward()
        names = list(params)
        grads = [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])
                 for n in names]
        for p in params.values():
            p.grad = None
        StageComm(mg, [n for n in names if _LAYER_NAME.match(n)]).sync(names, grads)
        return dict(zip(names, grads)), metrics

    return grad_fn


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PPStepConfig:
    n_microbatches: int = 4
    remat: bool = True
    attn_impl: str = "auto"
    # Megatron-style virtual stages: V layer chunks per rank, bubble / V.
    # Needs num_layers % (stages * V) == 0 and n_microbatches % stages == 0.
    interleave: int = 1


def setup_pp_training(mesh, model_cfg: RadVLMConfig, train_cfg: TrainConfig,
                      model: radvlm.RadVLM, *, pp_cfg: Optional[PPStepConfig] = None):
    """PP setup mirroring `train_step.setup_training`: `model` (whole, f32
    masters, unfused) keeps this rank's layers (`hold_stage`), freezes by
    `mm_tunable_parts`, and gets an optimizer over its trainable tensors
    with `StageComm`. Returns (state, step_fn, optimizer);
    step_fn(state, batch) -> (state, metrics), in place."""
    pp_cfg = pp_cfg or PPStepConfig()
    mg = hold_stage(model, model_cfg, mesh, interleave=pp_cfg.interleave,
                    n_microbatches=pp_cfg.n_microbatches)
    labels = mark_trainable(model, train_cfg)
    params = {n: p for n, p in model.named_parameters() if n in labels}
    comm = StageComm(mg, [n for n in params if _LAYER_NAME.match(n)])
    opt = Optimizer(params, labels, peak_rates(train_cfg), train_cfg, comm=comm)
    loss_fn = make_pp_loss_fn(mesh, model_cfg, n_microbatches=pp_cfg.n_microbatches,
                              remat=pp_cfg.remat, attn_impl=pp_cfg.attn_impl,
                              interleave=pp_cfg.interleave)

    def step_fn(state: ts.TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        gen = ts.resampler_generator(model_cfg, state.step, model.device)
        with ts._autocast(model.device):
            loss, metrics = loss_fn(model, batch, gen)
        loss.backward()
        metrics = dict(metrics)
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    state = ts.TrainState(step=0, params=model, opt_state=opt, mesh=mg, cfg=model_cfg)
    return state, step_fn, opt


def make_pp_lora_grad_fn(mesh, cfg: RadVLMConfig, lora_cfg: LoraConfig, *, n_microbatches: int,
                         remat: bool = True, attn_impl: str = "auto", interleave: int = 1):
    """fn(adapters, base, batch, generator=None) -> (adapter grads,
    metrics): LoRA / QLoRA over the pipeline, the adapters attached to the
    base's held layers (`merge_lora`), the loss under
    `quant.training_mode` (an int8 base matmuls through the differentiable
    dequantize route), the gradients {`<path>/a|b`: tensor} whole and equal
    on every rank."""
    loss_fn = make_pp_loss_fn(mesh, cfg, n_microbatches=n_microbatches, remat=remat,
                              attn_impl=attn_impl, interleave=interleave)

    def grad_fn(adapters: Adapters, base: radvlm.RadVLM, batch, generator=None):
        mg, _ = _stage_of(base)
        merge_lora(base, adapters, lora_cfg)
        with quant.training_mode():
            loss, metrics = loss_fn(base, batch, generator)
            loss.backward()
        params = adapter_parameters(adapters)
        names = list(params)
        grads = [params[n].grad if params[n].grad is not None else torch.zeros_like(params[n])
                 for n in names]
        for p in params.values():
            p.grad = None
        StageComm(mg).sync(names, grads)
        return dict(zip(names, grads)), metrics

    return grad_fn


def setup_pp_lora_training(mesh, model_cfg: RadVLMConfig, train_cfg: TrainConfig,
                           lora_cfg: LoraConfig, base_model: radvlm.RadVLM, *, seed: int = 0,
                           pp_cfg: Optional[PPStepConfig] = None,
                           adapters: Optional[Adapters] = None):
    """PP x LoRA setup mirroring `train_step.setup_lora_training`: the
    frozen base (dense or int8, QLoRA) keeps this rank's layers, the
    adapters (`init_lora` from a generator seeded with `seed`, unless
    given) stay whole, AdamW over the adapters only. Returns (state, base,
    step_fn); step_fn(state, base, batch)."""
    pp_cfg = pp_cfg or PPStepConfig()
    for p in base_model.parameters():
        p.requires_grad_(False)
    mg = hold_stage(base_model, model_cfg, mesh, interleave=pp_cfg.interleave,
                    n_microbatches=pp_cfg.n_microbatches)
    if adapters is None:
        gen = torch.Generator(device=base_model.device).manual_seed(seed)
        adapters = init_lora(base_model, lora_cfg, gen)
    params = adapter_parameters(adapters)
    opt = Optimizer(params, dict.fromkeys(params, "adapters"),
                    {"adapters": train_cfg.learning_rate}, train_cfg, comm=StageComm(mg))
    merge_lora(base_model, adapters, lora_cfg)
    loss_fn = make_pp_loss_fn(mesh, model_cfg, n_microbatches=pp_cfg.n_microbatches,
                              remat=pp_cfg.remat, attn_impl=pp_cfg.attn_impl,
                              interleave=pp_cfg.interleave)

    def step_fn(state: ts.TrainState, base: radvlm.RadVLM, batch: Dict[str, torch.Tensor]):
        merge_lora(base, state.params, lora_cfg)
        gen = ts.resampler_generator(model_cfg, state.step, base.device)
        with quant.training_mode():
            with ts._autocast(base.device):
                loss, metrics = loss_fn(base, batch, gen)
            loss.backward()
        metrics = dict(metrics)
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    state = ts.TrainState(step=0, params=adapters, opt_state=opt, mesh=mg, cfg=model_cfg)
    return state, base_model, step_fn
