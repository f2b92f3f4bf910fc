"""The SFT and LoRA train steps (counterpart of
`radvlm_tpu/training/train_step.py`), on one card or over a mesh.

With `mesh=` (a `DeviceMesh` of `parallel.mesh.make_mesh`) the setup slices
the model for this rank's place on `tensor` and `expert`, freezes by the
tunable parts and shards it ZeRO-3 over `fsdp` (`parallel/sharding.py`);
the optimizer runs AdamW on this rank's slices, its clip on the global norm.
The LoRA base is sharded by the same rules and the adapters stay whole on
every rank, as in the JAX package: under tensor > 1 a sliced projection
applies the matching slice of its adapter (`layers.lora_factors`), and the
ranks' adapter gradients sum over `tensor` too. Every rank runs the same
step on its part of the batch (`sharding.batch_shardings`). Pipeline
stages are `parallel/pp.py`'s. Donation has no counterpart: a step updates
in place.

Compute type. Parameters are f32 master weights, as in the JAX trainer. On
the card the forward runs under `torch.autocast(bfloat16)`: matmuls take
bf16 operands (the TPU multiplies the f32 parameters at its default bf16
precision too), norms, rope and the loss's log_softmax compute in f32, and
the attention kernels (K2 with the lse, K7, K8) get bf16 q / k / v. On the
CPU everything stays f32, which is what the parity tests compare.

A step updates the state IN PLACE (parameters, optimizer state, step) and
returns the same object. `metrics["grad_norm"]` is the global norm of the
micro-step's gradients over the TRAINABLE parameters: the JAX package's
covers frozen leaves too, which have no gradient here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import radvlm
from radvlm_tpu_torch.ops import quant
from radvlm_tpu_torch.parallel import sharding
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
    make_optimizer,
    mark_trainable,
)


@dataclasses.dataclass
class TrainState:
    step: int  # micro-steps taken
    params: Any  # the RadVLM module (SFT) or the adapter dictionary (LoRA)
    opt_state: Optimizer
    mesh: Optional[sharding.MeshGroups] = None  # this rank's mesh, None on one card
    # The whole model's config under a mesh: what a checkpoint's reader
    # rebuilds the model from (`checkpoint.read_params`).
    cfg: Optional[RadVLMConfig] = None


def _autocast(device: torch.device):
    if device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def resampler_generator(cfg: RadVLMConfig, step: int,
                        device: torch.device) -> Optional[torch.Generator]:
    """masked_drop's stream for micro-step `step`: a generator on `device`
    seeded with the step, so the stream is deterministic and resumes with
    the step count (the counterpart of `fold_in(key(0), step)`); None for
    every other resampler."""
    if cfg.resampler.kind != "masked_drop":
        return None
    return torch.Generator(device=device).manual_seed(int(step))


def make_train_step(cfg: RadVLMConfig, opt: Optimizer, *, remat: bool = True,
                    attn_impl: str = "auto") -> StepFn:
    """step_fn(state, batch) -> (state, metrics): loss and gradients of
    `radvlm.loss_fn`, then one optimizer micro-step. Batch tensors are on
    the model's device (`eval.harness.batch_to_device`). Metrics: loss,
    tokens, grad_norm (tensors). A masked_drop resampler drops from
    `resampler_generator(cfg, state.step, ...)`, as the JAX step folds the
    step into its key (the LoRA step, as the JAX one, draws nothing)."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        with sharding.model_scope(model):
            with _autocast(model.device):
                loss, metrics = radvlm.loss_fn(
                    model, cfg, batch, remat=remat, attn_impl=attn_impl,
                    resampler_generator=resampler_generator(cfg, state.step, model.device))
            loss.backward()
        metrics = dict(metrics)
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    return step_fn


def make_lora_train_step(cfg: RadVLMConfig, lora_cfg: LoraConfig, opt: Optimizer, *,
                         remat: bool = True, attn_impl: str = "auto") -> StepFn:
    """step_fn(state, base_model, batch): state.params are the ADAPTERS, the
    frozen base rides beside them. Runs under `quant.training_mode`, forward
    and backward (rematerialised layers run forward again in the backward):
    a quantized base must matmul through the differentiable dequantize
    route, or backprop through it would silently stop."""

    def step_fn(state: TrainState, base_model: radvlm.RadVLM, batch: Dict[str, torch.Tensor]):
        merge_lora(base_model, state.params, lora_cfg)
        with quant.training_mode(), sharding.model_scope(base_model):
            with _autocast(base_model.device):
                loss, metrics = radvlm.loss_fn(base_model, cfg, batch, remat=remat,
                                               attn_impl=attn_impl)
            loss.backward()
        metrics = dict(metrics)
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    return step_fn


def shard_model(model_cfg: RadVLMConfig, train_cfg: Optional[TrainConfig], model: radvlm.RadVLM,
                mesh) -> Tuple[RadVLMConfig, sharding.MeshGroups]:
    """This rank's part of `model` over `mesh`, in place: the tensor /
    expert slices, the freeze by `train_cfg`'s tunable parts (None: freeze
    everything, a LoRA base) and the ZeRO-3 units. Returns the rank's
    config and its `MeshGroups`."""
    from radvlm_tpu_torch.models import towers

    mg = sharding.mesh_groups(mesh)
    if mg.size["stage"] > 1:
        raise ValueError("a mesh with stage > 1 trains through parallel/pp.py "
                         "(setup_pp_training, setup_pp_lora_training)")
    cfg = sharding.shard_for_training(model, model_cfg, mg)
    if train_cfg is None:
        model.requires_grad_(False)
    else:
        mark_trainable(model, train_cfg)
    sharding.shard_model(model, mg, layer_tower=towers.kind(model_cfg.vision) == "siglip")
    return cfg, mg


def setup_training(model_cfg: RadVLMConfig, train_cfg: TrainConfig, model: radvlm.RadVLM, *,
                   remat: bool = True, attn_impl: str = "auto", mesh=None):
    """One-call setup of full finetuning: freezes by `mm_tunable_parts`,
    builds the optimizer and the step. `model` holds f32 master weights,
    unfused. With `mesh` the model is sharded first (`shard_model`). Returns
    (state, step_fn, optimizer)."""
    mg, whole_cfg = None, model_cfg
    if mesh is not None:
        model_cfg, mg = shard_model(model_cfg, train_cfg, model, mesh)
    opt = make_optimizer(model, train_cfg)
    state = TrainState(step=0, params=model, opt_state=opt, mesh=mg, cfg=whole_cfg)
    return state, make_train_step(model_cfg, opt, remat=remat, attn_impl=attn_impl), opt


def setup_lora_training(model_cfg: RadVLMConfig, train_cfg: TrainConfig, lora_cfg: LoraConfig,
                        base_model: radvlm.RadVLM, *, seed: int = 0, remat: bool = True,
                        attn_impl: str = "auto", adapters: Optional[Adapters] = None,
                        mesh=None):
    """LoRA setup: the base is frozen whole, adapters come from `init_lora`
    (a generator seeded with `seed`) unless given, AdamW with the base
    learning rate over the adapters only. With `mesh` the base is sharded
    by the rules (`shard_model`) and the adapters stay whole on every rank;
    their gradients sum over the batch ranks and `tensor`. Returns (state,
    base, step_fn)."""
    for p in base_model.parameters():
        p.requires_grad_(False)
    if adapters is None:
        gen = torch.Generator(device=base_model.device).manual_seed(seed)
        adapters = init_lora(base_model, lora_cfg, gen)
    params = adapter_parameters(adapters)
    comm, mg, whole_cfg = None, None, model_cfg
    if mesh is not None:
        model_cfg, mg = shard_model(model_cfg, None, base_model, mesh)
        comm = sharding.grad_comm(sharding.sharded(base_model), extra=params)
    opt = Optimizer(params, dict.fromkeys(params, "adapters"),
                    {"adapters": train_cfg.learning_rate}, train_cfg, comm=comm)
    state = TrainState(step=0, params=adapters, opt_state=opt, mesh=mg, cfg=whole_cfg)
    merge_lora(base_model, adapters, lora_cfg)
    step_fn = make_lora_train_step(model_cfg, lora_cfg, opt, remat=remat, attn_impl=attn_impl)
    return state, base_model, step_fn
