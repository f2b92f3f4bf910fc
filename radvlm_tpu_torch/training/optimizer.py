"""Optimizer: per-module learning-rate groups, tunable-parts freezing, AdamW
with a global-norm clip and gradient accumulation (counterpart of
`radvlm_tpu/training/optimizer.py`).

The JAX package composes this from optax (`masked(set_to_zero)` ->
`clip_by_global_norm` -> `multi_transform` of `adamw` per group ->
`MultiSteps`). Here it is one small class, `Optimizer`, written so that every
step repeats optax's arithmetic:

- frozen parameters have no gradient at all (`mark_trainable` turns
  `requires_grad` off), so they are out of the clip's norm, as optax zeroes
  them BEFORE the clip;
- the clip scales by max_norm / norm only where norm >= max_norm
  (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead);
- AdamW: m and v, bias correction by 1 - b^t, update m_hat / (sqrt(v_hat) +
  eps) + weight_decay * p, times -lr(t) with t the number of updates made
  so far (the first update runs at lr(0), which is 0 under a warmup);
- accumulation keeps the running mean of the micro-steps' gradients
  (acc += (g - acc) / (n + 1)) and updates on every `grad_accum_steps`-th
  call; the schedules count updates, not micro-steps.

`Optimizer.step` updates the parameters in place and frees their `.grad`.
Under a mesh (`parallel/sharding.py`) its parameters are this rank's
slices and whole tensors, and a `comm` sums the gradients over the batch
ranks before anything else and gives the global norm over the whole
parameters, every element counted once; AdamW is elementwise and runs on
the local slices as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (the JAX package's defaults)."""

    learning_rate: float = 1e-5
    vision_tower_lr: Optional[float] = 2e-6
    projector_lr: Optional[float] = None  # None -> base LR
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.03
    total_steps: int = 4000
    lr_schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    # Comma-separated tunable parts: mm_mlp_adapter, mm_vision_tower,
    # mm_language_model.
    mm_tunable_parts: str = "mm_vision_tower,mm_mlp_adapter,mm_language_model"
    grad_accum_steps: int = 2
    micro_batch_size: int = 1


def group_of(name: str) -> str:
    """The learning-rate group of a `RadVLM` parameter name."""
    if name.startswith("vision_tower"):
        return "vision_tower"
    if name.startswith("projector") or name.startswith("image_newline"):
        return "projector"
    return "language_model"


def tunable(group: str, parts: str) -> bool:
    names = {p.strip() for p in parts.split(",") if p.strip()}
    return {
        "vision_tower": "mm_vision_tower" in names,
        "projector": "mm_mlp_adapter" in names,
        "language_model": "mm_language_model" in names,
    }[group]


def mark_trainable(model: nn.Module, cfg: TrainConfig) -> Dict[str, str]:
    """Turn `requires_grad` on for the floating-point parameters of the
    tunable groups and off for every other; returns {parameter name: group}
    of the trainable ones."""
    labels = {}
    for name, p in model.named_parameters():
        g = group_of(name)
        on = tunable(g, cfg.mm_tunable_parts) and p.is_floating_point()
        p.requires_grad_(on)
        if on:
            labels[name] = g
    return labels


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: constant `init` where steps <= 0."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def make_schedule(cfg: TrainConfig, peak_lr: float) -> Callable[[int], float]:
    """update count -> learning rate, equal to the optax schedules the JAX
    package builds: linear warmup over warmup_ratio * total_steps updates,
    then cosine decay to 0 at total_steps, linear decay to 0, or constant."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 0)
    rise = _linear(0.0, peak_lr, warmup)
    if cfg.lr_schedule == "constant":
        return rise if warmup else (lambda count: peak_lr)
    if cfg.lr_schedule == "linear":
        fall = _linear(peak_lr, 0.0, max(cfg.total_steps - warmup, 1))
    else:
        decay = max(cfg.total_steps, warmup + 1) - warmup

        def fall(count):
            return peak_lr * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))

    return lambda count: rise(count) if count < warmup else fall(count - warmup)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in f32 (optax.global_norm)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


class Optimizer:
    """Clip + per-group AdamW + accumulation over named parameters.

    `params` maps a name to a trainable tensor, `labels` the same names to a
    group, `peak_lrs` a group to its peak learning rate. State: `count`
    (updates made), `mini_step` (micro-steps since the last update), m, v
    and, with accumulation, the running mean of the gradients."""

    def __init__(self, params: Dict[str, torch.Tensor], labels: Dict[str, str],
                 peak_lrs: Dict[str, float], cfg: TrainConfig, comm=None):
        self.cfg = cfg
        self.comm = comm  # sharding.GradComm under a mesh
        self.params = dict(params)
        self.labels = dict(labels)
        self.schedules = {g: make_schedule(cfg, lr) for g, lr in peak_lrs.items()}
        self.count = 0
        self.mini_step = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if cfg.grad_accum_steps > 1 else None)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One micro-step: fold the parameters' `.grad` in and, on every
        `grad_accum_steps`-th call, update. Returns the global norm of this
        micro-step's raw gradients (a tensor: no host sync here)."""
        names = list(self.params)
        grads = []
        for n in names:
            p = self.params[n]
            grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
            p.grad = None
        if self.comm is not None:
            self.comm.sync(names, grads)
        norm = self._norm(names, grads)
        k = self.cfg.grad_accum_steps
        if k > 1:
            acc = [self.acc[n] for n in names]
            # acc += (g - acc) / (mini_step + 1): optax.MultiSteps' running mean.
            torch._foreach_sub_(grads, acc)
            torch._foreach_div_(grads, float(self.mini_step + 1))
            torch._foreach_add_(acc, grads)
            self.mini_step += 1
            if self.mini_step < k:
                return norm
            self.mini_step = 0
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
            self._update(names, grads, self._norm(names, grads))
        else:
            self._update(names, grads, norm)
        return norm

    def _norm(self, names, grads) -> torch.Tensor:
        if self.comm is not None:
            return self.comm.norm(names, grads)
        return global_norm(grads)

    def _update(self, names, grads, norm: torch.Tensor) -> None:
        cfg = self.cfg
        # clip_by_global_norm: g * max_norm / norm where norm >= max_norm.
        factor = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                             cfg.max_grad_norm / norm)
        grads = [g * factor.to(g.dtype) for g in grads]
        t = self.count + 1
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        lrs = {g: sched(self.count) for g, sched in self.schedules.items()}
        for n, m, v in zip(names, mu, nu):
            p = self.params[n]
            update = (m / c1) / (torch.sqrt(v / c2) + cfg.adam_eps)
            if cfg.weight_decay:
                update = update + cfg.weight_decay * p
            p.add_(update, alpha=-lrs[self.labels[n]])
        self.count = t

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The state's tensors under `mu/<name>`, `nu/<name>`, `acc/<name>`
        (the accumulator only inside an accumulation window: between
        windows it is zero)."""
        out = {}
        acc = self.acc if self.acc is not None and self.mini_step else {}
        for kind, d in (("mu", self.mu), ("nu", self.nu), ("acc", acc)):
            for n, t in d.items():
                out[f"{kind}/{n}"] = t
        return out

    def state_scalars(self) -> Dict[str, int]:
        return {"count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state(self, tensors: Dict[str, torch.Tensor], scalars: Dict[str, int]) -> None:
        self.count, self.mini_step = int(scalars["count"]), int(scalars["mini_step"])
        if self.acc is not None:
            torch._foreach_zero_(list(self.acc.values()))
        mine = self.state_tensors()
        if set(mine) != set(tensors):
            raise ValueError(f"optimizer state names differ: {sorted(set(mine) ^ set(tensors))[:5]}")
        for name, t in mine.items():
            t.copy_(tensors[name].to(t.device))


def peak_rates(cfg: TrainConfig) -> Dict[str, float]:
    return {
        "language_model": cfg.learning_rate,
        "vision_tower": cfg.vision_tower_lr or cfg.learning_rate,
        "projector": cfg.projector_lr or cfg.learning_rate,
    }


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> Optimizer:
    """Freeze by `mm_tunable_parts`, then one `Optimizer` over the trainable
    parameters with the three groups' peak rates. A model sharded by
    `parallel.sharding.shard_model` (frozen before it) gets an optimizer
    over its slices and whole tensors, with their `GradComm`."""
    from radvlm_tpu_torch.parallel import sharding

    sm = sharding.sharded(model)
    if sm is not None:
        params, labels = sm.trainable()
        return Optimizer(params, labels, peak_rates(cfg), cfg, comm=sharding.grad_comm(sm))
    labels = mark_trainable(model, cfg)
    params = {n: p for n, p in model.named_parameters() if n in labels}
    return Optimizer(params, labels, peak_rates(cfg), cfg)
