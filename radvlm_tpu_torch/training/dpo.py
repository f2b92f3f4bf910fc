"""DPO training: direct preference optimization over chosen / rejected pairs
(counterpart of `radvlm_tpu/training/dpo.py`, on one card).

    loss = -log sigmoid(beta * [(logp_c - ref_logp_c) - (logp_r - ref_logp_r)])

with each sequence's log-probability summed over its supervised (assistant)
tokens. The policy and the frozen reference share the multimodal forward;
the chosen and rejected variants of a pair are separate rows of two batches
of one bucket shape.

A step updates the policy in place. The reference is a real copy of the
starting policy (`copy.deepcopy`, no gradient): shared storage would move it
with every update. Its two passes run under `torch.no_grad()` (the JAX
package's `stop_gradient`: no activations kept) and, like the policy's,
under the train step's bf16 autocast on the card, so a policy equal to its
reference gives a loss of exactly ln 2. The mesh has no counterpart on one
card: a mesh axis other than 1 / -1 raises (ROADMAP M12).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from radvlm_tpu_torch.config import IGNORE_INDEX, RadVLMConfig
from radvlm_tpu_torch.data.loader import Bucket, LlavaJsonDataset, bucketed_batches
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import multimodal, radvlm
from radvlm_tpu_torch.training import checkpoint as ckpt_lib
from radvlm_tpu_torch.training import loop
from radvlm_tpu_torch.training.optimizer import Optimizer, make_optimizer
from radvlm_tpu_torch.training.train_step import TrainState, _autocast

log = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    label_smoothing: float = 0.0


def sequence_logprob(model: radvlm.RadVLM, cfg: RadVLMConfig, batch: Batch, *,
                     remat: bool = True, attn_impl: str = "auto",
                     chunk: int = radvlm.CE_CHUNK) -> torch.Tensor:
    """Sum of log p(label_t | prefix) over the supervised positions. [B]."""
    tok, mask = radvlm.token_logprobs(model, cfg, batch, remat=remat, attn_impl=attn_impl,
                                      chunk=chunk)
    return torch.sum(tok * mask, dim=-1)


def dpo_loss(model: radvlm.RadVLM, ref_model: radvlm.RadVLM, cfg: RadVLMConfig, dpo: DPOConfig,
             chosen: Batch, rejected: Batch, *, remat: bool = True,
             attn_impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The DPO loss (mean over the pairs) and its metrics: loss,
    reward_accuracy, chosen_reward, rejected_reward, reward_margin."""
    kw = dict(remat=remat, attn_impl=attn_impl)
    pol_c = sequence_logprob(model, cfg, chosen, **kw)
    pol_r = sequence_logprob(model, cfg, rejected, **kw)
    with torch.no_grad():
        ref_c = sequence_logprob(ref_model, cfg, chosen, **kw)
        ref_r = sequence_logprob(ref_model, cfg, rejected, **kw)
    logits = dpo.beta * ((pol_c - ref_c) - (pol_r - ref_r))
    ls = dpo.label_smoothing
    loss = -((1 - ls) * F.logsigmoid(logits) + ls * F.logsigmoid(-logits)).mean()
    dc, dr = (pol_c - ref_c).detach(), (pol_r - ref_r).detach()
    metrics = {
        "loss": loss.detach(),
        "reward_accuracy": (dc > dr).float().mean(),
        "chosen_reward": (dpo.beta * dc).mean(),
        "rejected_reward": (dpo.beta * dr).mean(),
        "reward_margin": (dpo.beta * (dc - dr)).mean(),
    }
    return loss, metrics


def make_dpo_step(cfg: RadVLMConfig, dpo: DPOConfig, opt: Optimizer, *, remat: bool = True,
                  attn_impl: str = "auto"):
    """step_fn(state, ref_model, chosen, rejected) -> (state, metrics): the
    DPO loss and its gradients, then one optimizer micro-step (in place).
    Metrics as `dpo_loss`, plus grad_norm (tensors)."""

    def step_fn(state: TrainState, ref_model: radvlm.RadVLM, chosen: Batch, rejected: Batch):
        model = state.params
        with _autocast(model.device):
            loss, metrics = dpo_loss(model, ref_model, cfg, dpo, chosen, rejected, remat=remat,
                                     attn_impl=attn_impl)
        loss.backward()
        metrics["grad_norm"] = opt.step()
        state.step += 1
        return state, metrics

    return step_fn


def frozen_copy(model: radvlm.RadVLM) -> radvlm.RadVLM:
    """A copy of `model` with storage of its own and no gradient: the frozen
    reference of DPO and GRPO."""
    ref = copy.deepcopy(model)
    for p in ref.parameters():
        p.requires_grad_(False)
        p.grad = None
    return ref


def dpo_cell_to_batches(cell: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Split a DPO llava cell ({"prompt", "chosen", "rejected", "image"}) into
    chosen / rejected conversation cells."""
    base = {"image": cell.get("image")}
    prompt_turn = {"from": "human", "value": cell["prompt"]}
    chosen = {**base, "conversations": [prompt_turn, {"from": "gpt", "value": cell["chosen"]}]}
    rejected = {**base, "conversations": [prompt_turn, {"from": "gpt", "value": cell["rejected"]}]}
    return chosen, rejected


@dataclasses.dataclass
class DPOPairDataset:
    """Preference cells -> (chosen MMSample, rejected MMSample) pairs, through
    the SFT dataset's tokenization and image expansion for each side."""

    cells: Any
    image_root: str
    cfg: RadVLMConfig
    tokenize_fn: Callable[[str], List[int]]
    max_len: Optional[int] = None

    def __post_init__(self):
        sides = [dpo_cell_to_batches(cell) for cell in self.cells]
        self._chosen, self._rejected = (
            LlavaJsonDataset(cells=[s[k] for s in sides], image_root=self.image_root,
                             cfg=self.cfg, tokenize_fn=self.tokenize_fn, max_len=self.max_len)
            for k in (0, 1))

    def __len__(self) -> int:
        return len(self.cells)

    def estimated_length(self, i: int) -> int:
        return max(self._chosen.estimated_length(i), self._rejected.estimated_length(i))

    def __getitem__(self, i: int):
        return self._chosen[i], self._rejected[i]


def _build_pair_batch(dataset, idxs, bucket: Bucket):
    """Collate one plan batch into (chosen, rejected) host batches of the
    SAME bucket shape. A pair that fails to load is skipped; its place is
    filled by the last good pair with its labels erased, so the filler
    carries no gradient. Rows longer than the bucket are cut to it."""
    chosen, rejected = [], []
    for i in idxs:
        try:
            c, r = dataset[i]
        except Exception as e:  # a corrupt sample: skipped with a log line (the SFT contract)
            log.warning("skipping dpo sample %d: %s", i, e)
            continue
        chosen.append(c)
        rejected.append(r)
    if not chosen:
        raise RuntimeError(f"entire dpo batch failed to load: {idxs}")
    if len(chosen) < len(idxs):
        fc = dataclasses.replace(chosen[-1], labels=np.full_like(chosen[-1].labels, IGNORE_INDEX))
        fr = dataclasses.replace(rejected[-1],
                                 labels=np.full_like(rejected[-1].labels, IGNORE_INDEX))
        while len(chosen) < len(idxs):
            chosen.append(fc)
            rejected.append(fr)
    out = []
    for side in (chosen, rejected):
        b = multimodal.collate(side, pad_len=bucket.max_len, pad_tiles=bucket.max_tiles,
                               pad_to_multiple=128)
        if b["tokens"].shape[1] > bucket.max_len:
            for key in ("tokens", "img_src", "labels", "segment_ids", "positions"):
                b[key] = b[key][:, :bucket.max_len]
        out.append(b)
    return tuple(out)


def train_dpo(
    run: loop.RunConfig,
    tokenize_fn: Callable[[str], List[int]],
    *,
    dpo_cfg: Optional[DPOConfig] = None,
    init_params: Optional[radvlm.RadVLM] = None,
    hf_checkpoint: Optional[str] = None,
    metrics_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> TrainState:
    """DPO driver: policy + frozen reference (the starting point, standard
    DPO) -> paired bucketed batches -> the DPO step -> checkpoints with
    auto-resume. `run.data_path` is a preference json: a list of {"prompt",
    "chosen", "rejected", "image"?} cells. `init_params` is an unfused f32
    `RadVLM` on the run's device, trained in place; else the model comes
    from `hf_checkpoint` or a random init seeded with `run.seed`. The
    reference is copied before a resume restores the policy, so it stays
    the starting point. Returns the final TrainState."""
    loop.check_mesh(run.mesh_shape)
    device = resolve(run.device)
    dpo_cfg = dpo_cfg or DPOConfig()
    model = loop.load_model(run, device, init_params, hf_checkpoint)
    opt = make_optimizer(model, run.train)
    state = TrainState(step=0, params=model, opt_state=opt)
    ref_model = frozen_copy(model)
    step_fn = make_dpo_step(run.model, dpo_cfg, opt, remat=run.remat, attn_impl=run.attn_impl)
    manager, state, start_epoch, skip_batches = loop.open_checkpoints(run, state)

    with open(run.data_path) as f:
        cells = json.load(f)
    dataset = DPOPairDataset(cells=cells, image_root=run.image_root, cfg=run.model,
                             tokenize_fn=tokenize_fn, max_len=run.buckets[-1].max_len)
    lengths = [dataset.estimated_length(i) for i in range(len(dataset))]

    step = int(state.step)
    t_last = time.perf_counter()
    epoch, batch_in_epoch = start_epoch, skip_batches
    for epoch in range(start_epoch, run.num_epochs):
        plan = bucketed_batches(lengths, run.micro_batch_size, buckets=run.buckets,
                                seed=run.seed + epoch)
        batch_in_epoch = skip_batches if epoch == start_epoch else 0
        for b, idxs in plan[batch_in_epoch:]:
            if run.max_steps is not None and step >= run.max_steps:
                break
            cb, rb = _build_pair_batch(dataset, idxs, run.buckets[b])
            state, metrics = step_fn(state, ref_model, batch_to_device(cb, device),
                                     batch_to_device(rb, device))
            step += 1
            batch_in_epoch += 1
            if step % run.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the card
                m["sec_per_step"] = (time.perf_counter() - t_last) / run.log_every
                t_last = time.perf_counter()
                log.info("dpo step %d: %s", step, m)
                if metrics_callback:
                    metrics_callback(step, m)
            if manager and ckpt_lib.save_state(manager, step, state):
                ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
        if run.max_steps is not None and step >= run.max_steps:
            break

    if manager and ckpt_lib.save_state(manager, step, state, force=True):
        ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
    return state
