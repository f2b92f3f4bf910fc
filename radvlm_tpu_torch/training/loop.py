"""SFT training loop: data -> train step -> checkpoints -> logs
(counterpart of `radvlm_tpu/training/loop.py`, on one card).

Loads or initialises f32 parameters (an HF directory, a given model or a
seeded random init), freezes per `mm_tunable_parts` (or attaches LoRA
adapters over a dense or int8-quantized frozen base), streams bucketed
batches from the `PrefetchLoader`, runs the train step and checkpoints with
auto-resume from the latest step. Meshes, ring attention and pipeline
stages are not ported (ROADMAP M12): a mesh shape other than one device
raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.data.export import load_mixture
from radvlm_tpu_torch.data.loader import DEFAULT_BUCKETS, LlavaJsonDataset, PrefetchLoader
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.training import checkpoint as ckpt_lib
from radvlm_tpu_torch.training import train_step as ts
from radvlm_tpu_torch.training.optimizer import TrainConfig

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RunConfig:
    model: RadVLMConfig
    train: TrainConfig
    data_path: str  # llava json / brace glob / yaml mixture
    image_root: str
    mesh_shape: Optional[Dict[str, int]] = None  # only one device (1 / -1 on every axis)
    micro_batch_size: int = 8  # rows per micro-step
    max_steps: Optional[int] = None  # micro-steps
    num_epochs: int = 1
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    save_steps: int = 200
    max_to_keep: int = 1
    resume: bool = True
    seed: int = 0
    buckets: tuple = DEFAULT_BUCKETS
    remat: bool = True
    attn_impl: str = "auto"
    loader_workers: int = 8
    # Samples packed into one row (the loader's `pack_factor`); 1 = none.
    pack_factor: int = 1
    # LoRA (adapter-only) finetuning; 0 = full finetune.
    lora_rank: int = 0
    lora_alpha: float = 256.0
    # QLoRA: int8-quantize the frozen base before attaching adapters; the
    # base stays int8 on the card, adapters train in f32. Needs lora_rank > 0.
    quantize_base: bool = False
    # Positional-skipping augmentation: 0 = off; > 0 = per-sample random
    # left / right position offsets in [0, range].
    pos_skip_range: int = 0
    # None: the card; "cpu" where the caller asks for it.
    device: Optional[str] = None


def _check_mesh(mesh_shape: Optional[Dict[str, int]]) -> None:
    for axis, n in (mesh_shape or {}).items():
        if n not in (1, -1):
            raise NotImplementedError(
                f"mesh axis {axis}={n}: meshes, ring attention and pipeline stages are not "
                "ported (ROADMAP M12); the port trains on one card"
            )


def train(
    run: RunConfig,
    tokenize_fn: Callable[[str], List[int]],
    *,
    init_params: Optional[radvlm.RadVLM] = None,
    hf_checkpoint: Optional[str] = None,
    metrics_callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> ts.TrainState:
    """Run SFT (or LoRA / QLoRA). Returns the final TrainState.

    `init_params` is an unfused `RadVLM` on the run's device (f32 for full
    finetuning; it is trained in place), else the model comes from
    `hf_checkpoint` or a random init seeded with `run.seed`."""
    _check_mesh(run.mesh_shape)
    device = resolve(run.device)

    # --- params ---
    if init_params is not None:
        model = init_params
    elif hf_checkpoint:
        from radvlm_tpu_torch.models.hf_import import load_radvlm_checkpoint

        model = load_radvlm_checkpoint(hf_checkpoint, run.model, device=device,
                                       dtype=torch.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        model = convert.init_params(run.model, gen, device=device, dtype=torch.float32)

    lora_base = None
    if run.quantize_base and not run.lora_rank:
        raise ValueError("--quantize-base is a QLoRA option: set lora_rank > 0")
    if run.lora_rank:
        from radvlm_tpu_torch.generation.engine import is_quantized
        from radvlm_tpu_torch.ops import quant
        from radvlm_tpu_torch.training.lora import LoraConfig

        if run.quantize_base and not is_quantized(model):
            quant.quantize_model(model)
        lcfg = LoraConfig(rank=run.lora_rank, alpha=run.lora_alpha)
        state, lora_base, step_fn = ts.setup_lora_training(
            run.model, run.train, lcfg, model, seed=run.seed, remat=run.remat,
            attn_impl=run.attn_impl,
        )
    else:
        state, step_fn, _ = ts.setup_training(
            run.model, run.train, model, remat=run.remat, attn_impl=run.attn_impl,
        )

    # --- resume ---
    manager = None
    start_epoch, skip_batches = 0, 0
    if run.checkpoint_dir:
        manager = ckpt_lib.CheckpointManager(
            run.checkpoint_dir, max_to_keep=run.max_to_keep, save_interval_steps=run.save_steps,
        )
        last = manager.latest_step()
        if run.resume and last is not None:
            state = ckpt_lib.restore_state(manager, last, state)
            data_state = ckpt_lib.load_data_state(run.checkpoint_dir, last)
            if data_state:
                start_epoch = int(data_state["epoch"])
                skip_batches = int(data_state["batch_in_epoch"])
            log.info("resumed from step %d (epoch %d, skipping %d batches)",
                     last, start_epoch, skip_batches)

    # --- data ---
    cells = load_mixture(run.data_path)
    dataset = LlavaJsonDataset(
        cells=cells,
        image_root=run.image_root,
        cfg=run.model,
        tokenize_fn=tokenize_fn,
        max_len=run.buckets[-1].max_len,
    )
    loader = PrefetchLoader(
        dataset,
        run.micro_batch_size,
        buckets=run.buckets,
        seed=run.seed,
        num_workers=run.loader_workers,
        pos_skip_range=run.pos_skip_range,
        pack_factor=run.pack_factor,
    )

    # --- loop ---
    step = int(state.step)
    t_last = time.perf_counter()
    tokens_seen = 0
    epoch, batch_in_epoch = start_epoch, skip_batches
    for epoch in range(start_epoch, run.num_epochs):
        batch_in_epoch = skip_batches if epoch == start_epoch else 0
        for host_batch in loader.epoch(epoch, skip=batch_in_epoch):
            if run.max_steps is not None and step >= run.max_steps:
                break
            batch = batch_to_device(host_batch, device)
            if lora_base is not None:
                state, metrics = step_fn(state, lora_base, batch)
            else:
                state, metrics = step_fn(state, batch)
            step += 1
            batch_in_epoch += 1
            tokens_seen += int((host_batch["segment_ids"] != 0).sum())
            if step % run.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the card
                now = time.perf_counter()
                m["tokens_per_sec"] = tokens_seen / max(now - t_last, 1e-9)
                tokens_seen = 0
                t_last = now
                log.info("step %d: %s", step, m)
                if metrics_callback:
                    metrics_callback(step, m)
            if manager and ckpt_lib.save_state(manager, step, state):
                ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
        if run.max_steps is not None and step >= run.max_steps:
            break

    if manager and ckpt_lib.save_state(manager, step, state, force=True):
        ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
    return state
