"""SFT training loop: data -> train step -> checkpoints -> logs
(counterpart of `radvlm_tpu/training/loop.py`), on one card or over a mesh.

Loads or initialises f32 parameters (an HF directory, a given model or a
seeded random init), freezes per `mm_tunable_parts` (or attaches LoRA
adapters over a dense or int8-quantized frozen base), streams bucketed
batches from the `PrefetchLoader`, runs the train step and checkpoints with
auto-resume from the latest step.

A mesh shape with an axis above one (or a process group made already, a
world of one included) runs over the mesh (`parallel/mesh.py`,
`parallel/sharding.py`): every rank loads the same global batch and keeps
its part (`sharding.batch_shardings`); with `seq` > 1 (or attn_impl "ring")
the decoder's attention is ring attention over `seq`, the batch
zigzag-permuted with its labels shifted first (`ring.zigzag_shift_batch`);
with `stage` > 1 the step is the pipeline's (`parallel/pp.py`:
`setup_pp_training`, or `setup_pp_lora_training` with LoRA), over
`pp_microbatches` microbatches and `pp_interleave` chunks a rank. Only
rank 0 logs and writes the data state.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.data.export import load_mixture
from radvlm_tpu_torch.data.loader import DEFAULT_BUCKETS, LlavaJsonDataset, PrefetchLoader
from radvlm_tpu_torch.device import resolve
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.parallel import pp, ring, sharding
from radvlm_tpu_torch.parallel.mesh import init_distributed, make_mesh
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
    # Axis sizes (parallel.mesh.AXES; -1 takes the rest); None: one device.
    mesh_shape: Optional[Dict[str, int]] = None
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
    # Ring-attention schedule when the mesh has seq > 1: "zigzag" (load-
    # balanced, default) or "contiguous".
    ring_schedule: str = "zigzag"
    # Pipeline parallelism (mesh stage > 1): microbatches a step, and layer
    # chunks a rank (the interleaved schedule when > 1).
    pp_microbatches: int = 4
    pp_interleave: int = 1
    # None: the card; "cpu" where the caller asks for it.
    device: Optional[str] = None


def open_mesh(run: RunConfig):
    """The run's `DeviceMesh`, or None for one device (`sharding.wants_mesh`).
    A shape of more than one rank needs the process group made first
    (torchrun and `mesh.init_distributed`); `make_mesh` raises otherwise."""
    sharding.check_axes(run.mesh_shape)
    if not sharding.wants_mesh(run.mesh_shape):
        return None
    return make_mesh(run.mesh_shape)


def stages(mesh) -> int:
    """Pipeline stages of the run's mesh (1 on one device)."""
    return 1 if mesh is None else mesh["stage"].size()


def pp_step_config(run: RunConfig, attn_impl: str) -> pp.PPStepConfig:
    return pp.PPStepConfig(n_microbatches=run.pp_microbatches, remat=run.remat,
                           attn_impl=attn_impl, interleave=run.pp_interleave)


def ring_route(run: RunConfig, mesh) -> str:
    """The decoder's attention: "ring" over the mesh's seq group when seq > 1
    or `run.attn_impl` asks for it (registered here), else run.attn_impl."""
    if mesh is None or not (mesh["seq"].size() > 1 or run.attn_impl == "ring"):
        return run.attn_impl
    ring.enable_ring_attention(mesh, axis_name="seq", impl="flash", schedule=run.ring_schedule)
    return "ring"


def rank_batch(host_batch, mg: Optional[sharding.MeshGroups], attn_impl: str):
    """This rank's part of a host batch (the whole batch on one device); a
    ring run's batch is zigzag-permuted with its labels shifted first."""
    if mg is None:
        return host_batch
    if attn_impl == "ring":
        n = mg.size["seq"]
        schedule = ring.get_ring_context()[2]
        host_batch = (ring.zigzag_shift_batch(host_batch, n) if schedule == "zigzag"
                      else ring.shift_labels(host_batch))
    return sharding.batch_shardings(mg, host_batch)


def is_main() -> bool:
    """Rank 0 of the world (or no process group): the rank that logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def add_mesh_args(p) -> None:
    """The drivers' mesh flags (the JAX package's, plus `--mesh-expert`)."""
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-fsdp", type=int, default=-1)
    p.add_argument("--mesh-seq", type=int, default=1,
                   help=">1 enables ring-attention sequence parallelism (SFT only)")
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--mesh-expert", type=int, default=1,
                   help="expert parallelism over the MoE tables")
    p.add_argument("--multihost", action="store_true",
                   help="one process per card, started by torchrun")


def mesh_shape(args) -> Dict[str, int]:
    shape = {ax: getattr(args, f"mesh_{ax}") for ax in ("data", "fsdp", "seq", "tensor", "expert")}
    if hasattr(args, "mesh_stage"):
        shape["stage"] = args.mesh_stage
    return shape


def start_multihost(args) -> Optional[str]:
    """`--multihost`: the default process group from torchrun's environment
    (`mesh.init_distributed`), each rank on its card `cuda:<LOCAL_RANK>`
    unless `--device` says otherwise; returns the device. Without torchrun's
    environment it raises."""
    if not args.multihost:
        return args.device
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise ValueError(f"--multihost initialises from torchrun's environment; {missing} "
                         "unset: launch with torchrun --nproc-per-node <cards> -m ...")
    device = resolve(args.device or f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(device=device)
    return str(device)


def load_model(run: RunConfig, device: torch.device, init_params: Optional[radvlm.RadVLM] = None,
               hf_checkpoint: Optional[str] = None) -> radvlm.RadVLM:
    """The run's starting model, unfused on `device`: `init_params` as it
    is, else f32 weights from `hf_checkpoint`, else a random f32 init seeded
    with `run.seed`."""
    if init_params is not None:
        return init_params
    if hf_checkpoint:
        from radvlm_tpu_torch.models.hf_import import load_radvlm_checkpoint

        return load_radvlm_checkpoint(hf_checkpoint, run.model, device=device,
                                      dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    return convert.init_params(run.model, gen, device=device, dtype=torch.float32)


def open_checkpoints(run: RunConfig, state: ts.TrainState):
    """(manager, state, start epoch, batches to skip): the checkpoint
    manager of `run.checkpoint_dir` (None without one), with `state`
    restored in place from its latest step when `run.resume`, and the data
    position saved beside that step."""
    if not run.checkpoint_dir:
        return None, state, 0, 0
    manager = ckpt_lib.CheckpointManager(
        run.checkpoint_dir, max_to_keep=run.max_to_keep, save_interval_steps=run.save_steps,
    )
    start_epoch, skip_batches = 0, 0
    last = manager.latest_step()
    if run.resume and last is not None:
        state = ckpt_lib.restore_state(manager, last, state)
        data_state = ckpt_lib.load_data_state(run.checkpoint_dir, last)
        if data_state:
            start_epoch = int(data_state["epoch"])
            skip_batches = int(data_state["batch_in_epoch"])
        log.info("resumed from step %d (epoch %d, skipping %d batches)",
                 last, start_epoch, skip_batches)
    return manager, state, start_epoch, skip_batches


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
    `hf_checkpoint` or a random init seeded with `run.seed`. Under a mesh
    every rank builds the whole model and keeps its part."""
    mesh = open_mesh(run)
    device = resolve(run.device)
    attn_impl = ring_route(run, mesh)
    try:
        return _train(run, tokenize_fn, mesh, device, attn_impl, init_params, hf_checkpoint,
                      metrics_callback)
    finally:
        if attn_impl == "ring":
            ring.enable_ring_attention(None)


def _train(run, tokenize_fn, mesh, device, attn_impl, init_params, hf_checkpoint,
           metrics_callback):
    model = load_model(run, device, init_params, hf_checkpoint)

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
        if stages(mesh) > 1:
            state, lora_base, step_fn = pp.setup_pp_lora_training(
                mesh, run.model, run.train, lcfg, model, seed=run.seed,
                pp_cfg=pp_step_config(run, attn_impl))
        else:
            state, lora_base, step_fn = ts.setup_lora_training(
                run.model, run.train, lcfg, model, seed=run.seed, remat=run.remat,
                attn_impl=attn_impl, mesh=mesh,
            )
    elif stages(mesh) > 1:
        state, step_fn, _ = pp.setup_pp_training(mesh, run.model, run.train, model,
                                                 pp_cfg=pp_step_config(run, attn_impl))
    else:
        state, step_fn, _ = ts.setup_training(
            run.model, run.train, model, remat=run.remat, attn_impl=attn_impl, mesh=mesh,
        )

    manager, state, start_epoch, skip_batches = open_checkpoints(run, state)

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
            batch = batch_to_device(rank_batch(host_batch, state.mesh, attn_impl), device)
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
                if is_main():
                    log.info("step %d: %s", step, m)
                if metrics_callback:
                    metrics_callback(step, m)
            if manager and ckpt_lib.save_state(manager, step, state) and is_main():
                ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
        if run.max_steps is not None and step >= run.max_steps:
            break

    if manager and ckpt_lib.save_state(manager, step, state, force=True) and is_main():
        ckpt_lib.save_data_state(run.checkpoint_dir, step, epoch, batch_in_epoch)
    return state
