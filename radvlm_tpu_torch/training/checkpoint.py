"""Checkpoints of the train state: save, latest, restore, auto-resume
(counterpart of `radvlm_tpu/training/checkpoint.py`).

The JAX package writes orbax directories; orbax imports jax, so the port
does not read them. It writes its own: `<dir>/step_<N>/state.safetensors`
(the port's safetensors container) beside `meta.json`, holding

- `params/<path>`: the parameters under the JAX package's tree paths
  (`convert.radvlm_to_tree`, kernels [in, out], layers stacked), so the
  saved weights load into either package; for LoRA the adapters
  (`params/<kernel path>/a|b`);
- `opt/mu/<name>`, `opt/nu/<name>`, `opt/acc/<name>`: AdamW's moments and,
  inside an accumulation window, the accumulated gradient mean;
- in `meta.json`: the step, the optimizer's update count and its position
  inside an accumulation window, and which tensors are bf16.

A step directory is complete once `meta.json` exists (written last, by
rename). `data_state.json` beside the step directories is the mid-epoch
data position with the JAX package's fields (step, epoch, batch_in_epoch):
the epoch plan is deterministic given (seed, epoch), so a restart skips the
consumed batches instead of seeing them again.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from radvlm_tpu_torch.models import convert, radvlm, safetensors_io
from radvlm_tpu_torch.models.quant_io import _flatten_tree, _unflatten_tree
from radvlm_tpu_torch.training.lora import adapter_parameters

_STATE, _META, _DATA_STATE = "state.safetensors", "meta.json", "data_state.json"


class CheckpointManager:
    """Step directories under `directory`; keeps the newest `max_to_keep`."""

    def __init__(self, directory: str, *, max_to_keep: int = 1, save_interval_steps: int = 200):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _META)):
                steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0 and step not in self.all_steps()


def _param_tensors(params: Any) -> Dict[str, torch.Tensor]:
    if isinstance(params, radvlm.RadVLM):
        return _flatten_tree(convert.radvlm_to_tree(params))
    return {k: v.detach() for k, v in adapter_parameters(params).items()}


def save_state(manager: CheckpointManager, step: int, state, *, force: bool = False) -> bool:
    """Write the train state at `step` if it is a multiple of the save
    interval (or `force`) and not saved yet; then drop the oldest steps
    beyond `max_to_keep`. Returns whether it saved. (Orbax also saves on the
    first call whatever the step; this manager does not.)"""
    if not (force and step not in manager.all_steps()) and not manager.should_save(step):
        return False
    flat = {f"params/{k}": v for k, v in _param_tensors(state.params).items()}
    flat.update({f"opt/{k}": v for k, v in state.opt_state.state_tensors().items()})
    bf16 = []
    for k, v in flat.items():
        if v.dtype == torch.bfloat16:
            bf16.append(k)
            flat[k] = v.view(torch.uint16)
    path = manager._step_dir(step)
    os.makedirs(path, exist_ok=True)
    safetensors_io.write_file(flat, os.path.join(path, _STATE))
    meta = {"step": int(step), "bfloat16": bf16, **state.opt_state.state_scalars()}
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, _META))
    for old in manager.all_steps()[:-manager.max_to_keep]:
        shutil.rmtree(manager._step_dir(old), ignore_errors=True)
    return True


def _read_step(manager: CheckpointManager, step: int):
    """(every saved tensor, bf16 ones as bf16, memory-mapped; meta.json)."""
    path = manager._step_dir(step)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    flat = safetensors_io.read_file(os.path.join(path, _STATE))
    for k in meta.get("bfloat16", ()):
        flat[k] = flat[k].view(torch.bfloat16)
    return flat, meta


def _saved_params(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}


def read_params(manager: CheckpointManager, step: int) -> Dict[str, Any]:
    """The parameter tree saved at `step` (the JAX package's layout, CPU
    tensors): what `convert.radvlm_from_jax` builds a model from. A LoRA
    run's step holds its adapters only, and raises."""
    tree = _unflatten_tree(_saved_params(_read_step(manager, step)[0]))
    if "text" not in tree:
        raise ValueError(f"step {step} under {manager.directory} holds LoRA adapters, not a "
                         "model: merge them into their base first")
    return tree


def restore_state(manager: CheckpointManager, step: int, state):
    """Load step `step` into `state` in place (its parameters, optimizer
    state and step) and return it. `state` is a freshly set-up train state
    of the same configuration: it gives the shapes, dtypes and devices."""
    flat, meta = _read_step(manager, step)
    params = _saved_params(flat)
    if isinstance(state.params, radvlm.RadVLM):
        convert.load_tree(state.params, _unflatten_tree(params))
    else:
        mine = adapter_parameters(state.params)
        if set(mine) != set(params):
            raise ValueError(f"adapter names differ: {sorted(set(mine) ^ set(params))[:5]}")
        with torch.no_grad():
            for k, t in mine.items():
                t.copy_(params[k].to(t.device))
    state.opt_state.load_state(
        {k[len("opt/"):]: v for k, v in flat.items() if k.startswith("opt/")}, meta)
    state.step = int(meta["step"])
    return state


def save_data_state(directory: str, step: int, epoch: int, batch_in_epoch: int) -> None:
    path = os.path.join(os.path.abspath(directory), _DATA_STATE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "epoch": epoch, "batch_in_epoch": batch_in_epoch}, f)
    os.replace(tmp, path)


def load_data_state(directory: str, step: int) -> Optional[dict]:
    """The sidecar if it matches the restored `step` (a mismatch means it is
    stale relative to the checkpoint: ignore it)."""
    path = os.path.join(os.path.abspath(directory), _DATA_STATE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        ds = json.load(f)
    if ds.get("step") != step:
        return None
    return ds
