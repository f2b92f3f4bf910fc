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

Under a mesh (`state.mesh`) every rank writes its own
`state.rank<R>.safetensors`: what it holds of the parameters under its own
keys (ZeRO-3 slices under their unit keys, `params/<unit>`; whole or
tensor-sliced parameters and a pipeline stage's layers under their names)
and its optimizer state under the same keys. Rank 0 writes `meta.json`
once every rank has written, with the mesh's sizes, the whole model's
config and each rank's layout (`ranks`: its place on every axis, each
unit's entries and padding, the parameters it holds sliced over `tensor` or
`expert` and along which dim, its bf16 keys). From the layouts
`read_params` reassembles the canonical tree (whole [L, ...] stacks) and
`restore_state` restores the step under another mesh or on one card,
parameters and Adam state alike; under the mesh it was saved on a rank
reads its own file.

A step directory is complete once `meta.json` exists (written last, by
rename). `data_state.json` beside the step directories is the mid-epoch
data position with the JAX package's fields (step, epoch, batch_in_epoch):
the epoch plan is deterministic given (seed, epoch), so a restart skips the
consumed batches instead of seeing them again.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.models import convert, radvlm, safetensors_io
from radvlm_tpu_torch.parallel import sharding
from radvlm_tpu_torch.models.quant_io import (
    _flatten_tree,
    _unflatten_tree,
    config_from_dict,
    config_to_dict,
)
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


def _mesh_params(params: Any) -> Dict[str, torch.Tensor]:
    """A mesh rank's parameter tensors under its own keys (the live ones)."""
    if isinstance(params, radvlm.RadVLM):
        sm = sharding.sharded(params)
        if sm is None:  # a pipeline stage: its layers and the whole leaves
            return dict(params.named_parameters())
        out = {u.key: u.shard for u in sm.units}
        out.update(sm.whole)
        return out
    return adapter_parameters(params)


def _param_tensors(state) -> Dict[str, torch.Tensor]:
    if state.mesh is not None:
        return {k: v.detach() for k, v in _mesh_params(state.params).items()}
    if isinstance(state.params, radvlm.RadVLM):
        return _flatten_tree(convert.radvlm_to_tree(state.params))
    return {k: v.detach() for k, v in adapter_parameters(state.params).items()}


def _state_file(state) -> str:
    return _STATE if state.mesh is None else _rank_file(dist.get_rank())


def _rank_file(rank: int) -> str:
    return f"state.rank{rank}.safetensors"


def _mesh_meta(state) -> Optional[Dict[str, int]]:
    return None if state.mesh is None else dict(state.mesh.size)


def _layout(state) -> Dict[str, Any]:
    """What reassembly needs of this rank's file: its place on the axes,
    its units (entries [name, shape, offset], total elements, fsdp ranks)
    and the parameters it holds sliced ({name: [tensor dim, expert dim]})."""
    mg = state.mesh
    units, sliced = {}, {}
    sm = sharding.sharded(state.params) if isinstance(state.params, radvlm.RadVLM) else None
    if sm is not None:
        for u in sm.units:
            units[u.key] = {"numel": u.numel, "world": u.world,
                            "entries": [[e.name, list(e.shape), e.offset] for e in u.entries]}
        for name, pl in sm.placements.items():
            dims = sharding.sliced_dims(pl, mg)
            if dims != (None, None):
                sliced[name] = list(dims)
    return {"coords": dict(mg.index), "units": units, "sliced": sliced}


def save_state(manager: CheckpointManager, step: int, state, *, force: bool = False) -> bool:
    """Write the train state at `step` if it is a multiple of the save
    interval (or `force`) and not saved yet; then drop the oldest steps
    beyond `max_to_keep`. Returns whether it saved. (Orbax also saves on the
    first call whatever the step; this manager does not.)"""
    if not (force and step not in manager.all_steps()) and not manager.should_save(step):
        return False
    flat = {f"params/{k}": v for k, v in _param_tensors(state).items()}
    flat.update({f"opt/{k}": v for k, v in state.opt_state.state_tensors().items()})
    bf16 = []
    for k, v in flat.items():
        if v.dtype == torch.bfloat16:
            bf16.append(k)
            flat[k] = v.view(torch.uint16)
    path = manager._step_dir(step)
    os.makedirs(path, exist_ok=True)
    safetensors_io.write_file(flat, os.path.join(path, _state_file(state)))
    layouts = None
    if state.mesh is not None:  # also the barrier: every rank's file is written
        layouts = [None] * dist.get_world_size()
        dist.all_gather_object(layouts, dict(_layout(state), bfloat16=bf16))
    if state.mesh is None or dist.get_rank() == 0:
        meta = {"step": int(step), "bfloat16": bf16, "mesh": _mesh_meta(state),
                **state.opt_state.state_scalars()}
        if layouts is not None:
            meta.update(ranks=layouts, config=None if state.cfg is None else
                        config_to_dict(state.cfg),
                        params="model" if isinstance(state.params, radvlm.RadVLM)
                        else "adapters")
        tmp = os.path.join(path, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, _META))
        for old in manager.all_steps()[:-manager.max_to_keep]:
            shutil.rmtree(manager._step_dir(old), ignore_errors=True)
    if state.mesh is not None:
        dist.barrier()
    return True


def _read_meta(manager: CheckpointManager, step: int) -> Dict[str, Any]:
    with open(os.path.join(manager._step_dir(step), _META)) as f:
        return json.load(f)


def _read_file(path: str, bf16) -> Dict[str, torch.Tensor]:
    """Every tensor of one state file (memory-mapped), bf16 ones as bf16."""
    flat = safetensors_io.read_file(path)
    for k in bf16:
        flat[k] = flat[k].view(torch.bfloat16)
    return flat


_PREFIXES = ("params/", "opt/mu/", "opt/nu/", "opt/acc/")


def _reassemble(manager: CheckpointManager, step: int, meta: Dict[str, Any],
                prefixes=_PREFIXES) -> Dict[str, Dict[str, torch.Tensor]]:
    """{prefix: {parameter name: whole tensor}} of a mesh step, for the
    parameters and each kind of optimizer state (`prefixes` of them): the
    fsdp slices of a unit
    joined and split into its entries, tensor / expert slices joined along
    their dims, a pipeline stage's layers taken from the stage that holds
    them; replicas (data, seq, the stages' whole leaves) read once."""
    path = manager._step_dir(step)
    layouts = meta["ranks"]
    sizes = meta["mesh"]
    files = [_read_file(os.path.join(path, _rank_file(r)), lay.get("bfloat16", ()))
             for r, lay in enumerate(layouts)]
    coords = [lay["coords"] for lay in layouts]

    def without(c, ax):
        return tuple(sorted((k, v) for k, v in c.items() if k != ax))

    peers: Dict[tuple, List[int]] = {}
    for r, c in enumerate(coords):
        peers.setdefault(without(c, "fsdp"), []).append(r)
    for ranks in peers.values():
        ranks.sort(key=lambda r: coords[r]["fsdp"])
    reps = [r for r, c in enumerate(coords) if c["data"] == c["seq"] == c["fsdp"] == 0]
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for prefix in prefixes:
        local: Dict[int, Dict[str, torch.Tensor]] = {}
        for r in reps:
            mine = {}
            for key, t in files[r].items():
                if not key.startswith(prefix):
                    continue
                key = key[len(prefix):]
                unit = layouts[r]["units"].get(key)
                if unit is None:
                    mine[key] = t
                    continue
                ranks = peers[without(coords[r], "fsdp")]
                flat = torch.cat([files[p][prefix + key] for p in ranks])[:unit["numel"]]
                for name, shape, off in unit["entries"]:
                    n = math.prod(shape)
                    mine[name] = flat[off:off + n].view(shape)
            local[r] = mine
        whole = {}
        for name in sorted({n for mine in local.values() for n in mine}):
            holders = [r for r in reps if name in local[r]]
            first = min(coords[r]["stage"] for r in holders)
            at = {(coords[r]["tensor"], coords[r]["expert"]): r
                  for r in holders if coords[r]["stage"] == first}
            tdim, edim = layouts[holders[0]]["sliced"].get(name, (None, None))
            nt = sizes["tensor"] if tdim is not None else 1
            ne = sizes["expert"] if edim is not None else 1
            rows = []
            for ei in range(ne):
                parts = [local[at[(ti, ei)]][name] for ti in range(nt)]
                rows.append(torch.cat(parts, dim=tdim) if nt > 1 else parts[0])
            whole[name] = torch.cat(rows, dim=edim) if ne > 1 else rows[0]
        if whole:
            out[prefix] = whole
    return out


def _saved_params(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}


def read_params(manager: CheckpointManager, step: int) -> Dict[str, Any]:
    """The parameter tree saved at `step` (the JAX package's layout, whole
    [L, ...] stacks, CPU tensors), whatever mesh saved it: what
    `convert.radvlm_from_jax` builds a model from. A LoRA run's step holds
    its adapters only, and raises."""
    meta = _read_meta(manager, step)
    if meta.get("mesh"):
        if meta.get("params") != "model":
            raise ValueError(f"step {step} under {manager.directory} holds LoRA adapters, not "
                             "a model: merge them into their base first")
        if meta.get("config") is None:
            raise ValueError(f"step {step} under {manager.directory} was saved without its "
                             "model config: restore it under its mesh and gather the model")
        whole = _reassemble(manager, step, meta, ("params/",))["params/"]
        model = radvlm.RadVLM(saved_config(manager, step), device="cpu",
                              dtype=whole["image_newline"].dtype)
        model.load_state_dict(whole)
        return convert.radvlm_to_tree(model)
    flat = _read_file(os.path.join(manager._step_dir(step), _STATE), meta.get("bfloat16", ()))
    tree = _unflatten_tree(_saved_params(flat))
    if "text" not in tree:
        raise ValueError(f"step {step} under {manager.directory} holds LoRA adapters, not a "
                         "model: merge them into their base first")
    return tree


def saved_config(manager: CheckpointManager, step: int) -> Optional[RadVLMConfig]:
    """The whole model's config a mesh step saved (None for a step saved on
    one card, or without one)."""
    d = _read_meta(manager, step).get("config")
    return None if d is None else config_from_dict(d)


def _piece(state, key: str, whole: Dict[str, torch.Tensor]) -> torch.Tensor:
    """This rank's tensor under `key` (a unit key or a parameter name) cut
    from the whole parameters `whole`."""
    params, mg = state.params, state.mesh
    sm = sharding.sharded(params) if isinstance(params, radvlm.RadVLM) else None

    def cut(name):
        if name not in whole:
            raise ValueError(f"the saved step holds no {name}")
        t = whole[name]
        if sm is None:
            return t
        tdim, edim = sharding.sliced_dims(sm.placements[name], mg)
        for ax, dim in (("tensor", tdim), ("expert", edim)):
            if dim is not None:
                n = t.shape[dim] // mg.size[ax]
                t = t.narrow(dim, mg.index[ax] * n, n)
        return t

    unit = None if sm is None else next((u for u in sm.units if u.key == key), None)
    if unit is None:
        return cut(key)
    flat = torch.cat([cut(e.name).reshape(-1) for e in unit.entries])
    chunk = unit.shard.numel()
    flat = torch.cat([flat, flat.new_zeros(chunk * unit.world - flat.numel())])
    rank = mg.index["fsdp"]
    return flat[rank * chunk:(rank + 1) * chunk]


def _restore_mesh_step(manager, step, meta, state) -> None:
    """Load a mesh step into `state` under another mesh or layout, or on
    one card: every tensor this rank holds cut from the whole ones."""
    whole = _reassemble(manager, step, meta)
    if state.mesh is not None:
        mine = _mesh_params(state.params)
    elif isinstance(state.params, radvlm.RadVLM):
        mine = dict(state.params.named_parameters())
    else:
        mine = adapter_parameters(state.params)
    with torch.no_grad():
        for k, t in mine.items():
            t.copy_(_piece(state, k, whole["params/"]).to(t.device, t.dtype))
    opt = {}
    for prefix, canon in whole.items():
        if prefix.startswith("opt/"):
            for k in state.opt_state.mu:
                opt[prefix[len("opt/"):] + k] = _piece(state, k, canon)
    state.opt_state.load_state(opt, meta)


def restore_state(manager: CheckpointManager, step: int, state):
    """Load step `step` into `state` in place (its parameters, optimizer
    state and step) and return it. `state` is a freshly set-up train state
    of the same configuration: it gives the shapes, dtypes and devices. A
    step saved on one card restores on one card; one saved over a mesh
    restores under any mesh or on one card (a rank reads its own file where
    it holds what that rank saved)."""
    meta = _read_meta(manager, step)
    path = manager._step_dir(step)
    if not meta.get("mesh"):
        if state.mesh is not None:
            raise ValueError(f"step {step} was saved on one device, this run's mesh is "
                             f"{_mesh_meta(state)}: restore it on one device")
        flat = _read_file(os.path.join(path, _STATE), meta.get("bfloat16", ()))
    else:
        flat = None
        if meta["mesh"] == _mesh_meta(state):
            rank = dist.get_rank()
            flat = _read_file(os.path.join(path, _rank_file(rank)),
                              meta["ranks"][rank].get("bfloat16", ()) if "ranks" in meta
                              else meta.get("bfloat16", ()))
            if set(_param_tensors(state)) != set(_saved_params(flat)):
                flat = None  # the same mesh, another layout (a pipeline's other chunks)
    if flat is None:
        _restore_mesh_step(manager, step, meta, state)
        state.step = int(meta["step"])
        return state
    params = _saved_params(flat)
    if isinstance(state.params, radvlm.RadVLM) and state.mesh is None:
        convert.load_tree(state.params, _unflatten_tree(params))
    else:
        mine = _param_tensors(state)
        if set(mine) != set(params):
            raise ValueError(f"saved tensors differ: {sorted(set(mine) ^ set(params))[:5]}")
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
