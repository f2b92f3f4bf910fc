"""The device mesh over `torch.distributed` (counterpart of
`radvlm_tpu/parallel/mesh.py`).

One `DeviceMesh` with the JAX package's named axes, over the ranks of the
default process group:

  data   - data parallelism (batch split)
  stage  - pipeline parallelism
  fsdp   - parameter / optimizer sharding
  seq    - sequence parallelism (ring attention, parallel/ring.py; SP decode,
           parallel/sp_decode.py)
  tensor - tensor parallelism (parallel/tp.py)
  expert - expert parallelism

`init_distributed` makes the default group: from `torchrun`'s environment
(`RANK`, `WORLD_SIZE`, `MASTER_ADDR` / `MASTER_PORT`), from an explicit
`init_method` (the tests pass a `file://` store), or, for one process and no
environment, a world of one on an in-memory store. NCCL serves CUDA devices,
gloo the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "stage", "fsdp", "seq", "tensor", "expert")


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Tuple[int, int]:
    """Make the default process group if none exists; returns (rank, world).

    `backend` None picks NCCL for a CUDA `device` and gloo otherwise. Rank
    and world size come from the arguments, else from torchrun's `RANK` /
    `WORLD_SIZE`. Without an `init_method` the group rendezvouses through
    the environment (`MASTER_ADDR` / `MASTER_PORT`); with no environment at
    all, a world of one process gets an in-memory store, and a caller that
    asked for more than one rank gets a ValueError."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl" and device is not None:
        kw["device_id"] = torch.device(device)
    if init_method is None and "MASTER_ADDR" not in env:
        if world_size > 1:
            raise ValueError(
                f"init_distributed: a world of {world_size} ranks needs torchrun's "
                "environment (MASTER_ADDR / MASTER_PORT) or an init_method")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kw)
    return rank, world_size


def _sizes(mesh_shape: Optional[Dict[str, int]], n: int) -> Tuple[int, ...]:
    """Axis sizes in AXES order: unspecified axes are 1, a single -1 takes
    what the fixed axes leave of `n` (default: everything on fsdp)."""
    shape = dict(mesh_shape or {"fsdp": -1})
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are {AXES}")
    sizes = [shape.get(ax, 1) for ax in AXES]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError(f"mesh shape {shape}: at most one axis may be -1")
    fixed = math.prod(s for s in sizes if s != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    elif fixed != n:
        raise ValueError(f"mesh shape {shape} needs {fixed} devices, have {n}")
    return tuple(sizes)


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None):
    """A `DeviceMesh` over the world's ranks with the named AXES.

    mesh_shape maps axis name -> size, as in the JAX package: unspecified
    axes get 1 and a single -1 absorbs the remaining ranks. The world is the
    default process group's; where there is none, a shape of one rank gets a
    world of one (`init_distributed`) and a larger one raises. The mesh's
    device type is "cuda" under NCCL and "cpu" under gloo (which also
    carries the all_reduces of CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if math.prod(s for s in (mesh_shape or {}).values() if s != -1) > 1:
            raise ValueError(
                f"make_mesh({mesh_shape}): no process group exists; start the ranks "
                "with torchrun or call parallel.mesh.init_distributed first")
        init_distributed()
    sizes = _sizes(mesh_shape, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=AXES)


def local_mesh_info(mesh) -> Tuple[int, int]:
    """(total devices, batch-parallel ways) for sizing host batches."""
    return mesh.size(), mesh["data"].size() * mesh["fsdp"].size()
