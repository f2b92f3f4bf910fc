"""Which collectives gloo carries on CUDA tensors, two ranks on one card
(the ZeRO-3 reduce-scatter and qgZ's all_to_all among them).

    python tools/torch_gloo_probe.py

Each collective runs in its own pair of spawned processes on cuda:0, so one
that kills its rank (gloo sends a device pointer as if it were host memory)
does not hide the others; then NCCL at one rank runs an all_reduce and a
send to itself. Prints one line a collective and a JSON summary. NCCL
refuses two ranks on one device, which is why a one-card machine runs the
port's multi-rank paths over gloo (`parallel/`).
"""

from __future__ import annotations

import json
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVES = ("all_reduce", "all_reduce_bf16", "all_reduce_max", "all_gather",
               "all_gather_bf16", "all_gather_into_tensor", "broadcast", "batch_isend_irecv",
               "send_recv", "reduce_scatter_tensor", "all_to_all_single")


def _rank(rank: int, world: int, init: str, name: str) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    x = torch.full((4096,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif name == "all_reduce_bf16":
        x = x.bfloat16()
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        ok = float(x[0]) == 2.0
    elif name in ("all_gather", "all_gather_bf16"):
        x = x.bfloat16() if name.endswith("bf16") else x
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        ok = float(outs[1][0]) == 2.0
    elif name == "all_gather_into_tensor":
        out = torch.empty((world * 4096,), device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = float(out[4096]) == 2.0
    elif name == "broadcast":
        dist.broadcast(x, src=1)
        ok = float(x[0]) == 2.0
    elif name == "reduce_scatter_tensor":  # ZeRO-3's gradient sum (parallel/sharding.py)
        out = torch.empty((4096 // world,), device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = float(out[0]) == 3.0
    elif name == "all_to_all_single":  # qgZ's exchange (parallel/compression.py)
        c = 4096 // world
        x = (torch.arange(4096, device=dev) // 64 + 100 * rank).to(torch.int8)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)  # chunk `rank` of every rank's x, in rank order
        want = torch.cat([torch.arange(rank * c, (rank + 1) * c, device=dev) // 64 + 100 * s
                          for s in range(world)]).to(torch.int8)
        ok = bool(torch.equal(out, want))
    elif name == "batch_isend_irecv":
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ok = float(y[0]) == float((rank - 1) % world + 1)
    else:  # send_recv
        if rank == 0:
            dist.send(x, 1)
            ok = True
        else:
            dist.recv(x, 0)
            ok = float(x[0]) == 1.0
    torch.cuda.synchronize()
    dist.destroy_process_group()
    if not ok:
        raise RuntimeError(f"{name}: wrong result")


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("gloo_probe: no CUDA device")
    out = {}
    for name in COLLECTIVES:
        t0 = time.perf_counter()
        try:
            mp.spawn(_rank, args=(2, f"file://{tempfile.mkdtemp()}/store", name), nprocs=2)
            out[name] = "ok"
        except Exception as e:  # a rank that died or raised: the collective is not carried
            out[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:120]}"
        print(f"gloo {name}: {out[name]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    try:
        x = torch.ones(8, device="cuda:0")
        dist.all_reduce(x)
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0),
                                           dist.P2POp(dist.irecv, y, 0)]):
            req.wait()
        out["nccl_one_rank"] = "ok" if float(x[0]) == float(y[0]) == 1.0 else "wrong result"
    finally:
        dist.destroy_process_group()
    print(f"nccl one rank all_reduce + self send: {out['nccl_one_rank']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
