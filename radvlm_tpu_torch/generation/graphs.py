"""The continuous engine's decode chunk as one CUDA graph: the port's
counterpart of the JAX engine's jitted `lax.scan` chunk (`make_chunk` and
the spec verify chunk in `radvlm_tpu/generation/continuous.py`), one host
call a K-step chunk instead of K steps of kernel launches.

- `chunk_route` is the one predicate that decides how an engine runs its
  chunks: `ContinuousBatcher` asks it at every dispatch and reports it in
  `kernel_provenance` ("decode_chunk").
- `ChunkGraph` captures one chunk variant (greedy, sampling or spec verify)
  and replays it. The chunk's body must keep the storage of every tensor it
  reads or writes across replays: the graph holds their addresses, and the
  kernels' TMA tensor maps, encoded on the host at capture, hold them by
  value.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from radvlm_tpu_torch import kernels


def chunk_route(device: torch.device, tp_group=None, eager: bool = False) -> str:
    """How an engine on `device` runs its decode chunks: "graph" (each
    variant runs eagerly once, is captured at its next dispatch and replayed
    from then on), or "eager: <why>": asked for (`eager`), not on a card (the
    CPU runs the same chunk body, uncaptured), or a tensor-parallel group
    whose all_reduces cannot be captured (gloo stages them through host
    memory; NCCL's are captured with the chunk)."""
    if eager:
        return "eager: asked"
    if device.type != "cuda":
        return f"eager: {device.type}"
    if tp_group is not None:
        backend = str(dist.get_backend(tp_group))
        if backend != "nccl":
            return f"eager: {backend} group"
    return "graph"


class ChunkGraph:
    """One chunk variant captured as a CUDA graph.

    `capture(body)` runs `body` under capture on `stream`, the engine's own
    side stream, in thread-local capture mode: the stream is current on the
    capturing thread only, so what other threads queue meanwhile (uploads
    of new requests, another engine of a fleet) lands on their own current
    streams and is neither captured nor refused. Its kernels' launches are
    recorded (`kernels.recording`), not counted; every `replay()` launches
    the graph on the caller's current stream and counts them, which is what
    an eager run of the body counts. `body`'s output is static: each replay
    writes it again, so its reader must be queued on the stream before the
    next replay. With `generator`, the graph's random draws come from it
    and advance it, so eager draws between replays (a fill's first token)
    and the graph's never repeat each other. A failed capture raises.
    `graph` stands in for `torch.cuda.CUDAGraph` (tests)."""

    def __init__(self, name: str, *, pool=None, stream: Optional["torch.cuda.Stream"] = None,
                 generator: Optional[torch.Generator] = None, graph=None):
        self.name = name
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        self.pool, self.stream, self.generator = pool, stream, generator
        self.out = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0

    def capture(self, body: Callable[[], torch.Tensor]) -> None:
        t0 = time.perf_counter()
        if self.generator is not None:
            self.graph.register_generator_state(self.generator)
        on_stream = (contextlib.nullcontext() if self.stream is None
                     else torch.cuda.stream(self.stream))
        try:
            with kernels.recording() as launches, on_stream:
                self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    self.out = body()
                finally:
                    self.graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"capturing the {self.name} chunk failed: {e}") from e
        self.launches = launches
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.out
