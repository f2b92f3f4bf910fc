"""Device-fleet serving: one continuous engine per device behind one
submit() (counterpart of `radvlm_tpu/serve/fleet.py`).

The reference serves one model instance per GPU, each a worker process
registered with the controller, and evaluates data-parallel with one model
per GPU process. Here one process owns N engines: each device of `devices`
gets a `ContinuousBatcher` and a dispatch thread, and requests route to the
least-loaded engine. A device may repeat: engines on one device share its
copy of the model (the weights are only read) and each has its own KV cache
and slots; that is how one card runs a fleet of two.

Failure isolation matches the reference's worker-expiry contract: an engine
whose dispatch loop raises fails ITS in-flight and queued requests
explicitly (never a silent empty success); after QUARANTINE_AFTER
consecutive failures it leaves the routing rotation (a request-free broken
engine would otherwise always look least-loaded and swallow all new
traffic), and it rejoins once it completes work again.

A fleet of tensor-parallel engines (`tp_size` > 1) needs a process group per
engine inside one process; it is not ported (ROADMAP M12).
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from radvlm_tpu_torch.generation.continuous import ContinuousBatcher, Request
from radvlm_tpu_torch.generation.engine import GenerationConfig

log = logging.getLogger(__name__)

# consecutive dispatch-loop failures before an engine leaves the rotation
QUARANTINE_AFTER = 3


def default_devices(model) -> List[torch.device]:
    """Every CUDA card for a model on the card; the model's device otherwise."""
    if model.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [model.device]


def replica(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """A copy of `model` whose parameters and buffers are on `device`, made
    without a second copy on the source device."""
    memo: Dict[int, Any] = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        moved = t.detach().to(device)
        memo[id(t)] = (torch.nn.Parameter(moved, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else moved)
    return copy.deepcopy(model, memo)


class FleetEngine:
    """N continuous batchers + N dispatch threads behind one submit()."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Any,
        gen: GenerationConfig,
        *,
        fleet_size: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        tp_size: int = 1,
        on_complete: Optional[Callable[[Request], None]] = None,
        **batcher_kw: Any,
    ):
        if tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {tp_size}")
        if tp_size > 1:
            raise NotImplementedError(
                "a fleet of tensor-parallel engines (tp_size > 1) needs a process group per "
                "engine inside one process; it is not ported (ROADMAP M12)")
        devices = [torch.device(d) for d in (devices if devices is not None
                                             else default_devices(model))]
        if fleet_size is not None:
            # Validate rather than silently slicing short: a host of 4 cards
            # asked for a fleet of 8 would build 4 engines while the caller
            # sizes its waves and reports results for 8.
            need = fleet_size * tp_size
            if len(devices) < need:
                raise ValueError(
                    f"fleet {fleet_size} x tp {tp_size} needs {need} devices, "
                    f"have {len(devices)}"
                )
            devices = devices[:need]
        self.tp_size = tp_size
        models = {str(model.device): model}
        self.batchers: List[ContinuousBatcher] = []
        for dev in devices:
            if str(dev) not in models:
                models[str(dev)] = replica(model, dev)
            self.batchers.append(ContinuousBatcher(models[str(dev)], cfg, gen, **batcher_kw))
        # One uid stream across the fleet: every batcher starts its own
        # counter at 1, and completion tracking is keyed by uid.
        shared_uids = itertools.count(1)
        for i, b in enumerate(self.batchers):
            b._uid = shared_uids
            # KVSnapshot.engine_idx: a conversation's KV rows live in THIS
            # engine's cache, so resumed turns must route back to it.
            b._fleet_idx = i
        self._on_complete = on_complete
        self._done: "queue.Queue[Request]" = queue.Queue()
        # Outstanding-request COUNT, raised before the enqueue (see submit):
        # a uid set filled after b.submit() would race the dispatch thread.
        self._pending_n = 0
        self._errors = [0] * len(self.batchers)  # consecutive failures
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # (engine idx, t_enter, t_exit) per PRODUCTIVE run() call: whether
        # the engines' busy windows overlap (a serialised fleet would pass
        # token-parity checks while scaling negatively). Idle spins are not
        # recorded; bounded so a long-running fleet does not grow it.
        self.busy_log: "collections.deque[tuple]" = collections.deque(maxlen=4096)

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Warm every engine concurrently (each builds its own first-call
        state; device waits release the GIL)."""
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(self.batchers)) as pool:
            for f in [pool.submit(b.warmup) for b in self.batchers]:
                f.result()

    def start(self) -> "FleetEngine":
        """Spawn one dispatch thread per engine."""
        if self._threads:
            return self
        for i, b in enumerate(self.batchers):
            t = threading.Thread(target=self._loop, args=(i, b), daemon=True,
                                 name=f"fleet-engine-{i}")
            t.start()
            self._threads.append(t)
        return self

    def _loop(self, idx: int, b: ContinuousBatcher) -> None:
        backoff = 0.0
        while not self._stop.is_set():
            progressed = False
            t_enter = time.monotonic()
            try:
                for req in b.run():
                    progressed = True
                    self._complete(req)
                if progressed:
                    self.busy_log.append((idx, t_enter, time.monotonic()))
                backoff = 0.0
                if progressed and self._errors[idx]:
                    self._errors[idx] = 0  # completed real work: healthy again
            except Exception as e:  # an engine crash must not kill the fleet
                # capped exponential backoff: a persistently broken engine
                # must not spin a core or log a traceback every few ms
                backoff = min(max(backoff * 2, 0.05), 2.0)
                self._errors[idx] += 1
                log.exception("fleet engine %d error (%d consecutive); retrying in %.2fs",
                              idx, self._errors[idx], backoff)
                b.fail_all(f"engine {idx} error: {e}", on_each=self._complete)
            if not progressed:
                time.sleep(backoff or 0.002)

    def _complete(self, req: Request) -> None:
        # Deliver BEFORE decrementing: drain() exits on "nothing pending and
        # done-queue empty", so the opposite order could drop the final
        # request.
        if self._on_complete is not None:
            self._on_complete(req)
        else:
            self._done.put(req)
        with self._lock:
            self._pending_n -= 1

    # ------------------------------------------------------------------
    def _load(self, i: int) -> float:
        if self._errors[i] >= QUARANTINE_AFTER:
            return float("inf")  # out of rotation until it completes work
        b = self.batchers[i]
        return b.queue.qsize() + len(b._active())

    def submit(self, sample, max_new_tokens=None, **kw) -> Request:
        """Route to the least-loaded healthy engine (the controller's
        shortest-queue policy, inside the process). A resumed conversation
        (kw["resume"], a KVSnapshot) goes to the engine that cut the
        snapshot: its KV rows live there."""
        resume = kw.get("resume")
        if resume is not None:
            i = resume.engine_idx
            if not 0 <= i < len(self.batchers):
                raise ValueError(f"snapshot of engine {i}; this fleet has {len(self.batchers)}")
            if self._errors[i] >= QUARANTINE_AFTER:
                raise RuntimeError(
                    f"fleet engine {i} holding this conversation's KV is "
                    "quarantined — start a fresh conversation"
                )
        else:
            loads = [self._load(i) for i in range(len(self.batchers))]
            i = min(range(len(loads)), key=loads.__getitem__)
            if loads[i] == float("inf"):
                raise RuntimeError(
                    f"all {len(self.batchers)} fleet engines are quarantined "
                    f"({QUARANTINE_AFTER}+ consecutive failures each)"
                )
        with self._lock:
            self._pending_n += 1
        try:
            return self.batchers[i].submit(sample, max_new_tokens=max_new_tokens, **kw)
        except BaseException:
            with self._lock:
                self._pending_n -= 1
            raise

    def queue_length(self) -> int:
        return sum(b.queue.qsize() + len(b._active()) for b in self.batchers)

    def drain(self, idle_timeout: float = 1800.0) -> Iterator[Request]:
        """Yield completed requests until none are pending (evaluation; only
        with on_complete None, after start()). `idle_timeout` bounds the wait
        since the LAST completion, not the whole drain."""
        deadline = time.time() + idle_timeout
        while True:
            with self._lock:
                n_pending = self._pending_n
            if n_pending == 0 and self._done.empty():
                return
            try:
                # a short poll once nothing is pending (a just-delivered
                # request's count clears moments after its put)
                wait = 0.05 if n_pending == 0 else 1.0
                req = self._done.get(timeout=max(0.01, min(wait, deadline - time.time())))
            except queue.Empty:
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"fleet drain made no progress for {idle_timeout}s "
                        f"with {n_pending} pending"
                    )
                continue
            deadline = time.time() + idle_timeout
            yield req

    def shutdown(self, join_timeout: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=join_timeout)
