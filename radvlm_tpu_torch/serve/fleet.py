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

A fleet of tensor-parallel engines (`tp_size` > 1, `TPFleetEngine`) runs
one process a rank, as `parallel/tp.py` does, where the JAX module runs one
process over a submesh per engine with a dispatch thread each. The world is
`fleet_size x tp_size` ranks under the mesh {"data": fleet_size, "tensor":
tp_size}: engine e is the ranks at data coordinate e, each rank a
`ContinuousBatcher(mesh=)` over its engine's `tensor` group. Global rank 0
is the front: only it takes `submit`, routes by the same rule (least load,
quarantined engines out, one uid stream) and completes the requests, which
feeds `drain`, `on_complete` and streaming. The ranks move in lockstep
ticks over a gloo control group of the whole world (never a TP group, whose
collectives would pair with others of other shapes): rank 0 broadcasts the
submits routed, the cancellations and the stop flag decided since the last
tick; every rank takes its engine's submits in that order and runs one
`step()` of its batcher; the engines' tensor-rank 0s gather that tick's
tokens, completions and errors to rank 0. So the ranks of one engine make
the same host decisions at the same step (a feeder thread would not:
"collective mismatch"). The other ranks run `follow()` until the stop flag.

A host-side failure of an engine's step (the same on each of its ranks)
fails that engine's requests and counts toward its quarantine, as above. A
rank that dies or diverges inside a TP collective cannot be isolated: the
control group's collectives then fail or time out (`CONTROL_TIMEOUT_S`),
rank 0 fails every open request and records the error (`fatal`), and the
world stops with an error instead of hanging.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import datetime
import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from radvlm_tpu_torch.generation.continuous import ContinuousBatcher, Request
from radvlm_tpu_torch.generation.engine import GenerationConfig

log = logging.getLogger(__name__)

# consecutive dispatch-loop failures before an engine leaves the rotation
QUARANTINE_AFTER = 3
# How long a rank of a fleet of TP engines waits in a control collective
# (a tick's broadcast or gather) before the world stops with an error.
CONTROL_TIMEOUT_S = 300.0


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
    """N continuous batchers + N dispatch threads behind one submit();
    with `tp_size` > 1, a `TPFleetEngine`."""

    def __new__(cls, *args, tp_size: int = 1, **kw):
        if cls is FleetEngine and tp_size > 1:
            return super().__new__(TPFleetEngine)
        return super().__new__(cls)

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


def check_tp_fleet_world(fleet_size: Optional[int], tp_size: int) -> int:
    """The number of engines of a fleet of TP engines over this world
    (fleet_size None: the world over tp_size). Raises naming torchrun
    where the world is not fleet_size x tp_size processes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    engines = fleet_size if fleet_size is not None else max(1, world // tp_size)
    if world != engines * tp_size:
        raise ValueError(
            f"a fleet of {engines} engines of tp {tp_size} runs one process a rank, "
            f"a world of {engines * tp_size}; this world has {world}: start the ranks "
            "with torchrun or call parallel.mesh.init_distributed first")
    return engines


def tp_fleet_mesh(fleet_size: Optional[int], tp_size: int):
    """The mesh {"data": fleet_size, "tensor": tp_size} of a fleet of TP
    engines over the world's ranks (`check_tp_fleet_world`)."""
    from radvlm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"data": check_tp_fleet_world(fleet_size, tp_size), "tensor": tp_size})


class TPFleetEngine(FleetEngine):
    """`fleet_size` TP engines of `tp_size` ranks, one process a rank, in
    lockstep ticks (module docstring). Every rank builds it with the same
    arguments and the same UNFUSED model (each engine shards its own copy);
    rank 0 submits, the others `follow()`. `batchers` holds this rank's own
    engine; `engine_idx` is its place in the fleet."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Any,
        gen: GenerationConfig,
        *,
        fleet_size: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        tp_size: int,
        on_complete: Optional[Callable[[Request], None]] = None,
        mesh: Any = None,  # the fleet's mesh, if the caller made it (tp_fleet_mesh)
        **batcher_kw: Any,
    ):
        if devices is not None:
            raise ValueError("a fleet of TP engines runs each rank on its model's device; "
                             "it takes no devices")
        self.mesh = mesh if mesh is not None else tp_fleet_mesh(fleet_size, tp_size)
        self.tp_size = tp_size
        self.num_engines = self.mesh["data"].size()
        self.engine_idx = self.mesh.get_local_rank("data")
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.is_front = self.rank == 0
        # The engine's first rank reports its news (every rank has the same).
        self._reports = self.mesh.get_local_rank("tensor") == 0
        self._ctrl = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
        b = ContinuousBatcher(model, cfg, gen, mesh=self.mesh, **batcher_kw)
        b._fleet_idx = self.engine_idx
        self.batchers = [b]
        self._on_complete = on_complete
        self._done: "queue.Queue[Request]" = queue.Queue()
        self._pending_n = 0
        self._errors = [0] * self.num_engines
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.busy_log: "collections.deque[tuple]" = collections.deque(maxlen=4096)
        self.fatal: Optional[BaseException] = None
        # Front (rank 0): one uid stream, the requests routed since the last
        # tick, and the caller's Request of each open uid, fed from the news.
        self._uids = itertools.count(1)
        self._outbox: List[tuple] = []
        self._open: Dict[int, tuple] = {}  # uid -> (its Request, its engine)
        self._cancel_sent: set = set()
        self._load_of = [0] * self.num_engines  # requests routed and not completed
        self.routed = [0] * self.num_engines  # requests routed to each engine
        # Every rank: its engine's requests by uid, and the tokens of each
        # already reported to the front.
        self._mine: Dict[int, Request] = {}
        self._reported: Dict[int, int] = {}
        # Seconds in the tick's two control collectives and in step().
        self.tick_stats = {"ticks": 0, "busy_ticks": 0, "control_s": 0.0,
                           "busy_control_s": 0.0, "step_s": 0.0}

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Every rank warms its own engine (the engine's ranks together)."""
        self.batchers[0].warmup()

    def start(self) -> "TPFleetEngine":
        """On rank 0, start the tick loop's thread; a no-op elsewhere (the
        other ranks call `follow`)."""
        if self.is_front and not self._threads:
            t = threading.Thread(target=self._front_loop, daemon=True, name="fleet-front")
            t.start()
            self._threads.append(t)
        return self

    def follow(self) -> None:
        """A rank other than 0: take the ticks until the stop flag."""
        if self.is_front:
            raise RuntimeError("rank 0 is the fleet's front: it submits, it does not follow")
        while True:
            msg = [None]
            t0 = time.perf_counter()
            dist.broadcast_object_list(msg, src=0, group=self._ctrl)
            wait = time.perf_counter() - t0
            if self._tick(*msg[0], wait):
                return

    def _front_loop(self) -> None:
        if self.batchers[0].device.type == "cuda":
            torch.cuda.set_device(self.batchers[0].device)
        idle = 0.0
        try:
            while True:
                with self._lock:
                    submits, self._outbox = self._outbox, []
                    cancels = [uid for uid, (r, _) in self._open.items()
                               if r.cancelled and uid not in self._cancel_sent]
                    self._cancel_sent.update(cancels)
                    stop = self._stop.is_set()
                msg = [(submits, cancels, stop)]
                t0 = time.perf_counter()
                dist.broadcast_object_list(msg, src=0, group=self._ctrl)
                if self._tick(submits, cancels, stop, time.perf_counter() - t0):
                    break
                with self._lock:
                    busy = bool(submits) or any(self._load_of)
                # Idle ticks back off to 20 ms; work resets the wait.
                idle = 0.0 if busy else min(0.02, max(0.002, 2 * idle))
                if idle:
                    time.sleep(idle)
        except BaseException as e:  # the lockstep is broken: every open request fails
            self.fatal = e
            log.exception("fleet of TP engines: a control collective failed; the world stops")
            self._fail_open(f"the fleet stopped: {e}")
            return
        self._fail_open("the fleet shut down")

    def _fail_open(self, error: str) -> None:
        with self._lock:
            open_reqs = [r for r, _ in self._open.values()]
            self._open.clear()
            self._load_of = [0] * self.num_engines
        for r in open_reqs:
            self._finish(r, error)

    def _tick(self, submits, cancels, stop: bool, wait_s: float) -> bool:
        """One tick on this rank: its engine's submits, the cancellations,
        one step; then the news gathered to rank 0. Returns the stop flag."""
        news = None
        t_enter = time.monotonic()
        t0 = time.perf_counter()
        busy = False
        if not stop:
            b = self.batchers[0]
            refused = []
            for e, uid, sample, kw in submits:
                if e != self.engine_idx:
                    continue
                try:
                    req = b.submit(sample, **kw)
                except Exception as ex:  # the same on every rank of the engine
                    refused.append((uid, f"engine {e}: {ex}"))
                    continue
                req.uid = uid
                self._mine[uid] = req
                self._reported[uid] = 0
            for uid in cancels:
                if uid in self._mine:
                    self._mine[uid].cancelled = True
            busy = bool(self._mine)
            failed, finished = False, []
            try:
                finished = b.step()
            except Exception as ex:  # a host-side failure: this engine's requests fail
                failed = True
                log.exception("fleet engine %d error", self.engine_idx)
                b.fail_all(f"engine {self.engine_idx} error: {ex}")
                b.drop_inflight()
            items = []
            for uid, r in list(self._mine.items()):
                new = r.emitted[self._reported[uid]:]
                if new or r.done:
                    items.append((uid, list(new), r.done, r.error))
                    self._reported[uid] = len(r.emitted)
                if r.done:
                    del self._mine[uid], self._reported[uid]
            if self._reports:
                news = (self.engine_idx, items, refused, failed, bool(finished), t_enter,
                        time.monotonic())
        step_s = time.perf_counter() - t0
        gathered = [None] * self.world if self.is_front else None
        t1 = time.perf_counter()
        dist.gather_object(news, gathered, dst=0, group=self._ctrl)
        control = wait_s + time.perf_counter() - t1
        st = self.tick_stats
        st["ticks"] += 1
        st["control_s"] += control
        st["step_s"] += step_s
        if busy:
            st["busy_ticks"] += 1
            st["busy_control_s"] += control
        if self.is_front:
            self._absorb(gathered)
        return stop

    def _absorb(self, gathered) -> None:
        """Rank 0: feed the news into the callers' Requests."""
        for news in gathered:
            if news is None:
                continue
            e, items, refused, failed, progressed, t_enter, t_exit = news
            if failed:
                self._errors[e] += 1
            elif progressed and self._errors[e]:
                self._errors[e] = 0  # completed real work: healthy again
            if progressed:
                self.busy_log.append((e, t_enter, t_exit))
            for uid, err in refused:
                self._close(uid, err)
            for uid, new, done, err in items:
                with self._lock:
                    r = self._open[uid][0]
                for t in new:
                    r.emitted.append(t)
                    if r.stream_q is not None:
                        r.stream_q.put(t)
                if done:
                    self._close(uid, err)

    def _close(self, uid: int, error: Optional[str]) -> None:
        with self._lock:
            r, e = self._open.pop(uid)
            self._load_of[e] -= 1
            self._cancel_sent.discard(uid)
        self._finish(r, error)

    def _finish(self, r: Request, error: Optional[str]) -> None:
        r.error = error
        r.done = True
        if r.stream_q is not None:
            r.stream_q.put(None)
        self._complete(r)

    # ------------------------------------------------------------------
    def _load(self, i: int) -> float:
        if self._errors[i] >= QUARANTINE_AFTER:
            return float("inf")
        return self._load_of[i]

    def submit(self, sample, max_new_tokens=None, **kw) -> Request:
        """Rank 0: check the request on its own engine (every engine has
        the same geometry), route it to the least-loaded healthy engine and
        send it with the next tick. The Request returned is the caller's:
        the front fills its tokens, `done` and `error` from the news, and
        setting its `cancelled` cancels it on the engine at the next tick."""
        if not self.is_front:
            raise RuntimeError(f"rank {self.rank} follows: only rank 0 submits to the fleet")
        if self.fatal is not None:
            raise RuntimeError(f"the fleet stopped: {self.fatal}")
        resume = kw.get("resume")
        self.batchers[0].check_request(sample, resume)  # raises on a resume (TP)
        loads = [self._load(i) for i in range(self.num_engines)]
        i = min(range(len(loads)), key=loads.__getitem__)
        if loads[i] == float("inf"):
            raise RuntimeError(
                f"all {self.num_engines} fleet engines are quarantined "
                f"({QUARANTINE_AFTER}+ consecutive failures each)"
            )
        if max_new_tokens is None:
            max_new_tokens = self.batchers[0].gen.max_new_tokens
        engine_kw = dict(max_new_tokens=max_new_tokens, temperature=kw.get("temperature"),
                         top_p=kw.get("top_p"), keep_kv=kw.get("keep_kv", False))
        with self._lock:
            uid = next(self._uids)
            req = Request(uid=uid, sample=None, max_new_tokens=max(1, int(max_new_tokens)),
                          temperature=engine_kw["temperature"], top_p=engine_kw["top_p"],
                          stream_q=queue.Queue() if kw.get("stream") else None,
                          keep_kv=engine_kw["keep_kv"])
            self._open[uid] = (req, i)
            self._load_of[i] += 1
            self.routed[i] += 1
            self._pending_n += 1
            self._outbox.append((i, uid, sample, engine_kw))
        return req

    def queue_length(self) -> int:
        return sum(self._load_of)

    def wait(self) -> None:
        """Rank 0: block until the tick loop ends (a shutdown, or the
        failure recorded in `fatal`, which this re-raises)."""
        for t in self._threads:
            t.join()
        if self.fatal is not None:
            raise RuntimeError("the fleet of TP engines stopped") from self.fatal

    def shutdown(self, join_timeout: float = 30.0) -> None:
        """Rank 0: send the stop flag (the other ranks' `follow` returns)
        and end the tick loop. A no-op on the other ranks."""
        if not self.is_front or self._stop.is_set():
            return
        self._stop.set()
        if self._threads:
            for t in self._threads:
                t.join(timeout=join_timeout)
        elif self.fatal is None:
            # never started: one tick carries the stop flag
            msg = [([], [], True)]
            dist.broadcast_object_list(msg, src=0, group=self._ctrl)
            self._tick([], [], True, 0.0)
            self._fail_open("the fleet shut down")
