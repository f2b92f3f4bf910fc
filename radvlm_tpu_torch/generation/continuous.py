"""Continuous batching in PyTorch (counterpart of
`radvlm_tpu/generation/continuous.py`): slot-based, always-full decode over
one shared KV cache.

- The shared cache is the stacked [L, B, Smax, Hkv*D] layout (bf16, or int8
  with per-(token, kv-head) scales); a group of up to `fill_batch` queued
  requests of one prompt bucket prefills in one batch (vision tower +
  prompt) into a fresh cache, and each row is spliced WHOLE into its slot
  (cache row and segment row), erasing whatever the slot held;
- decode runs ALL slots in chunks of `steps_per_sync` steps with per-slot
  write indices and rope positions (per-row writes in
  `qwen2._block_cached`); inactive or finished slots keep computing, and
  correctness comes from discard + overwrite: readback emits each chunk's
  tokens to the requests that owned the slots when it was dispatched, and
  a refill splices over the slot;
- up to `pipeline_depth` chunks stay in flight. Each chunk's tokens (and
  each fill group's first tokens) are copied into pinned host memory on the
  stream, behind a CUDA event; `_process_chunk` waits on the oldest event
  only. Positions and write indices go up from pinned host buffers with
  `non_blocking=True`, so nothing in a chunk waits on the card.

A chunk is a Python loop of `engine.decode_step`s (the JAX `lax.scan`);
capturing it as a CUDA graph is later work. Not ported (they raise
NotImplementedError): speculative decoding and KV snapshots / multi-turn
resume (ROADMAP M7), a tensor-parallel mesh (ROADMAP M12), AOT precompile
(nothing to compile ahead in eager PyTorch).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.generation import engine
from radvlm_tpu_torch.generation.engine import GenerationConfig, sample_token_vec
from radvlm_tpu_torch.models import multimodal, qwen2, radvlm


class _HostCopy:
    """A device tensor copied to host memory without blocking: pinned
    memory and a CUDA event on the card, a plain copy on the CPU."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t.clone(), None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()  # waits for this copy (and what came before it) only
        return self.host.numpy()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device without waiting on the card (pinned staging)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _group_key(batch: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """Requests that can share one fill: the same padded prompt length and
    the same number of (padded) tiles, on which the merge plan's newline
    index depends."""
    return batch["tokens"].shape[1], batch["tiles"].shape[1]


def _concat_batches(batches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """One fill batch from same-key batches of one row each. Images of other
    sizes have merge plans of other lengths: the shorter ones are padded
    with zero rows, which no image position reads."""
    if len(batches) == 1:
        return batches[0]
    out = {}
    for k in batches[0]:
        parts = [b[k] for b in batches]
        if k in ("merge_indices", "merge_weights"):
            n = max(p.shape[1] for p in parts)
            parts = [torch.nn.functional.pad(p, (0, 0, 0, n - p.shape[1])) for p in parts]
        out[k] = torch.cat(parts)
    return out


@dataclasses.dataclass
class Request:
    uid: int
    sample: multimodal.MMSample
    max_new_tokens: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # First token (sampled from the prefill logits), still in flight as
    # (the fill group's host copy, row) until the next chunk readback.
    tok0: Optional[Tuple[_HostCopy, int]] = None
    # Pre-collated device batch + real (unpadded) length, built at submit().
    dev_batch: Optional[Dict[str, torch.Tensor]] = None
    real_len: int = 0
    # Set when the engine aborted while this request was in flight.
    error: Optional[str] = None
    # submit(stream=True): each emitted token, then a None sentinel.
    stream_q: Optional["queue.Queue"] = None
    # Cooperative early stop: the ENGINE thread frees the slot at readback.
    cancelled: bool = False
    # Per-request sampling params (None -> the engine GenerationConfig's).
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # Tokens covered by dispatched work (tok0 + K per chunk): at
    # max_new_tokens the slot is refilled eagerly.
    planned: int = 0


class ContinuousBatcher:
    """Always-full decode over `num_slots` concurrent sequences."""

    def __init__(
        self,
        model: radvlm.RadVLM,
        cfg: RadVLMConfig,
        gen: GenerationConfig,
        *,
        num_slots: int = 8,
        max_len: int = 8192,
        prompt_buckets: Sequence[int] = (1024, 2048, 4096),
        pad_tiles: int = 6,
        attn_impl: str = "auto",
        seed: int = 0,
        steps_per_sync: int = 8,
        pipeline_depth: int = 2,
        kv_quant: bool = False,
        fill_batch: int = 1,
        mesh: Optional[Any] = None,
        spec_k: int = 0,
    ):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported (ROADMAP M12)")
        if spec_k:
            raise NotImplementedError("speculative decoding is not ported (ROADMAP M7)")
        self.model, self.cfg, self.gen = model, cfg, gen
        self.device = model.device
        self.num_slots = num_slots
        # A 128 multiple, as in the JAX package (its decode kernels' shape).
        self.max_len = max_len = -(-max_len // 128) * 128
        self.prompt_buckets = sorted(prompt_buckets)
        self.pad_tiles = pad_tiles
        self.attn_impl = attn_impl
        self.steps_per_sync = max(1, steps_per_sync)
        self.pipeline_depth = max(0, pipeline_depth)
        self.kv_quant = bool(kv_quant)
        self.fill_batch = max(1, int(fill_batch))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        dev = self.device
        self.cache = (
            qwen2.init_kv_cache_q8(cfg.text, num_slots, max_len, device=dev)
            if self.kv_quant else qwen2.init_kv_cache(cfg.text, num_slots, max_len, device=dev)
        )
        self.cache_seg = torch.zeros((num_slots, max_len), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((num_slots,), dtype=torch.long, device=dev)
        self.slot_temp = torch.full((num_slots,), gen.temperature, dtype=torch.float32, device=dev)
        self.slot_top_p = torch.full((num_slots,), gen.top_p, dtype=torch.float32, device=dev)
        # Host slot state (counters; no per-step device readback).
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_len = np.zeros((num_slots,), np.int64)  # tokens in cache
        self.slot_real_len = np.zeros((num_slots,), np.int64)  # excl. left pad
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._uid = itertools.count(1)
        # Host wall-clock per run()-loop phase (cumulative seconds): readback
        # is the wait for the oldest in-flight chunk (device-bound time),
        # fill/dispatch the host's cost of queueing work; and counts of
        # filled requests, chunks read back and tokens emitted.
        self.host_stats = {
            "fill": 0.0, "dispatch": 0.0, "readback": 0.0, "emit": 0.0,
            "fills": 0, "chunks": 0, "tokens": 0,
        }
        self.warmup_timings: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def submit(self, sample: multimodal.MMSample, max_new_tokens: Optional[int] = None, *,
               temperature: Optional[float] = None, top_p: Optional[float] = None,
               stream: bool = False, keep_kv: bool = False, resume: Any = None) -> Request:
        """Queue a request; its batch is collated and sent to the device now
        (on the caller's thread). Raises ValueError for a prompt the cache
        cannot hold."""
        if keep_kv or resume is not None:
            raise NotImplementedError(
                "KV snapshots and multi-turn resume are not ported (ROADMAP M7)"
            )
        largest = self.prompt_buckets[-1]
        padded = largest if sample.length <= largest else -(-sample.length // 128) * 128
        if padded > self.max_len:
            raise ValueError(
                f"prompt pads to {padded} tokens but the cache holds "
                f"{self.max_len} — truncate the prompt or raise max_len"
            )
        if max_new_tokens is None:
            max_new_tokens = self.gen.max_new_tokens
        req = Request(
            uid=next(self._uid), sample=sample, max_new_tokens=max(1, int(max_new_tokens)),
            temperature=temperature, top_p=top_p,
            stream_q=queue.Queue() if stream else None,
        )
        host_batch = multimodal.collate(
            [sample], pad_len=self._bucket_for(sample.length), pad_tiles=self.pad_tiles,
            pad_to_multiple=128, left_pad=True,
        )
        req.real_len = int(host_batch["lengths"][0])
        req.dev_batch = {k: _to_device(v, self.device) for k, v in host_batch.items()}
        self.queue.put(req)
        return req

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _fill_group(self, pairs: List[Tuple[int, Request]]) -> None:
        """Fill len(pairs) slots with one prefill. All requests share one
        padded prompt length (run() groups them by bucket)."""
        batch = _concat_batches([req.dev_batch for _, req in pairs])
        l = batch["tokens"].shape[1]
        temps = [self.gen.temperature if r.temperature is None else r.temperature
                 for _, r in pairs]
        tops = [self.gen.top_p if r.top_p is None else r.top_p for _, r in pairs]
        dev = self.device
        temp_t = _to_device(np.asarray(temps, np.float32), dev)
        top_t = _to_device(np.asarray(tops, np.float32), dev)
        cache1, seg1, last_logits = engine.prefill(
            self.model, self.cfg, batch, self.max_len, attn_impl=self.attn_impl,
            cache_format="int8" if self.kv_quant else "bf16",
        )
        if max(temps) > 0.0:
            tok0 = sample_token_vec(last_logits, temp_t, top_t, self.generator,
                                    top_k=self.gen.top_k)
        else:  # an all-greedy group: the argmax sample_token_vec would pick
            tok0 = torch.argmax(last_logits, dim=-1)
        for j, (slot, _) in enumerate(pairs):
            # The whole row: erases anything the slot's last owner left.
            for shared, fresh in zip(self.cache, cache1):
                shared[:, slot] = fresh[:, j]
            self.cache_seg[slot] = seg1[j]
            self.cur_tok[slot] = tok0[j]
            self.slot_temp[slot] = temp_t[j]
            self.slot_top_p[slot] = top_t[j]
        tok0_host = _HostCopy(tok0)
        for j, (slot, req) in enumerate(pairs):
            # Emitting N tokens writes cache indices [l, l+N-2]: cap the
            # request so no write passes max_len.
            req.max_new_tokens = min(req.max_new_tokens, max(1, self.max_len - l + 1))
            self.slot_req[slot] = req
            req.planned = 1  # the prefill's tok0
            req.dev_batch = None  # release after fill
            self.slot_len[slot] = l  # prompt occupies [0, l) (left-padded)
            self.slot_real_len[slot] = req.real_len
            req.tok0 = (tok0_host, j)

    def _decode_chunk(self, positions: torch.Tensor, write_idx: torch.Tensor,
                      sampling: bool) -> torch.Tensor:
        """`steps_per_sync` decode steps of every slot, queued on the device
        without a host sync; returns the tokens [B, K]. The greedy variant
        is an argmax; the sampling one pays the per-row temperature/top-p
        sort."""
        toks = []
        tok = self.cur_tok
        for _ in range(self.steps_per_sync):
            self.cache, self.cache_seg, logits = engine.decode_step(
                self.model, self.cfg, self.cache, self.cache_seg, tok, positions, write_idx,
                attn_impl=self.attn_impl,
            )
            if sampling:
                tok = sample_token_vec(logits, self.slot_temp, self.slot_top_p,
                                       self.generator, top_k=self.gen.top_k)
            else:
                tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            positions = positions + 1
            write_idx = (write_idx + 1).clamp_(max=self.max_len - 1)
        self.cur_tok = tok
        return torch.stack(toks, dim=1)

    def _emit(self, slot: int, tok: int, req: Optional[Request] = None):
        # `req` is the dispatch-snapshot owner of `slot` (eager refill can
        # hand the slot to a NEW request while this one's tokens are still in
        # flight); None = current owner.
        if req is None:
            req = self.slot_req[slot]
        if req is None or req.done:
            return
        if req.cancelled or tok in self.gen.eos_token_ids:
            req.done = True
        else:
            req.emitted.append(tok)
            self.host_stats["tokens"] += 1
            if req.stream_q is not None:
                req.stream_q.put(tok)
            if len(req.emitted) >= req.max_new_tokens:
                req.done = True
        if req.done:
            if self.slot_req[slot] is req:  # eager refill may own it already
                self.slot_req[slot] = None
            if req.stream_q is not None:
                req.stream_q.put(None)  # end-of-stream sentinel

    def fail_all(self, error_msg: str, on_each=None) -> List[Request]:
        """Fail every in-flight and still-queued request explicitly (error +
        done + end-of-stream sentinel) and clear the slots: the crash
        recovery of the serving loop, so waiters never present truncated
        emissions as success."""
        failed = [r for r in self.slot_req if r is not None]
        self.slot_req = [None] * self.num_slots
        while True:
            try:
                failed.append(self.queue.get_nowait())
            except queue.Empty:
                break
        for req in failed:
            req.error = error_msg
            req.done = True
            if req.stream_q is not None:
                req.stream_q.put(None)
            if on_each is not None:
                on_each(req)
        return failed

    def _sampling_active(self) -> bool:
        for r in self.slot_req:
            if r is not None:
                t = self.gen.temperature if r.temperature is None else r.temperature
                if t > 0.0:
                    return True
        return False

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _dispatch_chunk(self, inflight, force_sampling: Optional[bool] = None) -> None:
        """Queue one K-step decode chunk on the device (no host sync). Host
        counters advance at once: they describe the state after the chunk."""
        sampling = self._sampling_active() if force_sampling is None else force_sampling
        positions = _to_device(np.minimum(self.slot_real_len, 2 ** 30), self.device)
        # Active slots never pass max_len (capped at fill); the stale index
        # of an inactive slot is clamped, its garbage discarded.
        write_idx = _to_device(np.minimum(self.slot_len, self.max_len - 1), self.device)
        toks = self._decode_chunk(positions, write_idx, sampling)
        self.slot_len += self.steps_per_sync
        self.slot_real_len += self.steps_per_sync
        # Readback emits to the SNAPSHOT's requests: a chunk dispatched before
        # a refill of the slot holds that request's tokens.
        snapshot = [(i, r) for i, r in enumerate(self.slot_req) if r is not None]
        # EAGER REFILL: once every remaining token of a request rides a
        # dispatched chunk, free the slot now instead of stranding it for
        # (pipeline_depth + 1) readbacks.
        for i, r in snapshot:
            r.planned += self.steps_per_sync
            if r.planned >= r.max_new_tokens and self.slot_req[i] is r:
                self.slot_req[i] = None
        inflight.append((_HostCopy(toks), snapshot))

    def _process_chunk(self, inflight, finished: List[Request]) -> None:
        """Read back the OLDEST in-flight chunk and emit its tokens."""
        toks_host, snapshot = inflight.popleft()
        t0 = time.perf_counter()
        toks = toks_host.numpy()  # waits for this chunk only
        tok0s: Dict[int, np.ndarray] = {}
        for _, req in snapshot:
            if req.tok0 is not None and not req.done:
                copy = req.tok0[0]
                if id(copy) not in tok0s:
                    tok0s[id(copy)] = copy.numpy()
        t1 = time.perf_counter()
        self.host_stats["readback"] += t1 - t0
        for slot, req in snapshot:
            if req.done:
                continue  # finished at an earlier readback
            if req.tok0 is not None:
                copy, row = req.tok0
                req.tok0 = None
                self._emit(slot, int(tok0s[id(copy)][row]), req)
            for t in toks[slot]:
                if req.done:
                    break
                self._emit(slot, int(t), req)
            if req.done:
                finished.append(req)
        self.host_stats["emit"] += time.perf_counter() - t1
        self.host_stats["chunks"] += 1

    @torch.inference_mode()
    def run(self) -> Iterator[Request]:
        """Process the queue to completion, yielding finished requests.

        Software-pipelined: up to `pipeline_depth` chunks stay in flight on
        the device while the host reads back and emits older ones. A slot
        whose request finishes mid-chunk decodes garbage until the readback
        catches it - wasted compute, never corrupt output."""
        inflight: "collections.deque" = collections.deque()
        finished: List[Request] = []
        while not self.queue.empty() or self._active() or inflight:
            empties = [i for i, r in enumerate(self.slot_req) if r is None]
            taken: List[Request] = []
            while len(taken) < len(empties) and not self.queue.empty():
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                if req.cancelled:  # cancelled while still queued: never fill
                    req.done = True
                    if req.stream_q is not None:
                        req.stream_q.put(None)
                    finished.append(req)
                    continue
                taken.append(req)
            if taken:
                t0 = time.perf_counter()
                by_shape: Dict[Tuple[int, int], List[Request]] = {}
                for req in taken:
                    by_shape.setdefault(_group_key(req.dev_batch), []).append(req)
                for reqs in by_shape.values():
                    for s in range(0, len(reqs), self.fill_batch):
                        self._fill_group([(empties.pop(0), r)
                                          for r in reqs[s:s + self.fill_batch]])
                self.host_stats["fill"] += time.perf_counter() - t0
                self.host_stats["fills"] += len(taken)
            if self._active():
                t0 = time.perf_counter()
                self._dispatch_chunk(inflight)
                self.host_stats["dispatch"] += time.perf_counter() - t0
            # Drain: one chunk per iteration in steady state (keeping
            # `pipeline_depth` queued), everything once idle.
            while inflight and (len(inflight) > self.pipeline_depth or not self._active()):
                self._process_chunk(inflight, finished)
            for r in finished:
                yield r
            finished = []

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every prompt bucket's fill at every group size 1..fill_batch
        and both decode-chunk variants once (first-call allocations and the
        kernel build happen here, not under a live request), then reset all
        slot state."""
        self.warmup_timings = {}
        nfills = range(1, min(self.fill_batch, self.num_slots) + 1)
        for bucket in self.prompt_buckets:
            for nf in nfills:
                reqs = []
                for _ in range(nf):
                    sample = multimodal.build_sample(list(range(2, 8)), [], self.cfg)
                    hb = multimodal.collate([sample], pad_len=bucket, pad_tiles=self.pad_tiles,
                                            pad_to_multiple=128, left_pad=True)
                    r = Request(uid=0, sample=sample, max_new_tokens=1,
                                real_len=int(hb["lengths"][0]))
                    r.dev_batch = {k: _to_device(v, self.device) for k, v in hb.items()}
                    reqs.append(r)
                t0 = time.perf_counter()
                self._fill_group(list(enumerate(reqs)))
                self._sync()
                self.warmup_timings[f"fill_{bucket}_x{nf}"] = time.perf_counter() - t0
        inflight: "collections.deque" = collections.deque()
        for name, sampling in (("decode_greedy", False), ("decode_sampling", True)):
            t0 = time.perf_counter()
            self._dispatch_chunk(inflight, force_sampling=sampling)
            self._process_chunk(inflight, [])
            self.warmup_timings[name] = time.perf_counter() - t0
        self.cache_seg.zero_()
        self.cur_tok.zero_()
        self.slot_len[:] = 0
        self.slot_real_len[:] = 0
        self.slot_req = [None] * self.num_slots

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def kernel_provenance(self) -> Dict[str, object]:
        """Which path each stage of this engine takes (the dispatch's own
        predicates, `engine.kernel_provenance`) at its largest bucket and
        fill group of `pad_tiles`-tile images, plus the launch counts so
        far."""
        return engine.kernel_provenance(
            self.cfg, prompt_len=self.prompt_buckets[-1],
            max_new_tokens=self.max_len - self.prompt_buckets[-1],
            attn_impl=self.attn_impl, quantized=engine.is_quantized(self.model),
            cache_format="int8" if self.kv_quant else "bf16",
            fill_rows=min(self.fill_batch, self.num_slots), tiles=self.pad_tiles,
            decode_rows=self.num_slots,
        )
