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

- with `spec_k` > 0 (speculative decoding, `generation/spec.py`) a greedy
  step verifies spec_k prompt-lookup drafts in one (spec_k + 1)-wide cached
  forward, whose attention is the K10 / K11 window kernel, and emits the
  accepted prefix + 1: the tokens are those of plain greedy decoding, the
  steps fewer. How far a slot advances is then known on the device only, so
  each slot's rope position, write index and token history live there
  (`dec_pos`, `dec_widx`, `tok_hist`) and a chunk returns, beside the
  tokens [B, K, spec_k + 1], how many of them each step emits [B, K];
- a request submitted with `keep_kv` leaves a `KVSnapshot` of its slot
  (prompt + reply KV, copied) when it completes; `submit(resume=snapshot)`
  fills a slot from it and prefills ONLY the new turn's tokens at the
  recorded offset (multi-turn chat: the vision tower and the old prompt do
  not run again).

A chunk is a Python loop of steps (the JAX `lax.scan`); capturing it as a
CUDA graph is later work. Not ported (they raise NotImplementedError): a
tensor-parallel mesh (ROADMAP M12); AOT precompile has nothing to compile
ahead in eager PyTorch.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.device import resolve as resolve_device
from radvlm_tpu_torch.generation import engine, spec
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
class KVSnapshot:
    """KV state of a finished request (prompt + reply) on the device, the
    unit of multi-turn reuse: `Request.keep_kv` produces one,
    `submit(resume=...)` consumes one.

    `widx` is the next free cache index: everything below it is the clean
    prompt + reply KV; what lies above (written by chunks that were in
    flight past the end) is clamped out at resume. `real_len` is the rope
    position of the next token (the cache is left-padded below
    `widx - real_len`)."""

    cache_rows: Tuple[torch.Tensor, ...]  # per component [L, 1, S, *]
    seg_row: torch.Tensor  # [1, S] int32 cache segment row
    widx: int  # next cache write index (clean-KV length)
    real_len: int  # rope position of the next token
    max_len: int  # cache geometry the snapshot was cut from
    kv_quant: bool
    hist_row: Optional[torch.Tensor] = None  # [1, S] token history (spec engines)
    # How many of the request's emitted ids the snapshot covers: all of
    # them, or one fewer when the last emitted token was never fed back
    # (its K/V is then not in the cache; possible at pipeline_depth=0).
    # Whoever stores conversation state pairs the snapshot with
    # ids[:n_reply] (`serve/batch_worker.py`).
    n_reply: int = 0

    def truncated(self, k: int) -> "KVSnapshot":
        """A snapshot covering `k` fewer trailing reply tokens. The device
        rows are shared: resume clamps segments and history at `widx`, so
        the KV above the shorter extent is never attended."""
        if k <= 0:
            return self
        if k > self.n_reply:
            raise ValueError(f"cannot drop {k} of {self.n_reply} reply tokens")
        return dataclasses.replace(
            self, widx=self.widx - k, real_len=self.real_len - k, n_reply=self.n_reply - k
        )

    def to_numpy(self) -> Dict[str, Any]:
        """The snapshot as host arrays and scalars, the exchange format with
        the JAX package's `KVSnapshot` (its field names, without `engine_idx`). numpy has no
        bf16: bf16 cache rows travel as their uint16 bit patterns."""

        def host(t: torch.Tensor) -> np.ndarray:
            if t.dtype == torch.bfloat16:
                return t.cpu().view(torch.int16).numpy().view(np.uint16)
            return t.cpu().numpy()

        out = dataclasses.asdict(dataclasses.replace(self, cache_rows=(), seg_row=None,
                                                     hist_row=None))
        out["cache_rows"] = tuple(host(c) for c in self.cache_rows)
        out["seg_row"] = host(self.seg_row)
        out["hist_row"] = None if self.hist_row is None else host(self.hist_row)
        return out

    @classmethod
    def from_numpy(cls, fields: Dict[str, Any], device=None) -> "KVSnapshot":
        """Inverse of `to_numpy` (uint16 cache rows are bf16 bit patterns):
        a snapshot cut by the JAX package, passed as numpy, resumes here, on
        `device` (None: the card)."""
        device = resolve_device(device)

        def dev(a) -> torch.Tensor:
            a = np.array(a)  # a writable copy: the arrays of a JAX snapshot are read-only
            if a.dtype == np.uint16:
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
            return torch.from_numpy(a).to(device)

        fields = dict(fields)
        fields.pop("engine_idx", None)  # the JAX package's fleet affinity: no fleet here
        fields["cache_rows"] = tuple(dev(c) for c in fields["cache_rows"])
        fields["seg_row"] = dev(fields["seg_row"]).to(torch.int32)
        if fields.get("hist_row") is not None:
            fields["hist_row"] = dev(fields["hist_row"]).to(torch.int32)
        return cls(**fields)


@dataclasses.dataclass
class Request:
    uid: int
    sample: multimodal.MMSample
    max_new_tokens: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Multi-turn KV reuse: keep_kv snapshots this slot's cache rows at
    # completion into `kv_snapshot`; `resume` makes the fill a DELTA prefill
    # on top of an earlier snapshot instead of a prefill of the whole prompt.
    keep_kv: bool = False
    kv_snapshot: Optional[KVSnapshot] = None
    resume: Optional[KVSnapshot] = None
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
    # max_new_tokens the slot is refilled eagerly (not in spec mode, where
    # the host cannot know, and not for keep_kv, whose snapshot is cut from
    # the slot at completion).
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
        spec_k: Optional[int] = None,  # None -> RADVLM_SPEC_K (default 0)
    ):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving is not ported (ROADMAP M12)")
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
        if spec_k is None:
            spec_k = int(os.environ.get("RADVLM_SPEC_K", "0"))
        self.spec_k = max(0, int(spec_k))
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
        # Spec-mode device state: rope position and cache write index of each
        # slot's current token, and the token history the prompt-lookup
        # proposer matches against (prompt text ids at fill, the model's
        # predictions as decoding advances; -1 at padding and image positions).
        if self.spec_k:
            self.dec_pos = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
            self.dec_widx = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
            self.tok_hist = torch.full((num_slots, max_len), -1, dtype=torch.int32, device=dev)
            self.spec_stats = {"verify_steps": 0, "emitted": 0}
        # Host slot state (counters; no per-step device readback).
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_len = np.zeros((num_slots,), np.int64)  # tokens in cache
        self.slot_real_len = np.zeros((num_slots,), np.int64)  # excl. left pad
        # Write index / rope position right AFTER each slot's fill: slot_len
        # runs ahead with every dispatched chunk, so the clean-KV extent of a
        # finished request is fill_len + len(emitted), which KVSnapshot records.
        self.slot_fill_len = np.zeros((num_slots,), np.int64)
        self.slot_fill_real = np.zeros((num_slots,), np.int64)
        self.resume_fills = 0  # delta prefills served
        self._chunks_in_flight = 0
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
               stream: bool = False, keep_kv: bool = False,
               resume: Optional[KVSnapshot] = None) -> Request:
        """Queue a request; its batch is collated and sent to the device now
        (on the caller's thread). With `resume`, `sample` holds ONLY the new
        turn's tokens and images. Raises ValueError for a prompt the cache
        cannot hold or a snapshot that does not fit this engine."""
        if resume is not None:
            if resume.max_len != self.max_len or resume.kv_quant != self.kv_quant:
                raise ValueError(
                    "snapshot geometry mismatch: snapshot is "
                    f"(max_len={resume.max_len}, int8={resume.kv_quant}), "
                    f"engine is (max_len={self.max_len}, int8={self.kv_quant})"
                )
            if self.spec_k and resume.hist_row is None:
                raise ValueError(
                    "resuming on a spec-decoding engine needs a snapshot cut "
                    "by a spec engine (hist_row missing)"
                )
            # The delta window writes cache [widx, widx + dl): all of the
            # padded window must fit.
            dl = self._delta_pad_len(sample)
            if resume.widx + dl > self.max_len:
                raise ValueError(
                    f"delta pads to {dl} tokens at cache offset {resume.widx} "
                    f"but the cache holds {self.max_len} — start a fresh "
                    "conversation (full prefill)"
                )
        else:
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
            keep_kv=keep_kv, resume=resume,
        )
        if resume is not None:
            host_batch = self._collate_delta(sample)
        else:
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

    @staticmethod
    def _delta_pad_len(sample: multimodal.MMSample) -> int:
        """Padded width of a resume delta: at least 128, a 128 multiple."""
        return max(128, -(-sample.length // 128) * 128)

    def _collate_delta(self, sample: multimodal.MMSample):
        """Right-padded batch of a resume delta (the window writes cache
        [widx, widx + dl): real tokens lead, padding trails)."""
        return multimodal.collate(
            [sample], pad_len=self._delta_pad_len(sample),
            pad_tiles=self.pad_tiles if (sample.img_src >= 0).any() else 1,
            pad_to_multiple=128, left_pad=False,
        )

    def _slot_params(self, pairs: List[Tuple[int, Request]]):
        """Per-request sampling parameters as device tensors, and the
        hottest temperature among them."""
        temps = [self.gen.temperature if r.temperature is None else r.temperature
                 for _, r in pairs]
        tops = [self.gen.top_p if r.top_p is None else r.top_p for _, r in pairs]
        return (_to_device(np.asarray(temps, np.float32), self.device),
                _to_device(np.asarray(tops, np.float32), self.device), max(temps))

    def _first_token(self, logits, temp_t, top_t, hottest: float) -> torch.Tensor:
        if hottest > 0.0:
            return sample_token_vec(logits, temp_t, top_t, self.generator, top_k=self.gen.top_k)
        return torch.argmax(logits, dim=-1)  # what sample_token_vec would pick

    def _fill_group(self, pairs: List[Tuple[int, Request]]) -> None:
        """Fill len(pairs) slots with one prefill. All requests share one
        padded prompt length (run() groups them by bucket); a resume is a
        group of its own."""
        if pairs[0][1].resume is not None:
            assert len(pairs) == 1
            self._resume_fill(*pairs[0])
            return
        batch = _concat_batches([req.dev_batch for _, req in pairs])
        l = batch["tokens"].shape[1]
        temp_t, top_t, hottest = self._slot_params(pairs)
        cache1, seg1, last_logits = engine.prefill(
            self.model, self.cfg, batch, self.max_len, attn_impl=self.attn_impl,
            cache_format="int8" if self.kv_quant else "bf16",
        )
        tok0 = self._first_token(last_logits, temp_t, top_t, hottest)
        if self.spec_k:
            # Reset the spec state of the filled slots: rope position = real
            # prompt length, write index = padded length (the prompt fills
            # cache [0, l), left-padded), history row = the prompt's text ids.
            hist_rows = spec.history_from_prompt(
                batch["tokens"], batch["segment_ids"], batch["img_src"], self.max_len)
            real_t = _to_device(np.asarray([r.real_len for _, r in pairs], np.int32), self.device)
            l_t = _to_device(np.full((len(pairs),), l, np.int32), self.device)
        for j, (slot, _) in enumerate(pairs):
            # The whole row: erases anything the slot's last owner left.
            for shared, fresh in zip(self.cache, cache1):
                shared[:, slot] = fresh[:, j]
            self.cache_seg[slot] = seg1[j]
            if self.spec_k:
                self.tok_hist[slot] = hist_rows[j]
                self.dec_pos[slot] = real_t[j]
                self.dec_widx[slot] = l_t[j]
        self._own_slots(pairs, tok0, temp_t, top_t, [(l, r.real_len) for _, r in pairs])

    def _own_slots(self, pairs, tok0, temp_t, top_t, ends) -> None:
        """Hand the filled slots to their requests: current token and
        sampling parameters on the device, counters on the host. `ends` is
        each slot's (next write index, next rope position)."""
        tok0_host = _HostCopy(tok0)
        for j, ((slot, req), (end, real_end)) in enumerate(zip(pairs, ends)):
            self.cur_tok[slot] = tok0[j]
            self.slot_temp[slot] = temp_t[j]
            self.slot_top_p[slot] = top_t[j]
            # Emitting N tokens writes cache indices [end, end+N-2]: cap the
            # request so no write passes max_len. Spec mode keeps spec_k more
            # free: a verify window spans [widx, widx + spec_k].
            req.max_new_tokens = min(req.max_new_tokens,
                                     max(1, self.max_len - end + 1 - self.spec_k))
            self.slot_req[slot] = req
            req.planned = 1  # the fill's tok0
            req.dev_batch = None  # release after fill
            self.slot_len[slot] = self.slot_fill_len[slot] = end
            self.slot_real_len[slot] = self.slot_fill_real[slot] = real_end
            req.tok0 = (tok0_host, j)

    def _resume_fill(self, slot: int, req: Request) -> None:
        """Fill `slot` by delta prefill on req.resume: copy the snapshot's KV
        rows into the slot, run the new turn's tokens as one per-row window
        at the recorded offset (`qwen2._block_cached`, s > 1; plain
        attention with a per-row query offset: a delta is padded to 128 or
        more, wider than K10 / K11 take), and pick the first reply token at
        the delta's last real position. The snapshot itself is only read:
        whoever holds it may resume from it again."""
        snap, batch, real = req.resume, req.dev_batch, req.real_len
        widx, prefix_real = snap.widx, snap.real_len
        dev = self.device
        ar = torch.arange(self.max_len, device=dev)[None]  # [1, S]
        # The snapshot's segment row up to its clean extent (chunks in flight
        # past the end set bits above widx), then the delta's REAL positions;
        # its right padding stays 0, so neither the window's own queries nor
        # later decode steps attend what the padding writes.
        in_delta = (ar >= widx) & (ar < widx + real)
        seg1 = torch.where(ar < widx, snap.seg_row, torch.zeros_like(snap.seg_row))
        seg1 = torch.where(in_delta, torch.ones_like(seg1), seg1)
        for shared, row in zip(self.cache, snap.cache_rows):
            shared[:, slot] = row[:, 0]
        slot_cache = tuple(c[:, slot:slot + 1] for c in self.cache)  # views: written in place
        kw = dict(
            kv_cache=slot_cache,
            cache_index=torch.full((1,), widx, dtype=torch.int32, device=dev),
            cache_segment_ids=seg1, attn_impl=self.attn_impl, return_hidden=True,
        )
        # collate(left_pad=False) numbered the delta 0..n-1; the conversation
        # goes on at prefix_real (padding gets rope of no consequence).
        positions = batch["positions"] + prefix_real
        if (req.sample.img_src >= 0).any():
            hidden, _ = radvlm.forward(self.model, self.cfg, dict(batch, positions=positions), **kw)
        else:  # a text-only turn: the vision tower does not run
            hidden, _ = qwen2.forward(
                self.model.text, self.cfg.text,
                input_embeds=qwen2.embed_tokens(self.model.text, batch["tokens"], self.cfg.text),
                positions=positions, segment_ids=batch["segment_ids"], **kw,
            )
        logits = qwen2.unembed(self.model.text, self.cfg.text, hidden[:, real - 1])
        temp_t, top_t, hottest = self._slot_params([(slot, req)])
        tok0 = self._first_token(logits, temp_t, top_t, hottest)
        self.cache_seg[slot] = seg1[0]
        if self.spec_k:
            # The slot's history: the snapshot's row (clamped like the
            # segments), then the delta's text ids at their cache positions.
            dl = batch["tokens"].shape[1]
            delta_hist = spec.history_from_prompt(
                batch["tokens"], batch["segment_ids"], batch["img_src"], dl)
            hist_row = torch.where(ar < widx, snap.hist_row, torch.full_like(snap.hist_row, -1))
            hist_row = torch.where(in_delta, delta_hist.gather(1, (ar - widx).clamp(0, dl - 1)),
                                   hist_row)
            self.tok_hist[slot] = hist_row[0]
            self.dec_pos[slot] = prefix_real + real
            self.dec_widx[slot] = widx + real
        self._own_slots([(slot, req)], tok0, temp_t, top_t, [(widx + real, prefix_real + real)])
        self.resume_fills += 1

    def _take_snapshot(self, slot: int, req: Request) -> None:
        """Copy the finished request's slot into req.kv_snapshot (on the
        engine thread at emission; the copies queue behind the chunks in
        flight, no sync). A copy, never a view: later chunks go on writing
        into the slot and a refill splices over it.

        The cache holds the prompt and every FED token, and tokens are fed
        in emission order, so [0, fill_len + n) is exactly prompt + n reply
        tokens even while chunks in flight write above it. A token's K/V is
        written when it is fed, the step after it was produced: a last
        emitted token that no later chunk fed is left out and recorded in
        `n_reply` (it rides the next turn's delta). Plain mode counts the
        dispatched decode writes exactly; spec mode advances on the device,
        so it asks whether a later chunk was already dispatched."""
        n = len(req.emitted)
        if self.spec_k:
            if self._chunks_in_flight == 0 and n > 0:
                n -= 1
        else:
            n = min(n, max(0, int(self.slot_len[slot] - self.slot_fill_len[slot])))
        req.kv_snapshot = KVSnapshot(
            cache_rows=tuple(c[:, slot:slot + 1].clone() for c in self.cache),
            seg_row=self.cache_seg[slot:slot + 1].clone(),
            widx=int(self.slot_fill_len[slot]) + n,
            real_len=int(self.slot_fill_real[slot]) + n,
            max_len=self.max_len, kv_quant=self.kv_quant,
            hist_row=self.tok_hist[slot:slot + 1].clone() if self.spec_k else None,
            n_reply=n,
        )

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

    def _decode_chunk_spec(self, sampling: bool) -> torch.Tensor:
        """A spec-mode chunk, queued without a host sync. The greedy variant
        verifies spec_k prompt-lookup drafts per step in one (spec_k + 1)-wide
        cached forward; the sampling variant is the plain one-token step.
        Both carry the per-slot (position, write index, history) state on the
        device. Returns int32 [B, K, spec_k + 2]: per step the spec_k + 1
        greedy predictions, then how many of them the step emits (accepted +
        1; always 1 when sampling)."""
        sk, max_len, b = self.spec_k, self.max_len, self.num_slots
        dev = self.device
        rows = torch.arange(b, device=dev)
        span = torch.arange(sk + 1, device=dev)
        tok, pos, widx, hist = self.cur_tok, self.dec_pos, self.dec_widx, self.tok_hist
        out = []
        for _ in range(self.steps_per_sync):
            if sampling:
                wc = widx.clamp(max=max_len - 1)
                hist[rows, wc.long()] = tok.to(torch.int32)
                self.cache, self.cache_seg, logits = engine.decode_step(
                    self.model, self.cfg, self.cache, self.cache_seg, tok, pos, wc,
                    attn_impl=self.attn_impl,
                )
                tok = sample_token_vec(logits, self.slot_temp, self.slot_top_p,
                                       self.generator, top_k=self.gen.top_k)
                step = torch.zeros((b, sk + 2), dtype=torch.int32, device=dev)
                step[:, 0] = tok
                step[:, -1] = 1
                pos, widx = pos + 1, (widx + 1).clamp(max=max_len - 1)
            else:
                # Clamped so that the whole window fits the cache. It never
                # binds for an active slot (max_new keeps spec_k free at fill
                # time); a finished slot decodes garbage that the refill's
                # splice of cache, segments and history erases.
                wc = widx.clamp(max=max_len - 1 - sk)
                spec.write_history(hist, wc, tok[:, None])
                draft = spec.propose_ngram(hist, wc, sk)
                # A draft read from an unwritten history entry is -1: it can
                # match no prediction, and is embedded as id 0.
                window = torch.cat([tok[:, None], draft.long().clamp_min(0)], dim=1)
                idxw = (rows[:, None], wc.long()[:, None] + span[None])
                self.cache_seg.index_put_(idxw, self.cache_seg.new_ones(()))
                logits, _ = qwen2.forward(
                    self.model.text, self.cfg.text,
                    input_embeds=qwen2.embed_tokens(self.model.text, window, self.cfg.text),
                    positions=pos[:, None] + span[None],
                    segment_ids=torch.ones((b, sk + 1), dtype=torch.int32, device=dev),
                    kv_cache=self.cache, cache_index=wc, cache_segment_ids=self.cache_seg,
                    attn_impl=self.attn_impl,
                )
                pred, n_emit, nxt = spec.greedy_accept(logits, draft)
                # The history takes the model's own predictions: the accepted
                # prefix is the true stream, the tail stale but harmless
                # draft material for later lookups.
                spec.write_history(hist, wc + 1, pred[:, :sk])
                # Segment ids past the accepted prefix are cleared: the
                # single-token paths (the sampling variant, K9 / K4) mask by
                # segment only, and a stale 1 would admit garbage K/V.
                self.cache_seg.index_put_(
                    idxw, (span[None] < n_emit[:, None]).to(self.cache_seg.dtype))
                step = torch.cat([pred, n_emit[:, None]], dim=1)
                tok, pos, widx = nxt.long(), pos + n_emit, wc + n_emit
            out.append(step)
        self.cur_tok, self.dec_pos, self.dec_widx = tok, pos, widx
        return torch.stack(out, dim=1)

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
            if req.keep_kv and req.error is None:
                # Before the slot is freed (a refill splices over the rows). A
                # cancelled stream snapshots too: prompt + what was emitted is
                # a valid prefix for the next turn. keep_kv requests are never
                # refilled eagerly, so the slot still holds their rows.
                self._take_snapshot(slot, req)
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
        if self.spec_k:
            # Positions and write indices live on the device in spec mode.
            toks = self._decode_chunk_spec(sampling)
        else:
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
        if not self.spec_k:
            # EAGER REFILL: once every remaining token of a request rides a
            # dispatched chunk, free the slot now instead of stranding it for
            # (pipeline_depth + 1) readbacks. Not for keep_kv (its snapshot is
            # cut from the slot at completion) and not in spec mode (how many
            # tokens a chunk covers depends on the data).
            for i, r in snapshot:
                r.planned += self.steps_per_sync
                if (not r.keep_kv and r.planned >= r.max_new_tokens
                        and self.slot_req[i] is r):
                    self.slot_req[i] = None
        inflight.append((_HostCopy(toks), snapshot))

    def _process_chunk(self, inflight, finished: List[Request]) -> None:
        """Read back the OLDEST in-flight chunk and emit its tokens."""
        toks_host, snapshot = inflight.popleft()
        # Chunks dispatched AFTER this one: in spec mode _take_snapshot's sign
        # that the last emitted token was fed.
        self._chunks_in_flight = len(inflight)
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
            if not self.spec_k:
                for t in toks[slot]:
                    if req.done:
                        break
                    self._emit(slot, int(t), req)
            else:
                # toks [B, K, spec_k + 2]: a step emits the first n of its
                # predictions (accepted prefix + 1), n in the last column.
                for step in toks[slot]:
                    if req.done:
                        break
                    self.spec_stats["verify_steps"] += 1
                    before = len(req.emitted)
                    for t in step[:int(step[-1])]:
                        if req.done:
                            break
                        self._emit(slot, int(t), req)
                    # what was really emitted (eos or max_new can cut a window)
                    self.spec_stats["emitted"] += len(req.emitted) - before
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
                by_shape: Dict[Tuple, List[Request]] = {}
                for req in taken:
                    # a delta prefill is always a fill of its own
                    key = (("resume", req.uid) if req.resume is not None
                           else _group_key(req.dev_batch))
                    by_shape.setdefault(key, []).append(req)
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
        self.cur_tok = torch.zeros_like(self.cur_tok)
        if self.spec_k:
            self.dec_pos = torch.zeros_like(self.dec_pos)
            self.dec_widx = torch.zeros_like(self.dec_widx)
            self.tok_hist.fill_(-1)
            self.spec_stats = {"verify_steps": 0, "emitted": 0}
        for counters in (self.slot_len, self.slot_real_len, self.slot_fill_len,
                         self.slot_fill_real):
            counters[:] = 0
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
            weight_bits=engine.weight_bits(self.model),
            cache_format="int8" if self.kv_quant else "bf16",
            fill_rows=min(self.fill_batch, self.num_slots), tiles=self.pad_tiles,
            decode_rows=self.num_slots, spec_k=self.spec_k,
        )
