"""Training data pipeline: LLaVA-json dataset -> bucketed, prefetched batches
(counterpart of `radvlm_tpu/data/loader.py`; host-side numpy, so the epoch
plan and the batches equal the JAX loader's for the same seed). Static
bucket shapes keep the kernels' shapes few and let packed rows fill them:

- samples are length-estimated up front (text tokens + anyres image-token budget —
  the reference's `modality_lengths`) and grouped into LENGTH BUCKETS; each batch
  is drawn from one bucket and padded to the bucket's fixed (seq, tiles) shape;
- batches are assembled by a background thread pool (the reference uses 4 torch
  DataLoader workers per rank) with a bounded prefetch queue;
- the retry ladder for corrupt samples (`train.py:1101-1132`) becomes an explicit
  skip-with-log (deterministic, no hidden resampling);
- multi-host: each process keeps indices i % process_count == process_index.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from radvlm_tpu_torch.config import IGNORE_INDEX, RadVLMConfig, tokens_per_tile
from radvlm_tpu_torch.data.chat import (
    QWEN_CHATML,
    ChatTemplate,
    llava_turns,
    tokenize_chat_supervised,
)
from radvlm_tpu_torch.models import multimodal

log = logging.getLogger(__name__)


def load_image(path: str) -> np.ndarray:
    """JPEG/PNG -> uint8 [H, W, 3] RGB numpy.

    RADVLM_NATIVE_JPEG=1 routes .jpg/.jpeg through the C++ libjpeg decoder
    (`radvlm_tpu_torch/native`, outside the GIL in the prefetch pool); PIL
    is the default and serves other formats, decode errors and a host where
    the decoder does not build."""
    if os.environ.get("RADVLM_NATIVE_JPEG") == "1" and path.lower().endswith((".jpg", ".jpeg")):
        from radvlm_tpu_torch import native

        if native.jpeg_available():
            try:
                with open(path, "rb") as f:
                    return native.decode_jpeg(f.read())
            except (ValueError, OSError):
                pass  # PIL below
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


@dataclasses.dataclass
class LlavaJsonDataset:
    """LLaVA-json training cells + image root -> MMSamples.

    cells: list of {"image": rel path (optional), "conversations": [...]}.
    """

    cells: List[Dict[str, Any]]
    image_root: str
    cfg: RadVLMConfig
    tokenize_fn: Callable[[str], List[int]]
    template: ChatTemplate = QWEN_CHATML
    max_len: Optional[int] = None

    def __len__(self) -> int:
        return len(self.cells)

    def estimated_length(self, i: int) -> int:
        """Cheap length estimate for bucketing (reference `modality_lengths`,
        `train.py:1040-1058`): ~chars/4 text tokens + a fixed image budget."""
        cell = self.cells[i]
        text_chars = sum(len(c["value"]) for c in cell["conversations"])
        image = cell.get("image")
        # per-IMAGE budget: a multi-image cell bucketed as one image would
        # overflow its bucket and get hard-clipped (supervision silently lost)
        n_images = len(image) if isinstance(image, (list, tuple)) else (
            1 if image else 0
        )
        img_tokens = tokens_per_tile(self.cfg) * 5 * n_images
        return text_chars // 4 + img_tokens + 64

    def __getitem__(self, i: int) -> multimodal.MMSample:
        cell = self.cells[i]
        turns = llava_turns(cell["conversations"])
        ids, labels = tokenize_chat_supervised(
            self.tokenize_fn, turns, template=self.template
        )
        if self.max_len is not None and len(ids) > self.max_len:
            ids, labels = ids[: self.max_len], labels[: self.max_len]
        images = []
        if cell.get("image"):
            paths = cell["image"]
            if isinstance(paths, str):
                paths = [paths]
            images = [load_image(os.path.join(self.image_root, p)) for p in paths]
        n_sentinels = sum(1 for t in ids if t < 0)
        images = images[:n_sentinels]
        return multimodal.build_sample(ids, images, self.cfg, labels=labels)


def apply_pos_skipping(
    batch: Dict[str, np.ndarray], rng: np.random.Generator, max_range: int
) -> Dict[str, np.ndarray]:
    """Positional-skipping augmentation (reference `llava_arch.py:546-552`):
    per sample, pick a random split point and add `left_add` to positions
    before it and `right_add >= left_add` after it (both uniform in
    [0, max_range]) — teaching rotary embeddings to generalize across the
    long-context range without training on long sequences. Padding (segment
    id 0) keeps position 0."""
    positions = batch["positions"].copy()
    lengths = batch["lengths"]
    b = positions.shape[0]
    for i in range(b):
        n = int(lengths[i])
        if n < 2:
            continue
        split = int(rng.integers(1, n))
        left_add = int(rng.integers(0, max_range + 1))
        right_add = int(rng.integers(left_add, max_range + 1))
        row = positions[i]
        real = batch["segment_ids"][i] != 0
        positions[i] = np.where(
            real, row + np.where(row >= split, right_add, left_add), row
        )
    return {**batch, "positions": positions}


@dataclasses.dataclass(frozen=True)
class Bucket:
    max_len: int  # padded sequence length
    max_tiles: int


DEFAULT_BUCKETS = (
    Bucket(1024, 1),
    Bucket(2048, 5),
    Bucket(4096, 6),
    Bucket(6144, 10),
    Bucket(8192, 10),
)


def assign_buckets(
    lengths: Sequence[int], buckets: Sequence[Bucket]
) -> List[int]:
    """Index of the smallest bucket whose max_len fits each length (longest
    bucket absorbs overflow — samples get truncated at collate)."""
    out = []
    for l in lengths:
        for bi, b in enumerate(buckets):
            if l <= b.max_len:
                out.append(bi)
                break
        else:
            out.append(len(buckets) - 1)
    return out


def bucketed_batches(
    lengths: Sequence[int],
    batch_size: int,
    *,
    buckets: Sequence[Bucket] = DEFAULT_BUCKETS,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    drop_remainder: bool = True,
) -> List[Tuple[int, List[int]]]:
    """Deterministic epoch plan: [(bucket_idx, sample_indices)].

    Within a bucket, order is shuffled; batch order across buckets is shuffled
    too (the reference's LengthGroupedSampler megabatch shuffle,
    `llava_trainer.py:196-237`). Each process keeps every process_count-th batch.
    """
    rng = np.random.default_rng(seed)
    assignment = assign_buckets(lengths, buckets)
    per_bucket: Dict[int, List[int]] = {}
    for i, b in enumerate(assignment):
        per_bucket.setdefault(b, []).append(i)
    batches: List[Tuple[int, List[int]]] = []
    for b, idxs in sorted(per_bucket.items()):
        idxs = list(rng.permutation(idxs))
        end = len(idxs) - (len(idxs) % batch_size) if drop_remainder else len(idxs)
        for s in range(0, end, batch_size):
            batches.append((b, [int(x) for x in idxs[s:s + batch_size]]))
    order = rng.permutation(len(batches))
    batches = [batches[i] for i in order]
    # Every process MUST see the same number of batches: a sharded step runs
    # cross-host collectives, so unequal counts deadlock the job at epoch end.
    # Pad by wrapping (the reference DistributedSampler's repeat-to-even
    # semantics) before the strided shard.
    if process_count > 1 and len(batches) % process_count:
        pad = process_count - len(batches) % process_count
        # Wrap modularly: pad can exceed len(batches) (fewer batches than
        # processes on a tiny dataset), and `batches[:pad]` would under-pad,
        # leaving per-process counts unequal — a cross-host collective
        # deadlock at epoch end.
        batches = batches + [batches[i % len(batches)] for i in range(pad)]
    return batches[process_index::process_count]


class PrefetchLoader:
    """Background-assembled batch stream with fixed bucket shapes."""

    def __init__(
        self,
        dataset: LlavaJsonDataset,
        batch_size: int,
        *,
        buckets: Sequence[Bucket] = DEFAULT_BUCKETS,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        pos_skip_range: int = 0,
        pack_factor: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.pos_skip_range = pos_skip_range
        # pack_factor > 1: each batch row packs that many consecutive samples
        # (segment-id isolation; see multimodal.pack_samples) — fills bucket
        # rows with the mixture's short samples instead of padding.
        self.pack_factor = pack_factor
        self._pos_seed = seed ^ 0x9E3779B9
        self._lengths = [
            dataset.estimated_length(i) for i in range(len(dataset))
        ]

    def epoch_plan(self, epoch: int) -> List[Tuple[int, List[int]]]:
        return bucketed_batches(
            self._lengths,
            self.batch_size * self.pack_factor,
            buckets=self.buckets,
            seed=self.seed + epoch,
            process_index=self.process_index,
            process_count=self.process_count,
        )

    def _build(self, plan_entry: Tuple[int, List[int]]) -> Dict[str, np.ndarray]:
        b, idxs = plan_entry
        bucket = self.buckets[b]
        samples = []
        for i in idxs:
            try:
                s = self.dataset[i]
            except Exception as e:  # corrupt image / bad cell: skip, log
                log.warning("skipping sample %d: %s", i, e)
                continue
            samples.append(s)
        if not samples:
            raise RuntimeError(f"entire batch failed to load: {idxs}")
        if len(samples) < len(idxs):
            # Shape-only filler: duplicate the last good sample but strip its
            # supervision (labels all IGNORE) — a verbatim duplicate would
            # double that sample's gradient weight in the loss.
            filler = dataclasses.replace(
                samples[-1],
                labels=np.full_like(samples[-1].labels, IGNORE_INDEX),
            )
            while len(samples) < len(idxs):  # keep the batch shape static
                samples.append(filler)
        if self.pack_factor > 1:
            samples = self._pack_rows(samples, bucket)
        batch = multimodal.collate(
            samples,
            pad_len=bucket.max_len,
            pad_tiles=bucket.max_tiles,
            pad_to_multiple=128,
        )
        # Hard-clip overflow (longest-bucket absorbs) to the bucket shape.
        if batch["tokens"].shape[1] > bucket.max_len:
            for key in ("tokens", "img_src", "labels", "segment_ids", "positions"):
                batch[key] = batch[key][:, : bucket.max_len]
        if self.pos_skip_range > 0:
            # per-BATCH generator derived from the plan entry: _build runs on
            # pool threads and a shared np Generator is neither thread-safe
            # nor deterministic under varying completion order
            rng = np.random.default_rng((self._pos_seed, b, idxs[0]))
            batch = apply_pos_skipping(batch, rng, self.pos_skip_range)
        return batch

    def _pack_rows(self, samples, bucket: Bucket):
        """Length-aware packing into exactly batch_size rows (a blind
        fixed-stride packing would silently truncate packs whose combined
        length exceeds the bucket). Best-fit-decreasing over ACTUAL expanded
        lengths; each row is seeded with one sample so the batch shape stays
        static. Overflow that cannot fit anywhere is logged, not silent."""
        n_rows = max(len(samples) // self.pack_factor, 1)
        order = sorted(range(len(samples)),
                       key=lambda j: (-samples[j].length, j))
        groups = [[samples[j]] for j in order[:n_rows]]
        lens = [samples[j].length for j in order[:n_rows]]
        clipped = 0
        for j in order[n_rows:]:
            s = samples[j]
            fits = [r for r in range(n_rows)
                    if lens[r] + s.length <= bucket.max_len]
            if fits:
                r = max(fits, key=lambda r: lens[r])  # best fit: fullest row
            else:
                r = min(range(n_rows), key=lambda r: lens[r])
                clipped += lens[r] + s.length - bucket.max_len
            groups[r].append(s)
            lens[r] += s.length
        if clipped:
            log.warning(
                "packing overflow: %d tokens exceed bucket max_len=%d and "
                "will be clipped at collate", clipped, bucket.max_len,
            )
        return [multimodal.pack_samples(g) for g in groups]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.epoch(0)

    def epoch(self, epoch: int, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch's batches; `skip` fast-forwards past already-consumed
        batches at the PLAN level (mid-epoch resume — skipped batches are never
        built, the deterministic plan guarantees the remainder is identical)."""
        plan = self.epoch_plan(epoch)
        if skip:
            plan = plan[skip:]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """q.put that re-checks `stop` while the queue is full — a plain
            blocking put deadlocks the producer (and leaks the whole thread
            pool + queued batches) when the consumer abandons the epoch
            mid-stream (e.g. max_steps)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # Sliding window of outstanding builds (bounds memory: completed
            # batches only live in `q`, at most `prefetch` + window of them).
            window = self.num_workers + 2
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                pending = []
                it = iter(plan)
                for p in it:
                    pending.append(ex.submit(self._build, p))
                    if len(pending) < window:
                        continue
                    fut = pending.pop(0)
                    if stop.is_set():
                        return
                    try:
                        item = fut.result()
                    except Exception as e:
                        item = e
                    if not put_checked(item):
                        return
                for fut in pending:
                    if stop.is_set():
                        return
                    try:
                        item = fut.result()
                    except Exception as e:
                        item = e
                    if not put_checked(item):
                        return
            put_checked(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
