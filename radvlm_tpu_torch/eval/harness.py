"""Evaluation harness: batched VLM inference over task datasets + metrics
(counterpart of `radvlm_tpu/eval/harness.py`).

`VLMRunner` bundles a RadVLM module, its config and a tokenizer; the model
may hold int8 or int4 weights (`QLinear` / `Q4Linear`, from the weight
bridge, an artifact or `convert.random_quantized_params`). Serving wraps the
runner in `serve.worker.ModelWorker` or `serve.batch_worker.BatchWorker`.
`build_task_dataset` maps a task name to its dataset adapter and `run_task`
runs the adapter's samples through the continuous engine (or padded static
batches) and scores them with `eval.metrics`, writing the reference's
`{model}_{task}_output.json` / `{model}_{task}.json` files.

Under a `torch.distributed` world of more than one process (`eval/cli.py
--multihost` under torchrun) `run_task` splits the samples over the ranks by
the DistributedSampler contract (rank r takes i % n == r) and gathers the
results (`dist.all_gather_object`). A runner with a tensor-parallel `mesh`
makes each rank one rank of a TP engine (the ranks of one `tensor` group
take the same samples, submitted in lockstep); with `fleet=N` the continuous
engine is a `serve/fleet.py` FleetEngine. With `fleet=N, fleet_tp=T` > 1 the
world is N x T ranks, the runner shards the model over its engine's
`tensor` group, and `run_task` submits every sample on rank 0 through the
fleet's routing (`TPFleetEngine`) while the other ranks follow its ticks;
rank 0's cells are broadcast to every rank.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radvlm_tpu_torch.config import RadVLMConfig
from radvlm_tpu_torch.data.chat import QWEN_CHATML, ChatTemplate, render_generation_prompt
from radvlm_tpu_torch.data.datasets import CHEXPERT_PATHOLOGIES
from radvlm_tpu_torch.eval import metrics as metrics_lib
from radvlm_tpu_torch.generation.engine import (
    GenerationConfig,
    make_generate_fn,
    trim_at_stop_strings,
)
from radvlm_tpu_torch.models import multimodal, radvlm


class Tokenizer:
    """Protocol: encode/decode + special ids (tests and the smoke run use a
    byte-level one; production wraps an HF tokenizer)."""

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    eos_token_ids: Tuple[int, ...] = ()
    pad_token_id: int = 0


class HFTokenizer(Tokenizer):
    """An HF tokenizer directory behind the protocol. `transformers` is
    imported here, not with the module: a machine that serves with another
    tokenizer need not have it, and where it is missing this raises the
    ImportError."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        eos = [self.tok.eos_token_id]
        im_end = self.tok.convert_tokens_to_ids("<|im_end|>")
        if im_end is not None and im_end != self.tok.unk_token_id:
            eos.append(im_end)
        self.eos_token_ids = tuple(i for i in dict.fromkeys(eos) if i is not None)
        self.pad_token_id = self.tok.pad_token_id or 0

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """collate() output -> tensors on `device` (tiles stay uint8)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@dataclasses.dataclass
class VLMRunner:
    """Bundles a RadVLM module + config + tokenizer and runs batched greedy
    (or sampled) generation over left-padded prompt buckets."""

    model: radvlm.RadVLM
    cfg: RadVLMConfig
    tokenizer: Tokenizer
    template: ChatTemplate = QWEN_CHATML
    max_new_tokens: int = 512
    batch_size: int = 8
    pad_to_multiple: int = 512
    attn_impl: str = "auto"
    fuse: bool = True  # fuse qkv/gateup projections (radvlm.fuse_for_inference)
    # Tensor-parallel inference: a DeviceMesh (`parallel.mesh.make_mesh`)
    # whose `tensor` axis spans the model over ranks (parallel/tp.py). The
    # model is sharded in place here (unfused first, fused after slicing);
    # `cfg` stays the global config.
    mesh: Any = None
    kv_quant: Optional[bool] = None  # int8 KV cache of run_task (None -> RADVLM_KV_INT8)
    # Data-parallel engine fleet (serve/fleet.py): `fleet` continuous
    # engines, one per device of `fleet_devices` (None: every card; a device
    # may repeat), the reference's one-model-per-GPU eval processes folded
    # into one process. With `fleet_tp` > 1 each engine is a TP group of
    # `fleet_tp` ranks, one process a rank (a world of fleet x fleet_tp
    # processes; `fleet_mesh` is its mesh).
    fleet: Optional[int] = None
    fleet_tp: int = 1
    fleet_devices: Optional[Sequence[Any]] = None

    def __post_init__(self):
        if self.mesh is not None and self.fleet:
            raise ValueError("VLMRunner: a tensor-parallel mesh and a fleet are exclusive")
        if self.fleet_tp < 1:
            raise ValueError(f"VLMRunner: fleet_tp must be >= 1, got {self.fleet_tp}")
        if self.fleet_tp > 1 and not self.fleet:
            raise ValueError("VLMRunner: fleet_tp needs a fleet (fleet=N)")
        self._run_cfg, self._tp_group = self.cfg, None
        self.fleet_mesh = None
        mesh = self.mesh
        if self.fleet and self.fleet_tp > 1:
            from radvlm_tpu_torch.serve.fleet import tp_fleet_mesh

            mesh = self.fleet_mesh = tp_fleet_mesh(self.fleet, self.fleet_tp)
        if mesh is not None and mesh["tensor"].size() > 1:
            from radvlm_tpu_torch.parallel import tp

            self.model, self._run_cfg = tp.shard_model_tp(self.model, self.cfg, mesh)
            self._tp_group = mesh.get_group("tensor")
        if self.fuse:
            radvlm.fuse_for_inference(self.model, self.cfg)
        self._gen_fns: Dict[Tuple[int, ...], Callable] = {}
        self.generator = torch.Generator(device=self.model.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _gen_fn(self, gen: GenerationConfig):
        if gen not in self._gen_fns:
            self._gen_fns[gen] = make_generate_fn(self._run_cfg, gen, attn_impl=self.attn_impl)
        return self._gen_fns[gen]

    def build_prompt(self, question: str, history: Sequence[Tuple[str, str]] = ()) -> str:
        turns = list(history) + [("user", question)]
        return render_generation_prompt(turns, template=self.template)

    def generate_batch(
        self,
        prompts: Sequence[str],
        images_per_prompt: Sequence[Sequence[np.ndarray]],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
    ) -> List[str]:
        """prompts contain <image> markers; returns decoded, stop-trimmed text."""
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            eos_token_ids=tuple(self.tokenizer.eos_token_ids),
            pad_token_id=self.tokenizer.pad_token_id,
            temperature=temperature,
            top_p=top_p,
        )
        samples = [
            multimodal.build_sample(
                multimodal.tokenize_with_images(self.tokenizer.encode, p), imgs, self.cfg
            )
            for p, imgs in zip(prompts, images_per_prompt)
        ]
        # Pad the batch up to batch_size with copies of the last sample, so
        # every call has the same shape.
        n_real = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        batch = multimodal.collate(samples, pad_to_multiple=self.pad_to_multiple, left_pad=True)
        from radvlm_tpu_torch.parallel import tp

        with tp.active(self._tp_group):
            out = self._gen_fn(gen)(self.model, batch_to_device(batch, self.device),
                                    self.generator)
        toks = out["tokens"].cpu().numpy()
        nums = out["num_tokens"].cpu().numpy()
        texts = []
        for i in range(n_real):
            ids = [int(t) for t in toks[i, : nums[i]] if t not in gen.eos_token_ids]
            text = self.tokenizer.decode(ids)
            texts.append(trim_at_stop_strings(text, self.template.stop_strings))
        return texts


# ---------------------------------------------------------------------------
# Task registry (the reference's `evaluate_instructions.py:47-116`)
# ---------------------------------------------------------------------------


def build_task_dataset(task: str, data_dir: str, **overrides):
    """task name -> configured dataset adapter over the $DATA_DIR layout."""
    from radvlm_tpu_torch.data import datasets as ds

    d = data_dir
    if task == "report_generation":
        return ds.MIMICCXRDataset(
            os.path.join(d, "MIMIC-CXR-JPG"), split="test", only_frontal=True,
            filtered_reports_dir=overrides.get("filtered_reports_dir"),
            flag_img=True, flag_lab=False, **_rest(overrides, "filtered_reports_dir"),
        )
    if task == "abnormality_classification":
        return ds.MIMICCXRDataset(
            os.path.join(d, "MIMIC-CXR-JPG"), split="test", only_frontal=True,
            classif=True, **overrides,
        )
    if task == "abnormality_grounding":
        return ds.VinDrCXRSingleLabelDataset(
            os.path.join(d, "VinDr-CXR"), split="test", **overrides
        )
    if task == "abnormality_detection":
        return ds.VinDrCXRDataset(
            os.path.join(d, "VinDr-CXR"), split="test", **overrides
        )
    if task == "anatomical_grounding":
        return ds.ChestImaGenomeDataset(
            root=os.path.join(d, "MIMIC-CXR-JPG"),
            chestima_root=os.path.join(d, "CHEST_IMA"),
            split="test", pick_one_region=True, **overrides,
        )
    if task == "phrase_grounding":
        return ds.MSCXRDataset(
            root=os.path.join(d, "MIMIC-CXR-JPG"), split="test",
            sentences_bbox_dir=os.path.join(d, "MS-CXR", "sentences_and_BBox_mscxr"),
            **overrides,
        )
    raise ValueError(f"unknown task {task!r}")


def _rest(d, *drop):
    return {k: v for k, v in d.items() if k not in drop}


METRIC_TASK_ALIAS = {
    "anatomical_grounding": "region_grounding",
}


def _result_cell(output: str, s: Dict, task: str) -> Dict:
    """One per-sample results cell in the reference's serialization contract
    (`evaluate_instructions.py:182-190`): `output` (generated text), `instr`
    (the question string), `answer` (the ground-truth answer text), plus any
    of the reference's optional keys present on the sample."""
    instr = s.get("instr")
    if not isinstance(instr, dict) or "question" not in instr:
        # A sample with no instr would serialize instr/answer=null and poison
        # the metric joins downstream: fail, as an engine error does.
        raise ValueError(
            f"sample for task {task!r} has no instr dict with a question: "
            f"keys={sorted(s.keys())}"
        )
    cell = {
        "output": output,
        "instr": instr.get("question"),
        "answer": instr.get("answer"),
    }
    for key in ("id", "idx", "img_path", "labels", "label", "txt", "boxes"):
        if key in s:
            cell[key] = s[key]
    for f in GT_FIELDS[task]:
        cell.setdefault(f, s.get(f))
    return cell


GT_FIELDS = {
    "report_generation": ("txt",),
    "abnormality_classification": ("labels",),
    "abnormality_grounding": ("boxes", "label"),
    "abnormality_detection": ("boxes", "labels"),
    "anatomical_grounding": ("boxes", "label"),
    "phrase_grounding": ("boxes", "label"),
}


def _run_continuous(
    runner: VLMRunner, dataset, task: str, my_indices, progress,
    stats: Optional[Dict[str, Any]] = None,
) -> List[Dict]:
    """Continuous-batching inference: every sample streams through one
    slot-refilled `ContinuousBatcher` (no slot waits for the longest
    sequence of a batch), or a FleetEngine of `runner.fleet` of them.
    Results come in completion order."""
    from radvlm_tpu_torch.generation.continuous import ContinuousBatcher

    gen = GenerationConfig(
        max_new_tokens=runner.max_new_tokens,
        eos_token_ids=tuple(runner.tokenizer.eos_token_ids),
        pad_token_id=runner.tokenizer.pad_token_id,
    )

    def build_mm(i):
        s = dict(dataset[i])  # shallow copy: never mutate the adapter's dict
        prompt = runner.build_prompt("<image>\n" + s["instr"]["question"])
        img = s.pop("img")  # drop our reference to the raw pixels after tiling
        mm = multimodal.build_sample(
            multimodal.tokenize_with_images(runner.tokenizer.encode, prompt),
            [img], runner.cfg,
        )
        return s, mm

    # Pass 1 sizes the one prompt bucket: each sample is built and only its
    # length kept (holding a split's tiles would take O(dataset) host RAM).
    # A fleet of TP engines sizes on rank 0, its front, and sends the size.
    tp_fleet = runner.fleet_mesh is not None
    t0 = time.perf_counter()
    longest = 128
    if not tp_fleet or dist.get_rank() == 0:
        for i in my_indices:
            _, mm = build_mm(i)
            longest = max(longest, mm.length)
    if tp_fleet:
        box = [longest]
        dist.broadcast_object_list(box, src=0)
        longest = box[0]
    bucket = -(-longest // 128) * 128
    max_len = bucket + (-(-runner.max_new_tokens // 128) * 128)
    engine_kw = dict(num_slots=runner.batch_size, max_len=max_len, prompt_buckets=(bucket,),
                     attn_impl=runner.attn_impl, kv_quant=runner.kv_quant)
    n_engines = 1
    if runner.fleet:
        from radvlm_tpu_torch.serve.fleet import FleetEngine

        n_engines = runner.fleet
        if tp_fleet:
            engine_kw.update(tp_size=runner.fleet_tp, mesh=runner.fleet_mesh)
        else:
            engine_kw.update(devices=runner.fleet_devices)
        fleet = FleetEngine(runner.model, runner.cfg, gen, fleet_size=n_engines, **engine_kw)
        if tp_fleet and not fleet.is_front:
            # The samples go in on rank 0; this rank takes the ticks until
            # rank 0 shuts the fleet down, and receives the cells after.
            fleet.follow()
            return []
        fleet.start()
        submit, drain, first = fleet.submit, fleet.drain, fleet.batchers[0]
    else:
        fleet = None
        batcher = ContinuousBatcher(runner.model, runner.cfg, gen, mesh=runner.mesh, **engine_kw)
        submit, drain, first = batcher.submit, batcher.run, batcher
    sizing_s = time.perf_counter() - t0
    # Pass 2: samples are built and submitted under a bounded in-flight cap
    # (submit() sends a request's batch to the device at once).
    cap = max(4 * runner.batch_size * n_engines, 8)
    meta: Dict[int, Dict] = {}
    meta_lock = threading.Lock()
    results: List[Dict] = []
    build_s = [0.0]

    def submit_sample(i):
        t = time.perf_counter()
        s, mm = build_mm(i)
        build_s[0] += time.perf_counter() - t
        req = submit(mm)
        with meta_lock:
            meta[req.uid] = s

    def take(req, s):
        if req.error:
            # silently failed samples would corrupt the metrics
            raise RuntimeError(f"engine failed a sample: {req.error}")
        text = runner.tokenizer.decode(req.emitted)
        results.append(_result_cell(
            trim_at_stop_strings(text, runner.template.stop_strings), s, task))
        if progress:
            progress(len(results), len(my_indices))

    t0 = time.perf_counter()
    if fleet is None and runner._tp_group is not None:
        # The ranks of a TP engine must make the same host decisions, and a
        # feeder thread's submits would land at another point of run() on
        # each rank. So this thread submits `cap` samples, then one more at
        # each completion run() yields: every rank's queue changes at the
        # same point of its loop.
        todo = iter(my_indices)
        for i in itertools.islice(todo, cap):
            submit_sample(i)
        for req in drain():
            take(req, meta.pop(req.uid))
            for i in itertools.islice(todo, 1):
                submit_sample(i)
    else:
        # A feeder thread builds and submits while this thread drains the
        # engine, so host prep (PIL anyres) overlaps device time and the
        # slots stay full.
        inflight = threading.Semaphore(cap)
        stop_feed = threading.Event()
        feed_err: List[BaseException] = []

        def feed():
            try:
                for i in my_indices:
                    inflight.acquire()
                    if stop_feed.is_set():  # the consumer bailed: exit
                        return
                    submit_sample(i)
            except BaseException as e:  # re-raised by the consumer loop
                feed_err.append(e)

        feeder = threading.Thread(target=feed, name="eval-feeder", daemon=True)
        feeder.start()
        try:
            while len(results) < len(my_indices):
                if feed_err:
                    raise feed_err[0]
                progressed = False
                # run() returns when nothing is pending, which can happen
                # while the feeder prepares the next sample: enter it again.
                for req in drain():
                    progressed = True
                    # submit() returns before the feeder records
                    # meta[uid]: wait for the entry.
                    while True:
                        with meta_lock:
                            s = meta.pop(req.uid, None)
                        if s is not None:
                            break
                        time.sleep(0.001)
                    inflight.release()
                    take(req, s)
                if not progressed and len(results) < len(my_indices):
                    time.sleep(0.01)
            feeder.join()
        finally:
            # Unblock a feeder waiting on the cap after an error above (a
            # plain Semaphore takes the extra release); the flag makes it
            # exit.
            stop_feed.set()
            inflight.release()
            if fleet is not None:
                fleet.shutdown()
    if stats is not None:
        engines = fleet.batchers if fleet is not None else [batcher]
        host = {k: sum(b.host_stats[k] for b in engines) for k in first.host_stats}
        stats.update(
            sizing_s=sizing_s, build_s=build_s[0], engine_wall_s=time.perf_counter() - t0,
            bucket=bucket, max_len=max_len, kv_quant=first.kv_quant, engines=n_engines,
            host_stats=host, provenance=first.kernel_provenance(),
            graphs=[b.graph_stats() for b in engines],
        )
    return results


def _process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _tensor_coord(runner: VLMRunner) -> int:
    """This rank's place on the runner mesh's `tensor` axis (0 without one)."""
    return 0 if runner.mesh is None else runner.mesh.get_local_rank("tensor")


def _data_shard(runner: VLMRunner) -> Tuple[int, int]:
    """(index, count) of this rank's share of the samples. Without a mesh
    every rank is a share; with one, the ranks of one `tensor` group are one
    engine and take the same share (index = the rank's mesh coordinate
    without the tensor axis). A fleet of TP engines takes every sample on
    its front."""
    if _process_count() == 1 or runner.fleet_mesh is not None:
        return 0, 1
    if runner.mesh is None:
        return dist.get_rank(), dist.get_world_size()
    idx, count = 0, 1
    for ax, c, n in zip(runner.mesh.mesh_dim_names, runner.mesh.get_coordinate(),
                        runner.mesh.shape):
        if ax != "tensor":
            idx, count = idx * n + c, count * n
    return idx, count


def _allgather_objects(results: List[Dict], runner: VLMRunner) -> List[Dict]:
    """Every rank's result cells, in rank order, on every rank; of a TP
    group only the cells of its first rank (the others hold the same)."""
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (_tensor_coord(runner), results))
    return [cell for coord, cells in parts if coord == 0 for cell in cells]


def run_task(
    runner: VLMRunner,
    dataset,
    task: str,
    *,
    max_samples: Optional[int] = None,
    output_dir: Optional[str] = None,
    model_name: str = "radvlm",
    with_clinical: bool = True,
    engine: str = "continuous",  # "continuous" (slot-refilled) | "static" (padded batches)
    progress: Optional[Callable[[int, int], None]] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[List[Dict], Dict[str, float]]:
    """Run inference over `dataset` and compute task metrics. `stats`, when
    given, receives the continuous engine's host seconds (`sizing_s`: the
    bucket-sizing pass; `build_s`: the feeder's sample builds), its
    `host_stats`, `kernel_provenance()` and each engine's `graph_stats()`.

    Across processes each rank takes indices i with i % count == index (the
    DistributedSampler contract, `_data_shard`) and the results are
    gathered to every rank; rank 0 writes the files."""
    n = len(dataset)
    if max_samples is not None:
        n = min(n, max_samples)
    pidx, pcount = _data_shard(runner)
    my_indices = list(range(pidx, n, pcount))

    results: List[Dict] = []
    if engine == "continuous":
        results = _run_continuous(runner, dataset, task, my_indices, progress, stats)
    else:
        bs = runner.batch_size
        for start in range(0, len(my_indices), bs):
            chunk = my_indices[start:start + bs]
            samples = [dataset[i] for i in chunk]
            prompts = [
                runner.build_prompt("<image>\n" + s["instr"]["question"])
                for s in samples
            ]
            images = [[s["img"]] for s in samples]
            outputs = runner.generate_batch(prompts, images)
            for s, out in zip(samples, outputs):
                results.append(_result_cell(out, s, task))
            if progress:
                progress(min(start + bs, len(my_indices)), len(my_indices))

    if runner.fleet_mesh is not None:
        box = [results]
        dist.broadcast_object_list(box, src=0)  # rank 0's cells, every sample's
        results = box[0]
    elif _process_count() > 1:
        results = _allgather_objects(results, runner)

    metric_task = METRIC_TASK_ALIAS.get(task, task)
    metrics = metrics_lib.evaluate_results(
        metric_task,
        results,
        labels=[p.lower() for p in CHEXPERT_PATHOLOGIES],
        with_clinical=with_clinical,
    )

    if output_dir and (_process_count() == 1 or dist.get_rank() == 0):
        os.makedirs(output_dir, exist_ok=True)
        # The reference's file names (`evaluate_instructions.py:195-207`):
        # `{model}_{task}_output.json` the per-sample cells,
        # `{model}_{task}.json` the metrics dict.
        base = os.path.join(output_dir, f"{model_name}_{task}")
        with open(base + "_output.json", "w") as f:
            json.dump(results, f)
        with open(base + ".json", "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
    return results, metrics
