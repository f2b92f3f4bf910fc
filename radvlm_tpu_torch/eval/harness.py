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

One process evaluates on one card. Sharding a run across processes (the
JAX package's `jax.process_index` split and allgather) and engine fleets
are not ported (ROADMAP M12): a `mesh`, a `fleet`, or a `torch.distributed`
group of more than one process raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    # The JAX runner's tensor-parallel mesh and engine fleet (ROADMAP M12):
    # only the defaults are accepted.
    mesh: Any = None
    kv_quant: Optional[bool] = None  # int8 KV cache of run_task (None -> RADVLM_KV_INT8)
    fleet: Optional[int] = None
    fleet_tp: int = 1

    def __post_init__(self):
        if self.mesh is not None or self.fleet or self.fleet_tp != 1:
            raise NotImplementedError(
                "VLMRunner: a tensor-parallel mesh and engine fleets are not ported "
                "(ROADMAP M12)")
        if self.fuse:
            radvlm.fuse_for_inference(self.model, self.cfg)
        self._gen_fns: Dict[Tuple[int, ...], Callable] = {}
        self.generator = torch.Generator(device=self.model.device).manual_seed(0)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _gen_fn(self, gen: GenerationConfig):
        if gen not in self._gen_fns:
            self._gen_fns[gen] = make_generate_fn(self.cfg, gen, attn_impl=self.attn_impl)
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
        out = self._gen_fn(gen)(self.model, batch_to_device(batch, self.device), self.generator)
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
    sequence of a batch). Results come in completion order."""
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
    t0 = time.perf_counter()
    longest = 128
    for i in my_indices:
        _, mm = build_mm(i)
        longest = max(longest, mm.length)
    bucket = -(-longest // 128) * 128
    max_len = bucket + (-(-runner.max_new_tokens // 128) * 128)
    batcher = ContinuousBatcher(
        runner.model, runner.cfg, gen,
        num_slots=runner.batch_size,
        max_len=max_len,
        prompt_buckets=(bucket,),
        attn_impl=runner.attn_impl,
        kv_quant=runner.kv_quant,
    )
    sizing_s = time.perf_counter() - t0
    # Pass 2: a feeder thread builds and submits samples under a bounded
    # in-flight cap (submit() sends a request's batch to the device at once)
    # while this thread drains the engine, so host prep (PIL anyres) overlaps
    # device time and the slots stay full.
    cap = max(4 * runner.batch_size, 8)
    inflight = threading.Semaphore(cap)
    stop_feed = threading.Event()
    meta: Dict[int, Dict] = {}
    meta_lock = threading.Lock()
    results: List[Dict] = []
    feed_err: List[BaseException] = []
    build_s = [0.0]

    def feed():
        try:
            for i in my_indices:
                inflight.acquire()
                if stop_feed.is_set():  # the consumer bailed: exit
                    return
                t = time.perf_counter()
                s, mm = build_mm(i)
                build_s[0] += time.perf_counter() - t
                req = batcher.submit(mm)
                with meta_lock:
                    meta[req.uid] = s
        except BaseException as e:  # re-raised by the consumer loop
            feed_err.append(e)

    t0 = time.perf_counter()
    feeder = threading.Thread(target=feed, name="eval-feeder", daemon=True)
    feeder.start()
    try:
        while len(results) < len(my_indices):
            if feed_err:
                raise feed_err[0]
            progressed = False
            # run() returns when nothing is pending, which can happen while
            # the feeder prepares the next sample: enter it again.
            for req in batcher.run():
                progressed = True
                if req.error:
                    # silently failed samples would corrupt the metrics
                    raise RuntimeError(f"engine failed a sample: {req.error}")
                # submit() returns before the feeder records meta[uid]:
                # wait for the entry.
                while True:
                    with meta_lock:
                        s = meta.pop(req.uid, None)
                    if s is not None:
                        break
                    time.sleep(0.001)
                inflight.release()
                text = runner.tokenizer.decode(req.emitted)
                results.append(_result_cell(
                    trim_at_stop_strings(text, runner.template.stop_strings), s, task))
                if progress:
                    progress(len(results), len(my_indices))
            if not progressed and len(results) < len(my_indices):
                time.sleep(0.01)
        feeder.join()
    finally:
        # Unblock a feeder waiting on the cap after an error above (a plain
        # Semaphore takes the extra release); the flag makes it exit.
        stop_feed.set()
        inflight.release()
    if stats is not None:
        stats.update(
            sizing_s=sizing_s, build_s=build_s[0], engine_wall_s=time.perf_counter() - t0,
            bucket=bucket, max_len=max_len, kv_quant=batcher.kv_quant,
            host_stats=dict(batcher.host_stats), provenance=batcher.kernel_provenance(),
        )
    return results


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
    `host_stats` and `kernel_provenance()`."""
    if _process_count() > 1:
        raise NotImplementedError(
            "run_task across processes (sharding and gathering results) is not "
            "ported (ROADMAP M12)")
    n = len(dataset)
    if max_samples is not None:
        n = min(n, max_samples)
    my_indices = list(range(n))

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

    metric_task = METRIC_TASK_ALIAS.get(task, task)
    metrics = metrics_lib.evaluate_results(
        metric_task,
        results,
        labels=[p.lower() for p in CHEXPERT_PATHOLOGIES],
        with_clinical=with_clinical,
    )

    if output_dir:
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
