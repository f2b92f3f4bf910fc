#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`radvlm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one Hopper card (sm_90a) and nvcc

Phases, each raising on failure (the last line is printed only on success):

1. device: a CUDA card; its name and power limit as nvidia-smi reports them;
2. build: the hand-written kernels from `radvlm_tpu_torch/csrc` (one nvcc
   per source, in parallel), timed;
3. kernels: K1 (tower attention), K2 (prefill attention), K9 (decode
   attention), K3 (W8A8 matmul), K4 (int8-cache decode attention), K5/K6
   (int8-weight decode matmul at 8, 32 and 40 rows, each shape's share of
   its byte bound and the sums of a decode step), K10 / K11 (the verify
   window of speculative decoding over the bf16 / int8 cache, 5 and 16
   queries a slot; K4 and K11 with their shares of the byte bound and of
   the f32 FMA floor), K12 (int4-weight decode matmul, 8 and 40 rows, each
   shape's share of its byte bound, gateup beside K5/K6's; a row's result
   must not depend on the row count, and 64 one-hot rows must give 64
   dequantized weights bit for bit) and K13 (W8A8 matmul that quantizes
   its rows inside; bit for bit equal to quantize_rows + K3) and the
   training kernels (K2 writing its lse, K7, K8: see phase 8) against their
   plain PyTorch versions on the card at the main paths' shapes: error (K3
   and K13 bit for bit; K3 at every W8A8 shape of a fill and a tower pass,
   each with its bound and its library call) and both times (CUDA events, median of several
   runs; for the skinny decode matmuls K5/K6 and K12 also the kernels' own
   time on the device by torch.profiler, since their wrappers' host time
   exceeds it; where the profiler traces no device, by events around calls
   queued behind a busy card); beside them the least time the card could take (bytes over 3.35
   TB/s or operations over the tensor-core peak, whichever is larger) and,
   as a yardstick that no path uses, the one PyTorch call that computes
   the same function where there is one (SDPA for K1, K2, K9 and K10,
   torch._int_mm plus the scale pass for K3 and, after quantize_rows, for
   K13, torch._weight_int8pack_mm for K5/K6; none over the int8 cache and
   none for K12: torch._weight_int4pack_mm takes bf16 scales and zero
   points in its own layout and does not round the weight after its
   scale, another function);
4. bf16 slice: radvlm_7b at full width with random bf16 weights made on the
   card from --seed. A reference check first (on one small input, the
   kernel path and plain attention in bf16 against plain attention on an f32
   copy of the weights), then the measured run with the launch counts reset:
   the port's ModelWorker serves 3 chatml requests with one synthetic
   CXR-sized image each over localhost HTTP (greedy, 32 new tokens) plus a
   repeat of the first, and VLMRunner.generate_batch runs one left-padded
   batch of 2. K1, K2 and K9 must have launched in that run. Then prefill
   alone is timed, and one prefill and the 32 decode steps of a batch of 2
   are timed unprofiled and then under torch.profiler, which breaks the
   device time down by kernel;
5. int8 continuous path: radvlm_7b at full width and depth with weights
   born int8 on the card from --seed (`convert.random_quantized_params`). A
   reference check first (prefill and first-decode logits of the int8
   kernel path against an f32 copy of the dequantized weights with plain
   attention), then a BatchWorker (ContinuousBatcher, int8 KV cache, 8
   slots, buckets 3072/3456/3840/4096, 32-step chunks, 4 in flight, fill
   groups of 2) warmed up and serving over localhost HTTP, launch counts
   reset: 12 concurrent chatml requests with CXR-sized images (2 streamed),
   then 3 single requests one at a time and a repeat of one, which must give
   the same tokens. K1, K2, K3, K4 and K5/K6 must have launched in that run.
   Then, with every slot filled, one greedy decode chunk runs under
   torch.cuda.set_sync_debug_mode("error") (no host sync hides in it), one
   is timed and one is profiled;
6. speculative decoding and sessions, on the int8 model of phase 5: a
   BatchWorker over ContinuousBatcher(spec_k=4, 8 slots, int8 KV cache)
   serves 6 concurrent greedy requests whose tokens must be those phase 5's
   plain engine gave for the same requests (a difference fails the run
   unless the plain path's own top-2 logit gap at the first differing step
   is under 1e-2), one sampling request, and a two-turn chat over
   /v1/chat/completions with a session_id whose second turn must be a delta
   prefill (resume_fills == 1) giving the text of a full prefill of the same
   conversation; a delta fill and a full fill are timed, and one verify
   chunk runs under set_sync_debug_mode("error") and one is timed. Then the
   same with the bf16 KV cache and 3 requests, against a plain bf16-cache
   engine. K11 and K4, then K10 and K9, must have launched;
7. the pre-quantized artifact, radvlm_7b at full width and depth: an int4
   (W4A16) model born unfused on the card (`random_quantized_params(bits=4,
   fuse=False)`) is written by `quant_io.save_quantized` into a directory
   under build/ (size and seconds printed), `worker_cli.build_worker` loads
   it and builds the continuous engine of phase 5 (8 slots, int8 KV cache,
   the same buckets), and every loaded tensor must equal the saved model's
   bit for bit. A reference check (logits against an f32 copy of the
   dequantized weights), then 6 concurrent greedy requests and 2 single
   ones (and a repeat) over HTTP. K12 must have launched (112 a decode
   step), K6 for the lm_head and K3 for the tower's fc2. A decode chunk is
   timed and profiled against phase 5's int8 chunk, and one request through
   a spec_k=4 engine must give the plain engine's tokens. The directory is
   deleted;
7b. fused W8A8 on the int8 model of phase 5: with RADVLM_W8A8_IMPL=fused,
   3 greedy requests must give phase 5's tokens exactly (K13 is bit-equal
   to quantize_rows + K3) with K13 launched and K3 not, and a fill group of
   2 prompts is timed through K3 and through K13 in turns;
8. SFT, the training path: radvlm_0_5b at full width and depth, f32 master
   weights made on the card from --seed, every part tunable, remat on. Phase
   3 first holds the training kernels to their plain versions at the three
   shapes training gives them (the 0.5B and the 7B decoder at 4096 tokens,
   the SigLIP tower's tiles): K2 writing the lse (o bit for bit the no-lse
   entry point's), K7 (dk, dv) and K8 (dq), timed beside the bound and beside
   SDPA's backward through torch.autograd.grad (a yardstick no path uses),
   and K7 + K8 + attention_delta (the whole backward on the card) against
   it, each 10 calls a sample.
   Here, a reference check on one small batch (loss and per-group gradient
   norms of the kernel path and of plain attention under the same bf16
   autocast, against plain attention in f32: the kernel path must be as close
   as the plain bf16 path, within 2x or 1e-2), then `training.loop.train` on
   a llava-json of synthetic CXR-sized PNGs written under build/: packed
   rows (one image sample and one text sample) in the 4096 bucket,
   micro-batch 1, accumulation 2, 6 micro-steps (3 updates) with a
   checkpoint, a resume from it for 2 more, and 4 constant-rate steps on one
   batch whose loss must fall. K2-lse, K7 and K8 must have launched (K7 and
   K8 once a layer a micro-step: 24 + 26), K1 must not. Seconds a step,
   tokens/s, peak memory and a profiler breakdown of one step are printed;
9. QLoRA: radvlm_7b at full width and depth over an unfused int8 base born on
   the card, rank-128 adapters, 2 steps of one packed 4096-token row through
   `training.loop.train`: the adapters change, the base's bytes do not, K7
   and K8 launch 28 times a step at head_dim 128, K1 serves the frozen
   tower, K3 and K5/K6 never launch.

Ends with a JSON line of per-kernel results and then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import dataclasses
import gc
import io
import itertools
import json
import os
import shutil
import statistics
import subprocess
import time
import urllib.request

import numpy as np
import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.config import radvlm_0_5b, radvlm_7b
from radvlm_tpu_torch.data.loader import Bucket, LlavaJsonDataset, PrefetchLoader
from radvlm_tpu_torch.eval.harness import VLMRunner, batch_to_device
from radvlm_tpu_torch.generation import engine
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
from radvlm_tpu_torch.models import convert, multimodal, quant_io, radvlm
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as da
from radvlm_tpu_torch.ops import flash_attention as fa
from radvlm_tpu_torch.ops import int4_matmul as i4
from radvlm_tpu_torch.ops import int8_matmul as i8
from radvlm_tpu_torch.ops import kv_quant
from radvlm_tpu_torch.ops import w8a8_matmul as w8
from radvlm_tpu_torch.serve import openai_api as oai
from radvlm_tpu_torch.serve import worker_cli
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from radvlm_tpu_torch.serve.worker import ModelWorker
from radvlm_tpu_torch.training import loop as train_loop
from radvlm_tpu_torch.training import lora as lora_lib
from radvlm_tpu_torch.training import optimizer as optim
from radvlm_tpu_torch.training import train_step as tstep

REQUESTS = 3
NEW_TOKENS = 32
INT8_REQUESTS = 12  # concurrent, in the int8 continuous phase
INT8_BUCKETS = (3072, 3456, 3840, 4096)
SPEC_REQUESTS = 6  # concurrent greedy requests of the spec phase (3 with the bf16 cache)
INT4_REQUESTS = 6  # concurrent, in the artifact phase
FUSED_REQUESTS = 3  # greedy requests of the fused-W8A8 phase
QUESTIONS = ("Write the findings section of the report.", "Is there a pleural effusion?",
             "Describe the cardiac silhouette.", "Is there a pneumothorax?")

# name -> (source, the TPU kernel it replaces, the phase whose run counts it)
KERNELS = {
    "tower_attention": ("radvlm_tpu_torch/csrc/flash_attention.cu",
                        "radvlm_tpu/ops/flash_attention.py:525", "bf16"),
    "prefill_attention": ("radvlm_tpu_torch/csrc/flash_attention.cu",
                          "radvlm_tpu/ops/flash_attention.py:71", "bf16"),
    "decode_attention": ("radvlm_tpu_torch/csrc/decode_attention.cu",
                         "radvlm_tpu/ops/decode_attention.py:37", "bf16"),
    "w8a8_matmul": ("radvlm_tpu_torch/csrc/w8a8_matmul.cu",
                    "radvlm_tpu/ops/w8a8_matmul.py:202", "int8"),
    "decode_attention_q8": ("radvlm_tpu_torch/csrc/decode_attention.cu",
                            "radvlm_tpu/ops/decode_attention.py:274", "int8"),
    # One kernel for K5 (the stacked decode projections, :131) and K6 (the
    # flat lm_head, int8_matmul.py:72).
    "int8_matmul": ("radvlm_tpu_torch/csrc/int8_matmul.cu",
                    "radvlm_tpu/ops/int8_matmul.py:131", "int8"),
    "decode_attention_window": ("radvlm_tpu_torch/csrc/decode_attention.cu",
                                "radvlm_tpu/ops/decode_attention.py:376", "spec_bf16"),
    "decode_attention_window_q8": ("radvlm_tpu_torch/csrc/decode_attention.cu",
                                   "radvlm_tpu/ops/decode_attention.py:453", "spec_int8"),
    "int4_matmul": ("radvlm_tpu_torch/csrc/int4_matmul.cu",
                    "radvlm_tpu/ops/int4_matmul.py:111", "int4"),
    "w8a8_matmul_fused": ("radvlm_tpu_torch/csrc/w8a8_matmul.cu",
                          "radvlm_tpu/ops/w8a8_matmul.py:122", "fused"),
    # K2 writing its lse (the forward under a gradient), and its backward.
    "prefill_attention_lse": ("radvlm_tpu_torch/csrc/flash_attention.cu",
                              "radvlm_tpu/ops/flash_attention.py:188", "sft"),
    "flash_attention_bwd_dkv": ("radvlm_tpu_torch/csrc/flash_attention_bwd.cu",
                                "radvlm_tpu/ops/flash_attention.py:294", "sft"),
    "flash_attention_bwd_dq": ("radvlm_tpu_torch/csrc/flash_attention_bwd.cu",
                               "radvlm_tpu/ops/flash_attention.py:342", "sft"),
}
# The kernels each path must launch in its measured run.
PATH_KERNELS = {
    "bf16": ("tower_attention", "prefill_attention", "decode_attention"),
    "int8": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
             "int8_matmul"),
    "spec_int8": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
                  "int8_matmul", "decode_attention_window_q8"),
    "spec_bf16": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention",
                  "int8_matmul", "decode_attention_window"),
    # The int4 artifact: K12 for the layers' decode projections, K5/K6 for
    # the lm_head, K3 for the tower's fc2 (D = 4304 stays int8).
    "int4": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
             "int8_matmul", "int4_matmul"),
    "int4_spec": ("tower_attention", "prefill_attention", "w8a8_matmul", "int8_matmul",
                  "int4_matmul", "decode_attention_window_q8"),
    "fused": ("tower_attention", "prefill_attention", "w8a8_matmul_fused",
              "decode_attention_q8", "int8_matmul"),
    # Full finetuning: every attention is under a gradient, the tower's too.
    "sft": ("prefill_attention_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    # QLoRA: the decoder as above, the frozen tower through K1.
    "qlora": ("tower_attention", "prefill_attention_lse", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"),
}
TRAIN_BUCKET = Bucket(4096, 6)
SFT_STEPS, SFT_RESUMED_STEPS, OVERFIT_STEPS, QLORA_STEPS = 6, 2, 4, 2
LORA_RANK = 128
SPEC_K = 4
K5_ROWS = (8, 32, 40)  # decode slots, and a verify step of 8 slots x (SPEC_K + 1)
SPEC_BUCKETS = (3456, 3840)
# The card's peaks (NVIDIA's H100 SXM data sheet, dense): what a kernel's
# least possible time is computed from.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
PEAK_F32_PER_S = 67e12  # FMA outside the tensor cores


class CharTokenizer:
    """ASCII text (the prompts) encodes as 2 + its byte; an id decodes to one
    character of its own above U+00FF, which encodes back to that id. So
    equal text means equal tokens, and a reply sent back as text (the next
    turn of a chat) is the very ids the engine emitted, as a session's
    prefix match needs. No tokenizer files are needed."""

    eos_token_ids = (1,)
    pad_token_id = 0

    @staticmethod
    def _char(i: int) -> str:
        c = 0x100 + i
        return chr(c if c < 0xD800 else c + 0x800)  # step over the surrogates

    def encode(self, text):
        out = []
        for ch in text:
            c = ord(ch)
            out.append(2 + c if c < 0x100 else (c if c < 0xD800 else c - 0x800) - 0x100)
        return out

    def decode(self, ids):
        return "".join(self._char(i) for i in ids)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median time of fn() in ms, by CUDA events around each call, or around
    `batch` calls in a row (divided by `batch`): there the host's launches
    run ahead of the card, so the wrapper's host time before each launch
    drops out and a kernel of 0.1 ms is timed on the card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


ATTN_BATCH = 10  # the attention kernels and SDPA, forward and backward: 10 calls a sample


def device_ms(fn, reps: int = 10) -> float:
    """Device time of fn() in ms: the durations of the kernels it launches,
    summed by torch.profiler over `reps` calls. `cuda_ms` brackets a Python
    call with events, so for a kernel that takes less than its wrapper's
    host time (the skinny decode matmuls) it reads the host, not the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    if busy <= 0:  # the profiler traced no device
        return queued_ms(fn, reps)
    return busy / 1e3 / reps


_queued_ms_said = False


def queued_ms(fn, reps: int = 10) -> float:
    """Device time of fn() in ms where torch.profiler traces no device:
    `reps` calls are queued behind matmuls that keep the card busy until the
    host has issued them all, so the two events around them bracket the
    kernels back to back and none of the wrapper's host time. Fails if the
    host never got ahead of the card."""
    global _queued_ms_said
    if not _queued_ms_said:
        _queued_ms_said = True
        print("    torch.profiler recorded no device time: device times are taken by CUDA "
              "events around calls queued behind a busy card", flush=True)
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    blockers = 8
    while blockers <= 512:
        torch.cuda.synchronize()
        gate = torch.cuda.Event()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(blockers):
            a @ a
        gate.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not gate.query()  # the card still works on the matmuls
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        blockers *= 2
    raise AssertionError("queued_ms: the host never got ahead of the card")


def timed(run, library=None, reps: int = 10) -> dict:
    """A kernel's and its library call's times: `ms` / `library_ms` by CUDA
    events around samples of ATTN_BATCH calls in a row, `device_ms` /
    `library_device_ms` by torch.profiler (no host time in either). Plain
    versions stay one call a sample."""
    r = dict(ms=cuda_ms(run, reps=reps, batch=ATTN_BATCH), device_ms=device_ms(run, reps))
    r["library_ms"] = None if library is None else cuda_ms(library, reps=reps, batch=ATTN_BATCH)
    r["library_device_ms"] = None if library is None else device_ms(library, reps)
    return r


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the tensor cores' peak for `kind`, whichever is
    larger."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def against(r: dict) -> str:
    """The kernel's share of its bound and its ratio to the library call,
    printed beside its times (not asserted: a timing threshold would fail
    runs on noise)."""
    text = f"; {100 * r['bound_ms'] / r['ms']:.1f}% of the bound"
    if r["library_ms"] is not None:
        text += f", {r['ms'] / r['library_ms']:.2f}x the library call"
    return text


def shares(ms: float, n_bytes: float, pairs: int, d: int = 128) -> str:
    """A decode attention kernel's device time against its byte bound (the
    visible K/V and scales over the memory rate) and its FMA floor: the
    (query, key) pairs x 4 D flops of its f32 dot products and PV over the
    card's f32 rate outside the tensor cores."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_fma = 1e3 * 4 * d * pairs / PEAK_F32_PER_S
    return (f"{100 * t_bytes / ms:.1f}% of its byte bound ({t_bytes:.4f} ms), "
            f"{100 * t_fma / ms:.1f}% of its FMA floor ({t_fma:.4f} ms)")


def sdpa(q, k, v, mask=None):
    """The library's attention on [B, S, H, D] tensors (GQA by head groups):
    timed as a yardstick, used on no path."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def check_close(name: str, label: str, out: torch.Tensor, ref: torch.Tensor, rows=None) -> float:
    """Per row |out - plain| <= 2^-7 max_row|plain| + ATOL (`kernels.error_ratio`);
    bit for bit where ATOL is 0."""
    err, ratio = kernels.error_ratio(name, out, ref, rows)
    if kernels.ATOL[name] == 0:
        print(f"  {label}: max_abs_err {err:.3e}; must equal its plain version bit for bit",
              flush=True)
    else:
        print(f"  {label}: max_abs_err {err:.3e}; per row |err| <= 2^-7 max_row|plain| + "
              f"{kernels.ATOL[name]:.0e}, worst element at {ratio:.3f} of its bound", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels(dev, seed: int):
    """K1, K2, K9 (then K3, K4, K5/K6) at the main paths' shapes against
    their plain versions."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)

    results = {}
    # K1: SigLIP tower, 2 images x 5 tiles, 729 tokens, 16 heads of 72.
    q, k, v = randn(10, 729, 16, 72), randn(10, 729, 16, 72), randn(10, 729, 16, 72)
    scale = 72 ** -0.5
    out = fa.tower_attention(q, k, v)
    torch.cuda.synchronize()
    ref = fa.attention_plain(q, k, v, None, None, False, scale)
    err = check_close("tower_attention", "K1 tower_attention [10,729,16,72]", out, ref)
    results["tower_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fa.tower_attention(q, k, v), batch=ATTN_BATCH),
        plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, None, None, False, scale)),
        library_ms=cuda_ms(lambda: sdpa(q, k, v), batch=ATTN_BATCH),
        **bound(nbytes(q, k, v, out), 4 * 10 * 16 * 729 * 729 * 72, "bf16"),
    )
    # K2: Qwen2-7B prefill, B=2, S=4096, left padding, 28/4 heads of 128.
    b, s = 2, 4096
    q, k, v = randn(b, s, 28, 128), randn(b, s, 4, 128), randn(b, s, 4, 128)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    seg[0, :517] = 0
    seg[1, :90] = 0
    scale = 128 ** -0.5
    run = lambda: fa.prefill_attention(  # noqa: E731
        q, k, v, q_segment_ids=seg, kv_segment_ids=seg, causal=True)
    plain = lambda: fa.attention_plain(q, k, v, seg, seg, True, scale)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    err = check_close("prefill_attention", "K2 prefill_attention [2,4096,28|4,128]", out, ref,
                      rows=seg.bool())
    if out[~seg.bool()].abs().max() != 0:
        raise AssertionError("K2: padding rows must be 0")
    mask = tatt.make_attention_mask(seg, seg, True)
    pairs = int(mask.sum())  # the (query, key) pairs this run's mask leaves
    results["prefill_attention"] = dict(
        max_abs_err=err, ms=cuda_ms(run, batch=ATTN_BATCH), plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(lambda: sdpa(q, k, v, mask), reps=5, batch=ATTN_BATCH),
        **bound(nbytes(q, k, v, out, seg, seg), 4 * 28 * 128 * pairs, "bf16"))
    del q, k, v, ref, out, mask
    # K9: decode, B=4, Smax=4096, layer 27 of a 28-layer stacked cache,
    # left padding and an unwritten tail per row.
    b, s, n_layers = 4, 4096, 28
    ck, cv = randn(n_layers, b, s, 512), randn(n_layers, b, s, 512)
    qd = randn(b, 28, 128)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, (lo, hi) in enumerate([(300, 3600), (0, 3950), (1200, 4000), (40, 2100)]):
        seg[i, lo:hi] = 1

    def run(layer):
        return da.decode_attention_stacked(qd, ck, cv, seg, layer, num_kv_heads=4)

    def plain(layer):
        return da.decode_attention_plain(
            qd, ck[layer], cv[layer], seg, num_kv_heads=4, scale=128 ** -0.5)

    out = run(27)
    torch.cuda.synchronize()
    err = check_close("decode_attention", "K9 decode_attention [4,28,128] x [4,4096,512]",
                      out, plain(27))
    # Timed over the 28 layers in turn, as decode reads them: one layer's
    # K/V (33.5 MB) would otherwise stay in the 50 MB L2 between calls.
    layers = itertools.cycle(range(n_layers))
    mask = (seg != 0)[:, None, None, :]

    def library(layer):
        return sdpa(qd[:, None], ck[layer].view(b, s, 4, 128), cv[layer].view(b, s, 4, 128), mask)

    visible = int((seg != 0).sum())  # only the written slots need to be read
    results["decode_attention"] = dict(
        max_abs_err=err, **timed(lambda: run(next(layers)), lambda: library(next(layers))),
        plain_ms=cuda_ms(lambda: plain(next(layers))),
        **bound(2 * visible * 512 * 2 + nbytes(qd, out, seg), 4 * 28 * 128 * visible, "bf16"),
    )
    del ck, cv
    results.update(window_kernels(dev, randn, quantized=False))
    results.update(training_kernels(dev, g, randn))
    results.update(phase_int8_kernels(dev, g))
    print(f"  (kernels and library calls: samples of {ATTN_BATCH} calls in a row, and device "
          "time by torch.profiler in brackets where taken; plain versions: one call a sample, "
          "the wrapper's host time included)", flush=True)
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        if r.get("library_device_ms") is not None:
            lib += f" ({r['library_device_ms']:.4f})"
        dev_ms = f" ({r['device_ms']:.4f})" if r.get("device_ms") is not None else ""
        print(f"  {name}: kernel {r['ms']:.4f} ms{dev_ms}, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library call {lib}{against(r)}",
              flush=True)
    torch.cuda.empty_cache()
    return results


def training_kernels(dev, g, randn):
    """K2 writing the lse, K7 (dk, dv) and K8 (dq) at the three shapes the
    training paths give them, against `attention_plain` and
    `attention_backward_plain`. Returns the results at the 0.5B decoder's
    shape, the SFT path's."""
    shapes = [
        # (label, B, S, H, Hkv, D, causal, segment layout)
        ("0.5B decoder", 1, 4096, 14, 2, 64, True, "packed"),
        ("7B decoder", 1, 4096, 28, 4, 128, True, "left_pad"),
        ("tower", 5, 729, 16, 16, 72, False, None),
    ]
    results = {}
    for label, b, s, h, hkv, d, causal, layout in shapes:
        q, k, v, do = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d), randn(b, s, h, d)
        seg = None
        if layout is not None:
            seg = torch.ones((b, s), dtype=torch.int32, device=dev)
            if layout == "packed":  # an image sample, a text sample, right padding
                seg[:, 3300:] = 2
                seg[:, 3900:] = 0
            else:
                seg[:, :517] = 0
        scale = d ** -0.5
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal)
        tag = f"[{b},{s},{h}|{hkv},{d}] {label}"
        # K2 with the lse.
        o, lse = fa.prefill_attention_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, fa.prefill_attention(q, k, v, **kw)):
            raise AssertionError(f"K2-lse {label}: o differs from the no-lse entry point's")
        ref_o, ref_lse = fa.attention_plain(q, k, v, seg, seg, causal, scale, with_lse=True)
        real = None if seg is None else seg.bool()
        err = check_close("prefill_attention_lse", f"K2-lse o {tag} (bit-equal to K2's)", o, ref_o,
                          rows=real)
        fin = torch.isfinite(ref_lse)
        if not torch.equal(fin, torch.isfinite(lse)) or not torch.all(lse[~fin] == float("-inf")):
            raise AssertionError(f"K2-lse {label}: lse must be -inf exactly on the rows that "
                                 "attend nothing")
        lse_err = float((lse[fin] - ref_lse[fin]).abs().max())
        lse_bound = 1e-4 * max(1.0, float(ref_lse[fin].abs().max()))
        print(f"  K2-lse lse {tag}: max_abs_err {lse_err:.3e} on the finite rows (bound "
              f"{lse_bound:.1e}: f32 sums in another order, exp2 / log for exp / log); "
              f"{int((~fin).sum())} rows at -inf", flush=True)
        if not lse_err <= lse_bound:
            raise AssertionError(f"K2-lse {label}: lse disagrees with the plain version")
        if seg is None:
            pairs = b * s * s
            mask = None
        else:
            mask = tatt.make_attention_mask(seg, seg, causal)
            pairs = int(mask.sum())
        seg_bytes = 0 if seg is None else 2 * nbytes(seg)
        r_lse = dict(max_abs_err=err, ms=cuda_ms(lambda: fa.prefill_attention_lse(q, k, v, **kw),
                                                 batch=ATTN_BATCH),
                     plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, seg, seg, causal, scale,
                                                                 with_lse=True), reps=3, warmup=1),
                     library_ms=cuda_ms(lambda: sdpa(q, k, v, mask), reps=5, batch=ATTN_BATCH),
                     **bound(nbytes(q, k, v, o, lse) + seg_bytes, 4 * h * d * pairs, "bf16"))
        # K7 and K8, with a cotangent on the lse too.
        dlse = torch.randn(b, h, s, generator=g, device=dev)
        dlse = torch.where(fin, dlse, torch.zeros_like(dlse))
        delta = fa.attention_delta(o, do, dlse)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        plain = lambda: fa.attention_backward_plain(  # noqa: E731
            q, k, v, seg, seg, o, lse, do, dlse, causal, scale)
        rq, rk, rv = plain()
        err_dk = check_close("flash_attention_bwd_dkv", f"K7 dk {tag}", dk, rk)
        err_dv = check_close("flash_attention_bwd_dkv", f"K7 dv {tag}", dv, rv)
        err_dq = check_close("flash_attention_bwd_dq", f"K8 dq {tag}", dq, rq)
        if seg is not None and not (torch.all(dq[seg == 0] == 0) and torch.all(dk[seg == 0] == 0)
                                    and torch.all(dv[seg == 0] == 0)):
            raise AssertionError(f"K7/K8 {label}: padding rows must get zero gradients")
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"K7 {label}: two launches gave different bits")
        del rq, rk, rv, dk2, dv2
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        # The library's backward: one autograd.grad through SDPA gives dq, dk
        # and dv together (used on no path).
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl, mask)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                         retain_graph=True),
                             reps=5, batch=ATTN_BATCH)
        del lib_out, ql, kl, vl
        common = nbytes(q, k, v, do, lse, delta) + seg_bytes
        r_dkv = dict(max_abs_err=max(err_dk, err_dv),
                     ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw),
                                batch=ATTN_BATCH),
                     plain_ms=plain_ms, library_ms=library_ms,
                     **bound(common + nbytes(dk, dv), 8 * h * d * pairs, "bf16"))
        r_dq = dict(max_abs_err=err_dq,
                    ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                               batch=ATTN_BATCH),
                    plain_ms=plain_ms, library_ms=library_ms,
                    **bound(common + nbytes(dq), 6 * h * d * pairs, "bf16"))

        def backward():  # what `_FlashAttention.backward` runs on the card
            dl = fa.attention_delta(o, do, dlse)
            fa.flash_attention_bwd_dkv(q, k, v, do, lse, dl, **kw)
            fa.flash_attention_bwd_dq(q, k, v, do, lse, dl, **kw)

        pair_ms = cuda_ms(backward, batch=ATTN_BATCH)
        for name, r in (("K2-lse", r_lse), ("K7", r_dkv), ("K8", r_dq)):
            what = "SDPA forward" if name == "K2-lse" else "SDPA backward (dq, dk, dv together)"
            print(f"    {name} {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
                  f"({'forward' if name == 'K2-lse' else 'the whole backward'}), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {what} {r['library_ms']:.4f} ms"
                  f"{against(r) if name == 'K2-lse' else ''}", flush=True)
        print(f"    K7 + K8 + attention_delta {label}: {pair_ms:.4f} ms against SDPA backward "
              f"{library_ms:.4f} ms: {pair_ms / library_ms:.2f}x", flush=True)
        if label == "0.5B decoder":
            results.update(prefill_attention_lse=r_lse, flash_attention_bwd_dkv=r_dkv,
                           flash_attention_bwd_dq=r_dq)
        del q, k, v, do, o, lse, dlse, delta, dk, dv, dq, mask
        torch.cuda.empty_cache()
    return results


def window_kernels(dev, randn, *, quantized: bool, cache=None):
    """K10 (bf16 cache) or K11 (int8 cache) at 8 slots x 4224 keys, windows of
    5 (spec_k = 4, the main path's) and 16 queries: slots at different window
    indices after their own left padding, slot 1's window ending at the last
    cache index, slot 7 empty; the cache (and its scales) holds stale finite
    values above every window. Returns the 5-query result."""
    b, s, n_layers, hkv = 8, 4224, 28, 4
    name = "decode_attention_window_q8" if quantized else "decode_attention_window"
    label = "K11" if quantized else "K10"
    if cache is None:
        cache = (randn(n_layers, b, s, 512), randn(n_layers, b, s, 512))
    result = None
    for w in (5, 16):
        q = randn(b, w, 28, 128)
        widx = torch.tensor([3500, s - w, 4000, 3100, 3890, 3200, 1000, 2000],
                            dtype=torch.int32, device=dev)
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for i, lo in enumerate([300, 0, 1000, 40, 700, 0, 123]):
            seg[i, lo:int(widx[i]) + w] = 1

        def run(layer):
            if quantized:
                return da.decode_attention_stacked_window_q8(q, *cache, seg, layer, widx,
                                                             num_kv_heads=hkv)
            return da.decode_attention_stacked_window(q, *cache, seg, layer, widx,
                                                      num_kv_heads=hkv)

        def plain(layer):
            fn = (da.decode_attention_window_q8_plain if quantized
                  else da.decode_attention_window_plain)
            return fn(q, *(c[layer] for c in cache), seg, widx, num_kv_heads=hkv,
                      scale=128 ** -0.5)

        out = run(27)
        torch.cuda.synchronize()
        if out[7].abs().max() != 0:
            raise AssertionError(f"{label}: a slot with no visible key must give 0")
        err = check_close(name, f"{label} {name} [8,{w},28,128] x [8,4224,512]", out, plain(27))
        # Keys some query of the window sees, and (query, key) pairs in all.
        ar = torch.arange(s, device=dev)[None]
        any_row = int(((seg != 0) & (ar <= widx[:, None] + w - 1)).sum())
        pairs = sum(int(((seg != 0) & (ar <= widx[:, None] + j)).sum()) for j in range(w))
        per_key = 2 * 512 + 2 * 4 * 4 if quantized else 2 * 512 * 2
        layers = itertools.cycle(range(n_layers))
        if not quantized:
            # The library's attention on the bf16 layer as it lies, under the
            # window's visibility mask [B, 1, W, S]. (The int8 cache would
            # need a dequantization first: no one call.)
            mask = ((seg != 0)[:, None, :]
                    & (ar[:, None, :] <= (widx[:, None] + torch.arange(w, device=dev))[:, :, None])
                    )[:, None]

            def library(layer):
                return sdpa(q, cache[0][layer].view(b, s, hkv, 128),
                            cache[1][layer].view(b, s, hkv, 128), mask)

        r = dict(max_abs_err=err,
                 **timed(lambda: run(next(layers)),
                         None if quantized else lambda: library(next(layers))),
                 plain_ms=cuda_ms(lambda: plain(next(layers)), reps=3, warmup=1),
                 **bound(any_row * per_key + nbytes(q, out, seg, widx), 4 * 28 * 128 * pairs,
                         "bf16"))
        lib = r["library_ms"]
        print(f"    {label} W={w}: kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} on the device), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library call {'none' if lib is None else f'{lib:.4f} ms'}, "
              f"{any_row * per_key / r['ms'] / 1e6:.1f} GB/s of visible K/V; "
              f"{shares(r['device_ms'], any_row * per_key, 28 * pairs)}", flush=True)
        if w == SPEC_K + 1:
            result = r
        del q, out
    return {name: result}


def phase_int8_kernels(dev, g):
    """K3, K4 and K5/K6 at the int8 path's shapes against their plain versions."""
    def randint8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)

    results = {}
    # K3: every W8A8 shape of a 3456-token fill and a 5-tile tower pass
    # (3645 rows); bit for bit. Weights span the whole byte range (-128).
    k3_shapes = [("text qkv", 3456, 3584, 4608), ("text o", 3456, 3584, 3584),
                 ("text gateup", 3456, 3584, 37888), ("text down", 3456, 18944, 3584),
                 ("tower qkv", 3645, 1152, 3456), ("tower o", 3645, 1152, 1152),
                 ("tower fc1", 3645, 1152, 4304), ("tower fc2", 3645, 4304, 1152)]
    for label, m, k, n in k3_shapes:
        xq, xs = w8.quantize_rows(randn(m, k))
        wq = randint8(n, k)
        ws = torch.full((n,), 0.02 / 127, device=dev)
        run = lambda: w8.w8a8_matmul(xq, xs, wq, ws)  # noqa: E731
        plain = lambda: w8.w8a8_matmul_plain(xq, xs[:, 0], wq, ws, torch.bfloat16)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        err = check_close("w8a8_matmul", f"K3 w8a8_matmul {label} [{m},{k}]x[{k},{n}]",
                          out, plain())

        def library():  # cuBLAS int8 GEMM, then the two scale products
            acc = torch._int_mm(xq, wq.t())
            return ((acc.float() * xs) * ws).to(torch.bfloat16)

        least = bound(nbytes(xq, xs, wq, ws, out), 2 * m * k * n, "int8")
        if label == "text gateup":
            results["w8a8_matmul"] = r = dict(
                max_abs_err=err, **timed(run, library, reps=5), plain_ms=cuda_ms(plain, reps=5),
                **least)
            ms, lib_ms = r["ms"], r["library_ms"]
        else:
            ms = cuda_ms(run, reps=5, batch=ATTN_BATCH)
            lib_ms = cuda_ms(library, reps=5, batch=ATTN_BATCH)
        share = 100 * least["bound_ms"] / ms
        print(f"    K3 {label}: {ms:.4f} ms, {2 * m * k * n / ms / 1e9:.1f} TOP/s, bound "
              f"{least['bound_ms']:.4f} ms ({least['bound_by']}; {share:.1f}% of it), "
              f"_int_mm + scales {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)", flush=True)
        del xq, xs, wq
    # K4: 8 slots of a 4224-token int8 cache, 28 layers, each slot at its own
    # write index after its own left padding; slot 7 holds nothing.
    b, s, n_layers = 8, 4224, 28
    ck, ks = kv_quant.quantize_kv(randn(n_layers, b, s, 512), 4)
    cv, vs = kv_quant.quantize_kv(randn(n_layers, b, s, 512), 4)
    qd = randn(b, 28, 128)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, (lo, widx) in enumerate([(300, 3500), (0, 4100), (1000, 4223), (40, 3100),
                                    (700, 3890), (0, 3200), (123, 4000)]):
        seg[i, lo:widx + 1] = 1

    def run_q8(layer):
        return da.decode_attention_stacked_q8(qd, ck, cv, ks, vs, seg, layer, num_kv_heads=4)

    def plain_q8(layer):
        return da.decode_attention_q8_plain(qd, ck[layer], cv[layer], ks[layer], vs[layer], seg,
                                            num_kv_heads=4, scale=128 ** -0.5)

    out = run_q8(27)
    torch.cuda.synchronize()
    if out[7].abs().max() != 0:
        raise AssertionError("K4: a slot with no written key must give 0")
    err = check_close("decode_attention_q8", "K4 decode_attention_q8 [8,28,128] x [8,4224,512]",
                      out, plain_q8(27))
    layers = itertools.cycle(range(n_layers))
    visible = int((seg != 0).sum())  # per key: K and V rows, and 4 + 4 scales of 4 bytes
    results["decode_attention_q8"] = dict(
        max_abs_err=err, **timed(lambda: run_q8(next(layers))),
        plain_ms=cuda_ms(lambda: plain_q8(next(layers))),
        **bound(visible * (2 * 512 + 2 * 4 * 4) + nbytes(qd, out, seg), 4 * 28 * 128 * visible,
                "bf16"))
    r = results["decode_attention_q8"]
    print(f"    K4: {ck[0].numel() * 2 / r['ms'] / 1e6:.1f} GB/s of int8 K/V per layer; "
          f"{shares(r['device_ms'], visible * (2 * 512 + 2 * 4 * 4), 28 * visible)}",
          flush=True)
    results.update(window_kernels(dev, randn, quantized=True, cache=(ck, cv, ks, vs)))
    del ck, cv, ks, vs
    # K5/K6: the decode projections of a fused Qwen2-7B layer and the lm_head
    # at 8 and 32 rows (decode slots) and 40 (a verify step of 8 slots x 5).
    # Three copies of each weight, used in turn, so that a small one does not
    # stay in the 50 MB L2.
    step_ms, step_bound = {}, {}
    for label, k, n in [("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 37888),
                        ("down", 18944, 3584), ("lm_head", 3584, 152064)]:
        ws = [randint8(n, k) for _ in range(3)]
        sc = torch.full((n,), 0.02 / 127, device=dev)
        for rows in K5_ROWS:
            x = randn(rows, k)
            out = i8.int8_matmul(x, ws[0], sc)
            torch.cuda.synchronize()
            err = check_close("int8_matmul", f"K5/K6 int8_matmul {label} [{rows},{k}]x[{k},{n}]",
                              out, i8.int8_matmul_plain(x, ws[0], sc))
            turn = itertools.cycle(ws)
            ms = cuda_ms(lambda: i8.int8_matmul(x, next(turn), sc), batch=ATTN_BATCH)
            dms = step_ms[(label, rows)] = device_ms(lambda: i8.int8_matmul(x, next(turn), sc))
            least = bound(nbytes(x, ws[0], sc, out), 2 * rows * k * n, "bf16")
            step_bound[(label, rows)] = least["bound_ms"]
            print(f"    K5/K6 {label} {rows} rows: {ms:.4f} ms by events, {dms:.4f} ms on the "
                  f"device ({n * k / dms / 1e6:.1f} GB/s), bound {least['bound_ms']:.4f} ms "
                  f"({least['bound_by']}; {100 * least['bound_ms'] / dms:.1f}% of it on the "
                  "device)", flush=True)
            if (label, rows) == ("gateup", 8):
                lib_call = lambda: torch._weight_int8pack_mm(x, next(turn), sc)  # noqa: E731
                results["int8_matmul"] = dict(
                    max_abs_err=err, ms=ms, device_ms=dms,
                    plain_ms=cuda_ms(lambda: i8.int8_matmul_plain(x, next(turn), sc)),
                    library_ms=cuda_ms(lib_call, batch=ATTN_BATCH),
                    library_device_ms=device_ms(lib_call), **least)
            if (label, rows) == ("lm_head", 8):  # K6's shape
                plain_ms = cuda_ms(lambda: i8.int8_matmul_plain(x, next(turn), sc), reps=5)
                lib_ms = cuda_ms(lambda: torch._weight_int8pack_mm(x, next(turn), sc), reps=5,
                                 batch=ATTN_BATCH)
                print(f"    K6 lm_head 8 rows: plain {plain_ms:.4f} ms, library call "
                      f"(_weight_int8pack_mm) {lib_ms:.4f} ms", flush=True)
        del ws
    for rows in K5_ROWS:
        per_step, least = (
            28 * sum(t[(p, rows)] for p in ("qkv", "o", "gateup", "down")) + t[("lm_head", rows)]
            for t in (step_ms, step_bound))
        print(f"    K5/K6 per decode step, {rows} rows (28 layers + lm_head): {per_step:.3f} ms "
              f"on the device, bound {least:.3f} ms ({100 * least / per_step:.1f}% of it)",
              flush=True)
    results.update(int4_kernel(dev, g, randn, step_ms[("gateup", 8)]))
    results.update(fused_w8a8_kernel(dev, randn, randint8))
    return results


def int4_kernel(dev, g, randn, k56_gateup_ms: float):
    """K12 at the four decode projections of a fused Qwen2-7B layer, 8 rows
    (a decode step of 8 slots) and 40 (a verify step of 8 slots x 5
    queries), against its plain version and its byte bound, gateup beside
    K5/K6's (`k56_gateup_ms`, device time at 8 rows); rows 0-7 of the 40 must
    equal the 8 bit for bit, and 64 one-hot rows must give 64 of the
    dequantized weights bit for bit. Enough copies of each weight, used in
    turn, that none stays in the 50 MB L2."""
    results, step_ms, step_bound = {}, {}, {}
    for label, k, n in [("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 37888),
                        ("down", 18944, 3584)]:
        copies = max(3, -(-100_000_000 // (n * k // 2)))
        ws = [torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
              for _ in range(copies)]
        sc = torch.rand(k // i4.GROUP, n, generator=g, device=dev) * (0.03 / 7) + 0.005 / 7
        # One-hot rows: each output is one weight, bf16(f32(nibble) * scale).
        ks = torch.randperm(k, generator=g, device=dev)[:64]
        onehot = torch.zeros((64, k), device=dev, dtype=torch.bfloat16)
        onehot[torch.arange(64, device=dev), ks] = 1.0
        picked = i4.int4_matmul(onehot, ws[0], sc)
        if not torch.equal(picked, i4.dequantize_weight_int4(ws[0], sc)[:, ks].t()):
            raise AssertionError(f"K12 {label}: a one-hot row is not the dequantized weight")
        x40 = randn(40, k)
        outs = {}
        for rows in (8, 40):
            x = x40[:rows].contiguous()
            out = outs[rows] = i4.int4_matmul(x, ws[0], sc)
            torch.cuda.synchronize()
            err = check_close("int4_matmul", f"K12 int4_matmul {label} [{rows},{k}]x[{k},{n}]",
                              out, i4.int4_matmul_plain(x, ws[0], sc))
            turn = itertools.cycle(ws)
            ms = cuda_ms(lambda: i4.int4_matmul(x, next(turn), sc), batch=ATTN_BATCH)
            dms = step_ms[(label, rows)] = device_ms(lambda: i4.int4_matmul(x, next(turn), sc))
            least = bound(nbytes(x, ws[0], sc, out), 2 * rows * k * n, "bf16")
            step_bound[(label, rows)] = least["bound_ms"]
            print(f"    K12 {label} {rows} rows: {ms:.4f} ms by events, {dms:.4f} ms on the device "
                  f"({nbytes(ws[0], sc) / dms / 1e6:.1f} GB/s of nibbles and scales), bound "
                  f"{least['bound_ms']:.4f} ms ({least['bound_by']}; "
                  f"{100 * least['bound_ms'] / dms:.1f}% of it on the device)", flush=True)
            if (label, rows) == ("gateup", 8):
                print(f"    K12 gateup 8 rows against K5/K6's int8 gateup in this run "
                      f"({k56_gateup_ms:.4f} ms on the device): {dms / k56_gateup_ms:.2f}x",
                      flush=True)
                results["int4_matmul"] = dict(
                    max_abs_err=err, ms=ms, device_ms=dms,
                    plain_ms=cuda_ms(lambda: i4.int4_matmul_plain(x, next(turn), sc),
                                     reps=3, warmup=1),
                    library_ms=None, **least)
        if not torch.equal(outs[8], outs[40][:8]):
            raise AssertionError(f"K12 {label}: a row's result depends on the row count")
        del ws
    print("    K12: rows 0-7 alone equal rows 0-7 among 40, and 64 one-hot rows equal 64 "
          "dequantized weights, bit for bit at all four shapes", flush=True)
    for rows in (8, 40):
        per_step, least = (28 * sum(t[(p, rows)] for p in ("qkv", "o", "gateup", "down"))
                           for t in (step_ms, step_bound))
        print(f"    K12 per decode step, {rows} rows (28 layers, no lm_head): {per_step:.3f} ms "
              f"on the device, bound {least:.3f} ms ({100 * least / per_step:.1f}% of it)",
              flush=True)
    return results


def fused_w8a8_kernel(dev, randn, randint8):
    """K13 at a 3456-token fill's gateup and down projections and the
    tower's fc1 (5 tiles): bit for bit equal to quantize_rows + K3, timed
    beside that pair and beside quantize_rows + torch._int_mm + the scale
    pass."""
    results = {}
    for label, m, k, n in [("text gateup", 3456, 3584, 37888), ("text down", 3456, 18944, 3584),
                           ("tower fc1", 3645, 1152, 4304)]:
        x = randn(m, k)
        x[m // 2] = 0  # a row of zeros: amax clamps to 1e-8, y = 0
        wq = randint8(n, k)
        ws = torch.full((n,), 0.02 / 127, device=dev)

        def unfused():
            xq, xs = w8.quantize_rows(x)
            return w8.w8a8_matmul(xq, xs, wq, ws)

        def library():
            xq, xs = w8.quantize_rows(x)
            return ((torch._int_mm(xq, wq.t()).float() * xs) * ws).to(torch.bfloat16)

        run = lambda: w8.w8a8_matmul_fused(x, wq, ws)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        err = check_close("w8a8_matmul_fused",
                          f"K13 w8a8_matmul_fused {label} [{m},{k}]x[{k},{n}] vs quantize_rows + K3",
                          out, unfused())
        if out[m // 2].abs().max() != 0:
            raise AssertionError("K13: a row of zeros must give 0")
        r = timed(run, library, reps=5)
        ms = r["ms"]
        pair_ms = cuda_ms(unfused, reps=5, batch=ATTN_BATCH)
        pair_dev = device_ms(unfused, reps=5)
        quant_ms = cuda_ms(lambda: w8.quantize_rows(x), reps=5, batch=ATTN_BATCH)
        print(f"    K13 {label}: {ms:.4f} ms ({r['device_ms']:.4f} on the device; "
              f"{2 * m * k * n / ms / 1e9:.1f} TOP/s); quantize_rows + K3 {pair_ms:.4f} ms "
              f"({pair_dev:.4f}; quantize_rows alone {quant_ms:.4f}); quantize_rows + _int_mm + "
              f"scales {r['library_ms']:.4f} ms ({r['library_device_ms']:.4f}): "
              f"{ms / pair_ms:.2f}x the pair", flush=True)
        if label == "text gateup":
            results["w8a8_matmul_fused"] = dict(
                max_abs_err=err, **r,
                plain_ms=cuda_ms(lambda: w8.w8a8_matmul_fused_plain(x, wq, ws), reps=3, warmup=1),
                **bound(nbytes(x, wq, ws, out), 2 * m * k * n, "int8"))
        del x, wq
    return results


def cxr_image(rng) -> np.ndarray:
    h, w = int(rng.integers(480, 560)), int(rng.integers(400, 520))
    return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)


def png_b64(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def prompt(runner: VLMRunner, question: str) -> str:
    return runner.build_prompt("<image>\n" + question)


def reference_check(runner: VLMRunner, rng):
    """The slice on one small input at full width, three ways: kernels in
    bf16, plain attention (attn_impl="xla") in bf16, and plain attention on
    an f32 copy of the same weights (the reference). Prefill logits and one
    decode step; the kernel path must be about as close to the f32
    reference as the plain bf16 path is (within 2x, or 1e-2)."""
    cfg, tok = runner.cfg, runner.tokenizer
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(tok.encode, prompt(runner, "Any effusion?"))
    batch = multimodal.collate([multimodal.build_sample(ids, [img], cfg)],
                               pad_to_multiple=512, left_pad=True)
    batch = batch_to_device(batch, runner.device)
    l = batch["tokens"].shape[1]
    max_len = engine.cache_length(l, 8)
    ref32 = radvlm.fuse_for_inference(
        radvlm.RadVLM(cfg, device=runner.device, dtype=torch.float32), cfg)
    ref32.load_state_dict(runner.model.state_dict())
    logits, tok0 = {}, None
    for name, model, impl in (("f32 plain", ref32, "xla"), ("kernels", runner.model, "auto"),
                              ("bf16 plain", runner.model, "xla")):
        cache, cache_seg, lg = engine.prefill(model, cfg, batch, max_len, attn_impl=impl)
        if tok0 is None:  # every path decodes the reference's greedy token
            tok0 = lg.argmax(-1)
        _, _, lg1 = engine.decode_step(model, cfg, cache, cache_seg, tok0,
                                       batch["lengths"].to(runner.device), l, attn_impl=impl)
        logits[name] = (lg.float(), lg1.float())
        del cache
    del ref32
    torch.cuda.empty_cache()
    for i, stage in enumerate(("prefill", "decode")):
        ref = logits["f32 plain"][i]
        err = {}
        for name in ("kernels", "bf16 plain"):
            out = logits[name][i]
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"reference check: {name} {stage} logits malformed")
            err[name] = float((out - ref).abs().max() / ref.abs().max())
        print(f"  {stage} logits [{ref.shape[0]},{ref.shape[1]}], prompt {l} tokens, max rel "
              f"err vs f32: kernels {err['kernels']:.3e}, plain bf16 {err['bf16 plain']:.3e}; "
              f"argmax f32 {int(ref.argmax())}, kernels {int(logits['kernels'][i].argmax())}",
              flush=True)
        if not err["kernels"] <= max(2 * err["bf16 plain"], 1e-2):
            raise AssertionError(f"reference check: kernel path off the f32 {stage} logits")


def post_stream(url: str, req: dict):
    """POST a generate request; returns (chunks, seconds to first chunk, total seconds)."""
    body = json.dumps(req).encode()
    t0 = time.perf_counter()
    t_first, buf = None, b""
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=600) as resp:
        while True:
            data = resp.read1(65536)
            if not data:
                break
            if t_first is None:
                t_first = time.perf_counter() - t0
            buf += data
    chunks = [json.loads(c) for c in buf.split(b"\0") if c]
    return chunks, t_first, time.perf_counter() - t0


def phase_slice(dev, seed: int):
    cfg = radvlm_7b()
    t0 = time.perf_counter()
    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                device=dev, dtype=torch.bfloat16)
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=CharTokenizer(),
                       max_new_tokens=NEW_TOKENS, batch_size=2, pad_to_multiple=512)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  radvlm_7b: {n_params / 1e9:.3f}B params, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card, "
          f"init + fuse {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    reference_check(runner, rng)

    images = [cxr_image(rng) for _ in range(REQUESTS)]
    reqs = [{"prompt": prompt(runner, QUESTIONS[i % len(QUESTIONS)]), "images": [png_b64(im)],
             "max_new_tokens": NEW_TOKENS, "temperature": 0.0}
            for i, im in enumerate(images)]
    worker = ModelWorker(runner, model_names=["radvlm-7b"])
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{port}/worker_generate_stream"
    try:
        # Warm-up request (first-call allocations); not measured or counted.
        post_stream(url, dict(reqs[0], max_new_tokens=2))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        texts = []
        for i, req in enumerate(reqs + [reqs[0]]):
            chunks, t_first, t_all = post_stream(url, req)
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"request {i} failed: {chunks[-1:] or 'no chunks'}")
            n = len(chunks)
            tps = (n - 1) / (t_all - t_first) if n > 1 else float("nan")
            texts.append(chunks[-1]["text"])
            print(f"  request {i}: image {images[i % REQUESTS].shape[:2]}, {n} tokens, "
                  f"first chunk {t_first:.3f} s, total {t_all:.3f} s, decode {tps:.1f} tok/s",
                  flush=True)
        if texts[-1] != texts[0]:
            raise AssertionError("a repeated greedy request gave other tokens")
        t0 = time.perf_counter()
        out = runner.generate_batch([reqs[1]["prompt"], reqs[2]["prompt"]],
                                    [[images[1]], [images[2]]])
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        worker.shutdown()
    if len(out) != 2 or not all(out):
        raise AssertionError(f"generate_batch returned {out!r}")
    print(f"  generate_batch (2 left-padded prompts, {NEW_TOKENS} new tokens): "
          f"{t_batch:.3f} s, {2 * NEW_TOKENS / t_batch:.1f} tok/s incl. prefill", flush=True)
    print(f"  launches in the measured run: {counts}", flush=True)
    require_launched("bf16", counts)

    # Prefill alone on the batch of 2, timed after the counted run.
    samples = [multimodal.build_sample(multimodal.tokenize_with_images(
        runner.tokenizer.encode, reqs[i]["prompt"]), [images[i]], cfg) for i in (0, 1)]
    batch = batch_to_device(multimodal.collate(samples, pad_to_multiple=512, left_pad=True), dev)
    l = batch["tokens"].shape[1]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, lg = engine.prefill(model, cfg, batch, engine.cache_length(l, NEW_TOKENS))
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    if lg.shape != (2, cfg.text.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("prefill logits have the wrong shape or are not finite")
    print(f"  prefill (batch 2, {l} tokens each, {tuple(batch['tiles'].shape[:2])} tiles): "
          f"{t_prefill:.3f} s", flush=True)
    print(f"  provenance: {engine.kernel_provenance(cfg, prompt_len=l, max_new_tokens=NEW_TOKENS)}",
          flush=True)
    profile_stages(model, cfg, batch, NEW_TOKENS)
    return counts


def require_launched(path: str, counts) -> None:
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} path: {missing}")


def device_breakdown(prof, wall: float, label: str, profiled_wall=None, top: int = 12) -> None:
    """Device time by kernel from a profiler run, and the busy share of an
    unprofiled wall time of the same work (the profiler's own overhead
    inflates its wall time)."""
    from torch.autograd import DeviceType

    # Device-side events only (kernels, copies); the aten ops that launched
    # them would count the same time twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print(f"  profile {label}: unprofiled wall {wall:.4f} s; torch.profiler recorded no "
              "device time, so the device-busy share is not measured", flush=True)
        return
    busy = sum(e.self_device_time_total for e in events) / 1e6
    profiled ="" if profiled_wall is None else f", profiled wall {profiled_wall:.4f} s"
    print(f"  profile {label}: unprofiled wall {wall:.4f} s{profiled}, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}% of the unprofiled wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:90]}",
              flush=True)


def profile_stages(model, cfg, batch, new_tokens: int):
    """One prefill and `new_tokens` decode steps of the batch, timed by the
    host's clock unprofiled and then again under torch.profiler: device
    time by kernel, and the device-busy share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    l = batch["tokens"].shape[1]
    max_len = engine.cache_length(l, new_tokens)
    lengths = batch["lengths"]
    state = {}

    def prefill():
        state["cache"], state["seg"], lg = engine.prefill(model, cfg, batch, max_len)
        state["tok"] = lg.argmax(-1)

    def decode():
        for step in range(new_tokens):
            state["cache"], state["seg"], lg = engine.decode_step(
                model, cfg, state["cache"], state["seg"], state["tok"], lengths + step, l + step)
            state["tok"] = lg.argmax(-1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    stages = (("prefill", prefill), (f"decode x{new_tokens}", decode))
    # Each decode run starts from a fresh prefill: the cache holds only
    # `new_tokens` steps past the prompt.
    walls = {stage: timed(fn) for stage, fn in stages}
    for stage, fn in stages:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(fn)
        device_breakdown(prof, walls[stage], stage, profiled_wall=wall)


def reference_check_int8(model, cfg, tok, rng) -> None:
    """The int8 path on one small input at full width, three ways: the
    kernels (W8A8 prefill, int8 cache, K3/K4/K5), the same int8 weights
    weight-only (RADVLM_W8A8=0) with plain attention and a bf16 cache, and
    the reference: plain attention on an f32 copy of the dequantized
    weights. Prefill logits and one decode step. The kernel path must stay
    within 2x the weight-only path's error plus 0.03: on the CPU, W8A8 and
    the int8 cache add ~1e-3 per two layers of the tiny config over the
    weight-only path (PERF.md), ~0.015 over Qwen2-7B's 28 layers, doubled."""
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(
        tok.encode, "<|im_start|>user\n<image>\nAny effusion?<|im_end|>\n<|im_start|>assistant\n")
    batch = multimodal.collate([multimodal.build_sample(ids, [img], cfg)],
                               pad_to_multiple=128, left_pad=True)
    batch = batch_to_device(batch, model.device)
    l = batch["tokens"].shape[1]
    max_len = engine.cache_length(l, 8)
    ref32 = convert.dequantized_copy(model, cfg, torch.float32)
    logits, tok0 = {}, None
    paths = (("f32 plain", ref32, "xla", "bf16", "1"), ("kernels", model, "auto", "int8", "1"),
             ("weight-only plain", model, "xla", "bf16", "0"))
    for name, m, impl, fmt, w8a8 in paths:
        os.environ["RADVLM_W8A8"] = w8a8
        try:
            cache, cache_seg, lg = engine.prefill(m, cfg, batch, max_len, attn_impl=impl,
                                                  cache_format=fmt)
            if tok0 is None:  # every path decodes the reference's greedy token
                tok0 = lg.argmax(-1)
            _, _, lg1 = engine.decode_step(m, cfg, cache, cache_seg, tok0, batch["lengths"], l,
                                           attn_impl=impl)
        finally:
            os.environ.pop("RADVLM_W8A8")
        logits[name] = (lg.float(), lg1.float())
        del cache
    del ref32
    torch.cuda.empty_cache()
    for i, stage in enumerate(("prefill", "decode")):
        ref = logits["f32 plain"][i]
        err = {}
        for name in ("kernels", "weight-only plain"):
            out = logits[name][i]
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"int8 reference check: {name} {stage} logits malformed")
            err[name] = float((out - ref).abs().max() / ref.abs().max())
        bound = 2 * err["weight-only plain"] + 0.03
        print(f"  int8 {stage} logits [{ref.shape[0]},{ref.shape[1]}], prompt {l} tokens, max rel "
              f"err vs f32: kernels {err['kernels']:.3e}, weight-only plain "
              f"{err['weight-only plain']:.3e} (bound {bound:.3e}); argmax f32 "
              f"{int(ref.argmax())}, kernels {int(logits['kernels'][i].argmax())}", flush=True)
        if not err["kernels"] <= bound:
            raise AssertionError(f"int8 reference check: kernel path off the f32 {stage} logits")


def phase_int8(dev, seed: int):
    cfg = radvlm_7b()
    t0 = time.perf_counter()
    model = convert.random_quantized_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                            device=dev)
    torch.cuda.synchronize()
    int8_bytes = sum(p.numel() for p in model.parameters() if p.dtype == torch.int8)
    print(f"  radvlm_7b int8: {int8_bytes / 1e9:.3f} GB of int8 weights, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card, "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    tok = CharTokenizer()
    rng = np.random.default_rng(seed + 1)
    reference_check_int8(model, cfg, tok, rng)
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=1, pad_to_multiple=128)
    worker = BatchWorker(runner, model_names=["radvlm-7b-int8"], num_slots=8, max_len=4224,
                         kv_quant=True, prompt_buckets=INT8_BUCKETS, steps_per_sync=32,
                         pipeline_depth=4, fill_batch=2)
    b = worker.batcher
    print(f"  warmup {worker.warmup_seconds:.2f} s: "
          f"{ {k: round(v, 3) for k, v in b.warmup_timings.items()} }", flush=True)
    images = [cxr_image(rng) for _ in range(INT8_REQUESTS)]
    reqs = [{"prompt": prompt(runner, QUESTIONS[i % len(QUESTIONS)]), "images": [png_b64(im)],
             "max_new_tokens": NEW_TOKENS, "temperature": 0.0} for i, im in enumerate(images)]
    lengths = [multimodal.build_sample(multimodal.tokenize_with_images(
        tok.encode, r["prompt"]), [im], cfg).length for r, im in zip(reqs, images)]
    buckets = sorted({b._bucket_for(n) for n in lengths})
    print(f"  prompts: {sorted(lengths)} tokens, buckets {buckets}", flush=True)
    if len(buckets) < 2:
        raise AssertionError("the load must span at least two prompt buckets")
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        b.host_stats = dict.fromkeys(b.host_stats, 0)

        def one(i):
            if i < 2:  # two of them stream
                chunks, t_first, t_all = post_stream(base + "/worker_generate_stream", reqs[i])
                return chunks[-1] if chunks else {"error_code": -1}, t_first, t_all
            t0 = time.perf_counter()
            out = post_json(base + "/worker_generate", reqs[i])
            return out, None, time.perf_counter() - t0

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(INT8_REQUESTS) as pool:
            loaded = list(pool.map(one, range(INT8_REQUESTS)))
        t_load = time.perf_counter() - t0
        for i, (out, _, _) in enumerate(loaded):
            if out.get("error_code") != 0 or not out.get("text"):
                raise AssertionError(f"int8 request {i} failed: {out}")
        n_tok = b.host_stats["tokens"]
        completion = [t for _, _, t in loaded]
        print(f"  {INT8_REQUESTS} concurrent requests: {t_load:.3f} s, "
              f"{INT8_REQUESTS / t_load:.3f} images/s, p50 completion "
              f"{statistics.median(completion):.3f} s, {n_tok} tokens, "
              f"{n_tok / t_load:.1f} tokens/s (prefills included); streamed first chunks "
              f"{[round(t, 3) for _, t, _ in loaded[:2]]} s", flush=True)
        print(f"  host_stats: { {k: round(v, 3) for k, v in b.host_stats.items()} }", flush=True)
        single, texts = [], []
        for i in (3, 4, 5, 3):
            before = b.host_stats["tokens"]
            chunks, t_first, t_all = post_stream(base + "/worker_generate_stream", reqs[i])
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"int8 single request {i} failed: {chunks[-1:]}")
            single.append(t_all)
            texts.append(chunks[-1]["text"])
            n = b.host_stats["tokens"] - before
            print(f"  single request {i}: {lengths[i]}-token prompt, first chunk {t_first:.3f} s, "
                  f"total {t_all:.3f} s, {n} tokens", flush=True)
        if texts[-1] != texts[0]:
            raise AssertionError("a repeated greedy int8 request gave other tokens")
        print(f"  p50 unloaded completion {statistics.median(single[:3]):.3f} s", flush=True)
        if texts[0] != loaded[3][0]["text"]:
            raise AssertionError("the same request alone and under load gave other tokens")
    finally:
        worker.shutdown()
    counts = kernels.launch_counts()
    print(f"  launches in the measured run: {counts}", flush=True)
    print(f"  provenance: {b.kernel_provenance()}", flush=True)
    require_launched("int8", counts)
    step_ms = engine_chunks(b, cfg, tok, reqs[0], images[0])
    # What the spec phase serves again: the model, the first requests and
    # the plain engine's greedy texts for them.
    n = SPEC_REQUESTS
    return counts, dict(model=model, cfg=cfg, tok=tok, reqs=reqs[:n], images=images[:n],
                        plain_texts=[out["text"] for out, _, _ in loaded[:n]],
                        plain_step_ms=step_ms)


@torch.inference_mode()
def engine_chunks(b, cfg, tok, req, image, label: str = "int8") -> float:
    """Every slot filled (the engine thread is stopped), then three greedy
    decode chunks (verify chunks on a spec engine): one under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host sync
    inside it; one timed by the host's clock; one under torch.profiler
    (device time by kernel, busy share). Returns the timed chunk's ms per
    step."""
    from torch.profiler import ProfilerActivity, profile

    sample = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, req["prompt"]),
                                     [image], cfg)
    for _ in range(b.num_slots):
        b.submit(sample, 4 * b.steps_per_sync)
    pending = []
    while not b.queue.empty():
        pending.append(b.queue.get_nowait())
    for i in range(0, len(pending), b.fill_batch):
        b._fill_group([(i + j, r) for j, r in enumerate(pending[i:i + b.fill_batch])])
    inflight = collections.deque()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b._dispatch_chunk(inflight, force_sampling=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b._process_chunk(inflight, [])
    print(f"  a greedy {b.steps_per_sync}-step chunk of {b.num_slots} slots "
          f"(spec_k={b.spec_k}) ran under set_sync_debug_mode('error'): no host sync",
          flush=True)

    def chunk():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._dispatch_chunk(inflight, force_sampling=False)
        b._process_chunk(inflight, [])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    before = dict(b.spec_stats) if b.spec_k else None
    wall = chunk()
    tokens = b.num_slots * b.steps_per_sync
    if b.spec_k:  # a verify step emits its accepted prefix + 1
        tokens = b.spec_stats["emitted"] - before["emitted"]
    kind = f"verify (spec_k={b.spec_k})" if b.spec_k else "decode"
    print(f"  {label} {kind} chunk: {wall:.4f} s for {b.steps_per_sync} steps of {b.num_slots} "
          f"slots ({1e3 * wall / b.steps_per_sync:.2f} ms/step, {tokens} tokens, "
          f"{tokens / wall:.1f} tokens/s)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
    device_breakdown(prof, wall, f"{label} {kind} chunk ({b.steps_per_sync} steps)")
    return 1e3 * wall / b.steps_per_sync


def path_logits(model, cfg, tok, prompt_text, image, ids, step: int, kv_quant: bool):
    """The logits [V] from which the plain path (a full prefill of the
    prompt as the engine prefills it, then `ids` fed back one by one) picks
    token `step` of the reply."""
    sample = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, prompt_text),
                                     [image], cfg)
    batch = batch_to_device(multimodal.collate([sample], pad_tiles=6, pad_to_multiple=128,
                                               left_pad=True), model.device)
    l = batch["tokens"].shape[1]
    cache, seg, logits = engine.prefill(model, cfg, batch, 4224,
                                        cache_format="int8" if kv_quant else "bf16")
    for t in range(step):
        cur = torch.tensor([ids[t]], device=model.device)
        cache, seg, logits = engine.decode_step(model, cfg, cache, seg, cur,
                                                batch["lengths"] + t, l + t)
    return logits[0].float()


def same_tokens_or_near_tie(label, ctx, prompt_text, image, text, ref_text, kv_quant) -> None:
    """`text` must hold the tokens of `ref_text`, the plain path's. A
    difference fails the run unless the plain path itself was at a near tie
    at the first differing step: its own top-2 logit gap under 1e-2, which
    is printed."""
    if text == ref_text:
        return
    tok = ctx["tok"]
    got, want = tok.encode(text), tok.encode(ref_text)
    step = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    logits = path_logits(ctx["model"], ctx["cfg"], tok, prompt_text, image, want, step, kv_quant)
    top = torch.topk(logits, 2).values
    gap, limit = float(top[0] - top[1]), 1e-2
    print(f"  {label}: tokens leave the plain path's at step {step} ({got[step:step + 1]} for "
          f"{want[step:step + 1]}); the plain path's top-2 logit gap there is {gap:.3e} "
          f"(limit {limit:.3e})", flush=True)
    if not gap < limit:
        raise AssertionError(f"{label}: the tokens differ from the plain path's")


def chat_body(question_turns, image, session_id, **kw):
    """An OpenAI chat body: the image and the first question, then the
    (reply, question) turns that followed."""
    first, *rest = question_turns
    messages = [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64," + png_b64(image)}},
        {"type": "text", "text": first}]}]
    for reply, question in rest:
        messages += [{"role": "assistant", "content": reply}, {"role": "user", "content": question}]
    return dict(messages=messages, max_tokens=NEW_TOKENS, session_id=session_id, **kw)


@torch.inference_mode()
def timed_fill(b, sample, **kw) -> float:
    """Seconds of one fill of slot 0 (engine thread stopped), by the host's
    clock around synchronizes."""
    b.submit(sample, 1, **kw)
    req = b.queue.get_nowait()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b._fill_group([(0, req)])
    torch.cuda.synchronize()
    b.slot_req[0] = None
    return time.perf_counter() - t0


def phase_spec(ctx, kv_quant: bool, n_requests: int):
    """Speculative decoding and sessions on the int8 model, one KV cache."""
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    label = "spec int8-cache" if kv_quant else "spec bf16-cache"
    reqs, images = ctx["reqs"][:n_requests], ctx["images"][:n_requests]
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=1, pad_to_multiple=128)
    engine_kw = dict(num_slots=8, max_len=4224, kv_quant=kv_quant, prompt_buckets=SPEC_BUCKETS,
                     steps_per_sync=8, pipeline_depth=2, fill_batch=2)
    if kv_quant:
        plain_texts, plain_step_ms = ctx["plain_texts"], ctx["plain_step_ms"]
    else:
        # The plain engine with this cache, same slots and cache length (and
        # so the same key-split plan in K9 as in K10): greedy tokens, and the
        # time of a plain chunk.
        pb = ContinuousBatcher(model, cfg, engine.GenerationConfig(
            max_new_tokens=NEW_TOKENS, eos_token_ids=tok.eos_token_ids), spec_k=0, **engine_kw)
        plain_reqs = [pb.submit(multimodal.build_sample(multimodal.tokenize_with_images(
            tok.encode, r["prompt"]), [im], cfg), NEW_TOKENS) for r, im in zip(reqs, images)]
        list(pb.run())
        plain_texts = [engine.trim_at_stop_strings(tok.decode(r.emitted),
                                                   runner.template.stop_strings)
                       for r in plain_reqs]
        plain_step_ms = engine_chunks(pb, cfg, tok, reqs[0], images[0], label="plain bf16-cache")
        del pb, plain_reqs
        torch.cuda.empty_cache()
    worker = BatchWorker(runner, model_names=["radvlm-7b-int8"], spec_k=SPEC_K, **engine_kw)
    b = worker.batcher
    print(f"  {label}: warmup {worker.warmup_seconds:.2f} s: "
          f"{ {k: round(v, 3) for k, v in b.warmup_timings.items()} }", flush=True)
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # (a) concurrent greedy requests: the plain engine's tokens.
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n_requests) as pool:
            outs = list(pool.map(lambda r: post_json(base + "/worker_generate", r), reqs))
        t_load = time.perf_counter() - t0
        for i, out in enumerate(outs):
            if out.get("error_code") != 0 or not out.get("text"):
                raise AssertionError(f"{label} request {i} failed: {out}")
            same_tokens_or_near_tie(f"{label} request {i}", ctx, reqs[i]["prompt"], images[i],
                                    out["text"], plain_texts[i], kv_quant)
        stats = dict(b.spec_stats)
        print(f"  {label}: {n_requests} concurrent greedy requests in {t_load:.3f} s, tokens "
              f"held to the plain engine's; spec_stats {stats} "
              f"({stats['emitted'] / max(1, stats['verify_steps']):.3f} tokens per verify step)",
              flush=True)
        # (b) a sampling request: single-token steps (K4 / K9) on the same engine.
        hot = post_json(base + "/worker_generate", dict(reqs[0], temperature=0.8, top_p=0.9))
        if hot.get("error_code") != 0 or not hot.get("text"):
            raise AssertionError(f"{label} sampling request failed: {hot}")
        # (c) a two-turn chat with a session id over the OpenAI endpoint.
        def chat(turns, session_id):
            """(the reply's text, seconds) of one chat completion."""
            t0 = time.perf_counter()
            out = post_json(base + "/v1/chat/completions", chat_body(turns, images[0], session_id))
            return out["choices"][0]["message"]["content"], time.perf_counter() - t0

        q1, q2 = QUESTIONS[0], QUESTIONS[1]
        reply1, t_turn1 = chat([q1], "chat-1")
        if b.resume_fills != 0 or not reply1:
            raise AssertionError(f"{label}: the first turn must be a full prefill with a reply")
        turns = [q1, (reply1, q2)]
        reply2, t_turn2 = chat(turns, "chat-1")
        if b.resume_fills != 1:
            raise AssertionError(f"{label}: the second turn was not a delta prefill "
                                 f"(resume_fills = {b.resume_fills})")
        full2, t_full2 = chat(turns, "chat-2")
        if b.resume_fills != 1:
            raise AssertionError(f"{label}: a new session id must be a full prefill")
        if not reply2:
            raise AssertionError(f"{label}: the resumed turn gave no text")
        # The resumed turn is held to the full prefill of the same
        # conversation under the rule of the greedy requests.
        conversation = oai.messages_to_request(chat_body(turns, images[0], "x"),
                                               runner.template)["prompt"]
        same_tokens_or_near_tie(f"{label} resumed turn", ctx, conversation, images[0], reply2,
                                full2, kv_quant)
        print(f"  {label} session: turn 1 {t_turn1:.3f} s, turn 2 by delta prefill "
              f"{t_turn2:.3f} s, the same turn by full prefill {t_full2:.3f} s, "
              f"{'same text' if reply2 == full2 else 'texts differ at a near tie'}; resume_fills "
              f"{b.resume_fills}", flush=True)
        print(f"  {label} host_stats: { {k: round(v, 3) for k, v in b.host_stats.items()} }; "
              f"spec_stats {b.spec_stats}", flush=True)
        session = worker._sessions.get("chat-2")
    finally:
        worker.shutdown()
    counts = kernels.launch_counts()
    print(f"  launches in the measured run: {counts}", flush=True)
    print(f"  provenance: {b.kernel_provenance()}", flush=True)
    require_launched("spec_int8" if kv_quant else "spec_bf16", counts)
    # A delta fill against a full fill of the same three-turn conversation.
    q3 = tok.encode("<|im_end|>\n<|im_start|>user\n" + QUESTIONS[2]
                    + "<|im_end|>\n<|im_start|>assistant\n")
    timed_fill(b, multimodal.build_sample(q3, [], cfg), resume=session.snapshot)  # first-call costs
    t_delta = timed_fill(b, multimodal.build_sample(q3, [], cfg), resume=session.snapshot)
    full = multimodal.build_sample(list(session.ids) + q3, [images[0]], cfg)
    t_full = timed_fill(b, full)
    print(f"  {label} fill of turn 3: delta ({len(q3)} tokens on a snapshot of "
          f"{session.snapshot.widx}) {t_delta:.4f} s, full ({full.length} tokens, tower included) "
          f"{t_full:.4f} s", flush=True)
    del session
    step_ms = engine_chunks(b, cfg, tok, reqs[0], images[0], label=label)
    per_tok = b.spec_stats["emitted"] / max(1, b.spec_stats["verify_steps"])
    print(f"  {label}: {step_ms:.2f} ms per verify step of {SPEC_K + 1} queries a slot against "
          f"{plain_step_ms:.2f} ms per plain step ({step_ms / plain_step_ms:.2f}x); "
          f"{per_tok:.3f} tokens per verify step over the phase", flush=True)
    return counts


def same_parameters(a, b) -> int:
    """Every parameter of `a` equal to `b`'s bit for bit (same names, dtypes,
    shapes, bytes); returns their bytes."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if pa.keys() != pb.keys():
        raise AssertionError(f"parameter names differ: {sorted(pa.keys() ^ pb.keys())[:5]}")
    total = 0
    for name, x in pa.items():
        y = pb[name]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{name}: {x.dtype} {tuple(x.shape)} != {y.dtype} {tuple(y.shape)}")
        raw = torch.int16 if x.dtype == torch.bfloat16 else x.dtype  # bytes, not values
        if not torch.equal(x.view(raw), y.view(raw)):
            raise AssertionError(f"{name}: loaded bytes differ from the saved model's")
        total += x.numel() * x.element_size()
    return total


def phase_artifact(dev, seed: int, ctx):
    """The pre-quantized artifact path at full width and depth: int4 model
    -> save_quantized -> worker_cli.build_worker -> served."""
    cfg, tok = radvlm_7b(), CharTokenizer()
    t0 = time.perf_counter()
    saved = convert.random_quantized_params(cfg, torch.Generator(device=dev).manual_seed(seed + 7),
                                            device=dev, bits=4, fuse=False)
    torch.cuda.synchronize()
    print(f"  radvlm_7b int4 (unfused): {sum(p.numel() * p.element_size() for p in saved.parameters()) / 1e9:.3f} "
          f"GB of parameters, init {time.perf_counter() - t0:.2f} s", flush=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    path = os.path.join(root, f"smoke_artifact_{os.getpid()}")
    try:
        t0 = time.perf_counter()
        payload = quant_io.save_quantized(saved, cfg, path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(path, quant_io.WEIGHTS))
        print(f"  save_quantized: {payload / 1e9:.3f} GB payload, {size / 1e9:.3f} GB file, "
              f"{t_save:.2f} s ({payload / t_save / 1e9:.3f} GB/s)", flush=True)
        args = worker_cli.parse_args([
            "--checkpoint", path, "--model-names", "radvlm-7b-int4", "--num-slots", "8",
            "--max-len", "4224", "--max-new-tokens", str(NEW_TOKENS)])
        t0 = time.perf_counter()
        worker = worker_cli.build_worker(args, tokenizer=tok, kv_quant=True,
                                         prompt_buckets=INT8_BUCKETS, steps_per_sync=32,
                                         pipeline_depth=4, fill_batch=2)
        t_build = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    runner, b = worker.runner, worker.batcher
    model = runner.model
    if model.device != dev or runner.cfg != cfg:
        raise AssertionError("build_worker must load the artifact's config onto the card")
    print(f"  build_worker: {t_build:.2f} s, of which warmup {worker.warmup_seconds:.2f} s "
          f"(load_quantized + fuse {t_build - worker.warmup_seconds:.2f} s); "
          f"{ {k: round(v, 3) for k, v in b.warmup_timings.items()} }", flush=True)
    # The runner fused its model in place; fuse the saved one the same way.
    n_bytes = same_parameters(radvlm.fuse_for_inference(saved, cfg), model)
    print(f"  loaded parameters equal the saved model's bit for bit ({n_bytes / 1e9:.3f} GB); "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card", flush=True)
    del saved
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 1)
    reference_check_int8(model, cfg, tok, np.random.default_rng(seed + 2))
    images = [cxr_image(rng) for _ in range(INT4_REQUESTS)]
    reqs = [{"prompt": prompt(runner, QUESTIONS[i % len(QUESTIONS)]), "images": [png_b64(im)],
             "max_new_tokens": NEW_TOKENS, "temperature": 0.0} for i, im in enumerate(images)]
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        b.host_stats = dict.fromkeys(b.host_stats, 0)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(INT4_REQUESTS) as pool:
            loaded = list(pool.map(lambda r: post_json(base + "/worker_generate", r), reqs))
        t_load = time.perf_counter() - t0
        for i, out in enumerate(loaded):
            if out.get("error_code") != 0 or not out.get("text"):
                raise AssertionError(f"int4 request {i} failed: {out}")
        n_tok = b.host_stats["tokens"]
        print(f"  {INT4_REQUESTS} concurrent requests: {t_load:.3f} s, "
              f"{INT4_REQUESTS / t_load:.3f} images/s, {n_tok} tokens, {n_tok / t_load:.1f} "
              f"tokens/s (prefills included)", flush=True)
        single, texts = [], []
        for i in (3, 4, 3):
            chunks, t_first, t_all = post_stream(base + "/worker_generate_stream", reqs[i])
            if not chunks or any(c["error_code"] != 0 for c in chunks):
                raise AssertionError(f"int4 single request {i} failed: {chunks[-1:]}")
            single.append(t_all)
            texts.append(chunks[-1]["text"])
            print(f"  single request {i}: first chunk {t_first:.3f} s, total {t_all:.3f} s, "
                  f"{len(tok.encode(texts[-1]))} tokens", flush=True)
        if texts[-1] != texts[0] or texts[0] != loaded[3]["text"]:
            raise AssertionError("a repeated greedy int4 request gave other tokens")
        print(f"  host_stats: { {k: round(v, 3) for k, v in b.host_stats.items()} }", flush=True)
    finally:
        worker.shutdown()
    counts = kernels.launch_counts()
    print(f"  launches in the measured run: {counts}", flush=True)
    print(f"  provenance: {b.kernel_provenance()}", flush=True)
    require_launched("int4", counts)
    # A fill's projections have thousands of rows (dequant route), so every
    # K12 launch is a decode step's: 4 fused projections x 28 layers.
    per_step = 4 * cfg.text.num_layers
    if counts["int4_matmul"] % per_step:
        raise AssertionError(f"K12 launched {counts['int4_matmul']} times: not {per_step} a step")
    print(f"  K12: {counts['int4_matmul'] // per_step} decode steps x {per_step} launches",
          flush=True)
    t_fill = [timed_fill_group(b, reqs[:1], images[:1], tok, cfg) for _ in range(2)][-1]
    print(f"  int4 fill of one prompt (dequant route + cuBLAS; tower fc2 and lm_head int8): "
          f"{t_fill:.4f} s", flush=True)
    step_ms = engine_chunks(b, cfg, tok, reqs[0], images[0], label="int4")
    print(f"  int4 decode step {step_ms:.2f} ms against {ctx['plain_step_ms']:.2f} ms for phase "
          f"5's int8 step ({step_ms / ctx['plain_step_ms']:.2f}x)", flush=True)
    # One request through a speculative engine (8 slots x 5 window rows = 40
    # rows: K12 and K11) must give the plain engine's tokens.
    sample = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, reqs[0]["prompt"]),
                                     [images[0]], cfg)
    sb = ContinuousBatcher(model, cfg, engine.GenerationConfig(
        max_new_tokens=NEW_TOKENS, eos_token_ids=tok.eos_token_ids), num_slots=8, max_len=4224,
        kv_quant=True, prompt_buckets=(b._bucket_for(sample.length),), steps_per_sync=8,
        pipeline_depth=2, spec_k=SPEC_K)
    sb.warmup()
    kernels.reset_launch_counts()
    req = sb.submit(sample, NEW_TOKENS)
    list(sb.run())
    spec_counts = kernels.launch_counts()
    text = engine.trim_at_stop_strings(tok.decode(req.emitted), runner.template.stop_strings)
    same_tokens_or_near_tie("int4 spec request", dict(model=model, cfg=cfg, tok=tok),
                            reqs[0]["prompt"], images[0], text, loaded[0]["text"], True)
    require_launched("int4_spec", spec_counts)
    print(f"  int4 spec_k={SPEC_K} request: {len(req.emitted)} tokens, "
          f"{'the plain engine\'s tokens' if text == loaded[0]['text'] else 'a near tie'}; "
          f"spec_stats {sb.spec_stats}; launches {spec_counts}", flush=True)
    return counts


@torch.inference_mode()
def timed_fill_group(b, reqs, images, tok, cfg) -> float:
    """Seconds of one fill group (engine thread stopped) of the requests'
    prompts into slots 0.., by the host's clock around synchronizes."""
    group = []
    for i, (r, im) in enumerate(zip(reqs, images)):
        b.submit(multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, r["prompt"]),
                                         [im], cfg), 1)
        group.append((i, b.queue.get_nowait()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b._fill_group(group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, _ in group:
        b.slot_req[i] = None
    return wall


def phase_fused(ctx):
    """Phase 5's int8 model and engine settings with RADVLM_W8A8_IMPL=fused:
    every W8A8 matmul of a fill goes through K13 instead of quantize_rows +
    K3, and the tokens must not change."""
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    reqs, images = ctx["reqs"][:FUSED_REQUESTS], ctx["images"][:FUSED_REQUESTS]
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=1, pad_to_multiple=128)
    # Only the buckets these prompts fall into are warmed up (each costs
    # two fills through K13 and their host prep).
    lengths = [multimodal.build_sample(multimodal.tokenize_with_images(
        tok.encode, r["prompt"]), [im], cfg).length for r, im in zip(reqs, images)]
    buckets = tuple(sorted({min(b for b in INT8_BUCKETS if b >= n) for n in lengths}))
    os.environ["RADVLM_W8A8_IMPL"] = "fused"
    try:
        worker = BatchWorker(runner, model_names=["radvlm-7b-int8"], num_slots=8, max_len=4224,
                             kv_quant=True, prompt_buckets=buckets, steps_per_sync=32,
                             pipeline_depth=4, fill_batch=2)
        b = worker.batcher
        print(f"  fused: warmup {worker.warmup_seconds:.2f} s: "
              f"{ {k: round(v, 3) for k, v in b.warmup_timings.items()} }", flush=True)
        port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
        base = f"http://127.0.0.1:{port}"
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(FUSED_REQUESTS) as pool:
                outs = list(pool.map(lambda r: post_json(base + "/worker_generate", r), reqs))
            t_load = time.perf_counter() - t0
        finally:
            worker.shutdown()
        counts = kernels.launch_counts()
        print(f"  provenance: {b.kernel_provenance()}", flush=True)
    finally:
        os.environ.pop("RADVLM_W8A8_IMPL")
    for i, out in enumerate(outs):
        if out.get("error_code") != 0 or not out.get("text"):
            raise AssertionError(f"fused request {i} failed: {out}")
        if out["text"] != ctx["plain_texts"][i]:  # K13 is bit-equal: no near-tie rule
            raise AssertionError(f"fused request {i}: tokens differ from phase 5's")
    print(f"  {FUSED_REQUESTS} concurrent greedy requests in {t_load:.3f} s: phase 5's tokens "
          f"exactly", flush=True)
    print(f"  launches in the measured run: {counts}", flush=True)
    require_launched("fused", counts)
    if counts["w8a8_matmul"] != 0:
        raise AssertionError(f"K3 launched {counts['w8a8_matmul']} times under "
                             "RADVLM_W8A8_IMPL=fused")
    # A fill group of 2 prompts through K3, K13, K13, K3 (the dispatch reads
    # the variable at every matmul; first-call costs were paid in warmup).
    walls = {"kernel": [], "fused": []}
    for impl in ("kernel", "fused", "fused", "kernel"):
        if impl == "fused":
            os.environ["RADVLM_W8A8_IMPL"] = "fused"
        try:
            walls[impl].append(timed_fill_group(b, reqs[:2], images[:2], tok, cfg))
        finally:
            os.environ.pop("RADVLM_W8A8_IMPL", None)
    k3, k13 = statistics.mean(walls["kernel"]), statistics.mean(walls["fused"])
    print(f"  fill group of 2 prompts: through quantize_rows + K3 "
          f"{[round(t, 4) for t in walls['kernel']]} s, through K13 "
          f"{[round(t, 4) for t in walls['fused']]} s ({k13 / k3:.2f}x)", flush=True)
    return counts


def write_training_data(root: str, rng, n_pairs: int) -> str:
    """A llava-json under `root`: `n_pairs` cells with a synthetic CXR-sized
    PNG each (portrait, 560 x 400-448: ~3.1k tokens with its text) and as
    many text-only cells (~0.5k tokens), so that one of each packs into a
    4096-token row. Returns the json's path."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    findings = ("No focal consolidation, pleural effusion or pneumothorax. The cardiac silhouette "
                "is within normal limits. No acute osseous abnormality.")
    cells = []
    for i in range(n_pairs):
        name = f"cxr{i}.png"
        img = rng.integers(0, 255, size=(560, int(rng.integers(400, 448)), 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, name))
        cells.append({"id": f"img{i}", "image": name, "conversations": [
            {"from": "human", "value": "<image>\n" + QUESTIONS[i % len(QUESTIONS)]},
            {"from": "gpt", "value": findings}]})
        cells.append({"id": f"txt{i}", "conversations": [
            {"from": "human", "value": "Rewrite these findings as an impression: " + findings},
            {"from": "gpt", "value": "Impression: no acute cardiopulmonary process. " * 3}]})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cells, f)
    return path


def training_run_config(cfg, train_cfg, data_path, root, tok, seed: int, n_rows: int, **kw):
    """A RunConfig over `data_path` (`n_rows` image cells and as many text
    cells) whose epoch is `n_rows` rows of one image cell and one text cell
    each: the loader's seed is the first of seed, seed + 1, ... with that
    plan (a row of two images would be clipped at the bucket's 4096 tokens,
    a row of two texts would be mostly padding)."""
    run = train_loop.RunConfig(
        model=cfg, train=train_cfg, data_path=data_path, image_root=root, micro_batch_size=1,
        log_every=1, buckets=(TRAIN_BUCKET,), pack_factor=2, loader_workers=4, **kw)
    with open(data_path) as f:
        cells = json.load(f)
    dataset = LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=tok.encode,
                               max_len=TRAIN_BUCKET.max_len)
    for loader_seed in range(seed, seed + 100000):
        plan = PrefetchLoader(dataset, 1, buckets=run.buckets, seed=loader_seed,
                              pack_factor=2).epoch_plan(0)
        if len(plan) == n_rows and all(
                sum("image" in cells[i] for i in idxs) == 1 for _, idxs in plan):
            break
    else:
        raise AssertionError("no loader seed packs one image a row")
    lengths = [sum(dataset[i].length for i in idxs) for _, idxs in plan]
    print(f"  data: {len(cells)} cells, loader seed {loader_seed}, packed rows of {lengths} "
          f"tokens in the {TRAIN_BUCKET.max_len} bucket", flush=True)
    if max(lengths) > TRAIN_BUCKET.max_len:
        raise AssertionError("a packed row exceeds the bucket")
    return dataclasses.replace(run, seed=loader_seed)


def group_grad_norms(model) -> dict:
    """Gradient norm per learning-rate group; frees the gradients."""
    sq = collections.defaultdict(float)
    for name, p in model.named_parameters():
        if p.grad is not None:
            sq[optim.group_of(name)] += float(p.grad.float().square().sum())
            p.grad = None
    return {g: v ** 0.5 for g, v in sq.items()}


def training_reference_check(model, cfg, tok, rng) -> None:
    """Loss and per-group gradient norms on one small batch, three ways:
    the train step's path (bf16 autocast, K2-lse / K7 / K8), plain attention
    under the same autocast, and plain attention in f32 without autocast
    (the reference). The kernel path must be about as close to the
    reference as the plain bf16 path is: within 2x its relative error, or
    1e-2."""
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(
        tok.encode, "<|im_start|>user\n<image>\nAny effusion?<|im_end|>\n<|im_start|>assistant\n")
    reply = tok.encode("No pleural effusion.<|im_end|>\n")
    sample = multimodal.build_sample(ids + reply, [img], cfg,
                                     labels=[-100] * len(ids) + reply)
    batch = batch_to_device(multimodal.collate([sample], pad_to_multiple=128), model.device)
    got = {}
    for name, impl, autocast in (("f32 plain", "xla", False), ("kernels", "auto", True),
                                 ("bf16 plain", "xla", True)):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            loss, _ = radvlm.loss_fn(model, cfg, batch, remat=True, attn_impl=impl)
        loss.backward()
        got[name] = dict(loss=float(loss.detach()), **group_grad_norms(model))
    ref = got["f32 plain"]
    for key in ref:
        err = {n: abs(got[n][key] - ref[key]) / abs(ref[key]) for n in ("kernels", "bf16 plain")}
        limit = max(2 * err["bf16 plain"], 1e-2)
        print(f"  {key}: f32 plain {ref[key]:.6f}, kernels {got['kernels'][key]:.6f} (rel err "
              f"{err['kernels']:.3e}), bf16 plain {got['bf16 plain'][key]:.6f} (rel err "
              f"{err['bf16 plain']:.3e}); limit {limit:.3e}", flush=True)
        if not (np.isfinite(got["kernels"][key]) and err["kernels"] <= limit):
            raise AssertionError(f"training reference check: kernel path off the f32 {key}")
    print(f"  reference batch: {batch['tokens'].shape[1]} tokens, "
          f"{batch['tiles'].shape[1]} tiles", flush=True)


def run_training(run, tok, model, label: str, first_step: int = 0):
    """`training.loop.train` with every step's metrics and wall time kept.
    Returns (state, [(step, metrics, seconds since the previous step)])."""
    seen, t_prev = [], [time.perf_counter()]

    def on_metrics(step, m):
        now = time.perf_counter()
        seen.append((step, m, now - t_prev[0]))
        t_prev[0] = now

    state = train_loop.train(run, tok.encode, init_params=model, metrics_callback=on_metrics)
    for step, m, dt in seen:
        print(f"  {label} step {step}: loss {m['loss']:.4f}, {int(m['tokens'])} supervised tokens, "
              f"grad_norm {m['grad_norm']:.4f}, {dt:.3f} s, {m['tokens_per_sec']:.0f} tokens/s",
              flush=True)
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{label} step {step}: loss or grad_norm not finite")
    want = list(range(first_step + 1, run.max_steps + 1))
    if state.step != run.max_steps or [s for s, _, _ in seen] != want:
        raise AssertionError(f"{label}: ran steps {[s for s, _, _ in seen]}, expected {want}")
    return state, seen


def phase_sft(dev, seed: int):
    """Full finetuning of radvlm_0_5b at full width and depth through
    `training.loop.train`."""
    cfg, tok = radvlm_0_5b(), CharTokenizer()
    t0 = time.perf_counter()
    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                                dtype=torch.float32)
    labels = optim.mark_trainable(model, optim.TrainConfig())
    torch.cuda.synchronize()
    n_train = sum(p.numel() for n, p in model.named_parameters() if n in labels)
    print(f"  radvlm_0_5b: {n_train / 1e6:.1f} M trainable f32 parameters (every part tunable), "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed + 3)
    training_reference_check(model, cfg, tok, rng)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_train_{os.getpid()}")
    try:
        data_path = write_training_data(root, rng, SFT_STEPS + SFT_RESUMED_STEPS)
        train_cfg = optim.TrainConfig(grad_accum_steps=2, total_steps=100)
        run = training_run_config(cfg, train_cfg, data_path, root, tok, seed,
                                  SFT_STEPS + SFT_RESUMED_STEPS, max_steps=SFT_STEPS,
                                  checkpoint_dir=os.path.join(root, "ckpt"), save_steps=SFT_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, seen = run_training(run, tok, model, "SFT")
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        steady = [dt for _, _, dt in seen[2:]]  # past the first update
        tokens = statistics.median(m["tokens_per_sec"] for _, m, _ in seen[2:])
        print(f"  SFT: {SFT_STEPS} micro-steps ({state.opt_state.count} updates), median "
              f"{statistics.median(steady):.3f} s a micro-step, {tokens:.0f} tokens/s, peak memory "
              f"{peak / 2**30:.2f} GiB; the whole call {t_run:.2f} s (set-up, the loader's start and "
              f"the checkpoint's write included)", flush=True)
        print(f"  launches in the measured run: {counts}", flush=True)
        require_launched("sft", counts)
        per_step = cfg.text.num_layers + cfg.vision.num_layers
        for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            if counts[name] != SFT_STEPS * per_step:
                raise AssertionError(f"{name} launched {counts[name]} times, not {per_step} a "
                                     "micro-step")
        if counts["prefill_attention_lse"] != 2 * SFT_STEPS * per_step:  # forward + recompute
            raise AssertionError("K2-lse must launch twice a layer a micro-step under remat")
        if counts["tower_attention"] or counts["prefill_attention"]:
            raise AssertionError("K1 / K2 without the lse launched under a gradient")
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(os.path.join(root, "ckpt")) for f in fs)
        print(f"  checkpoint at step {SFT_STEPS}: {size / 1e9:.3f} GB", flush=True)
        # Resume: the restore must bring back what the NaN below destroys.
        with torch.no_grad():
            model.text.norm.fill_(float("nan"))
        state, resumed = run_training(
            dataclasses.replace(run, max_steps=SFT_STEPS + SFT_RESUMED_STEPS), tok, model,
            "SFT resumed", first_step=SFT_STEPS)
        if state.opt_state.count != (SFT_STEPS + SFT_RESUMED_STEPS) // 2:
            raise AssertionError("the resumed run lost the optimizer's update count")
        print(f"  resumed from the checkpoint at step {SFT_STEPS}: steps "
              f"{[s for s, _, _ in resumed]}, {state.opt_state.count} updates in all", flush=True)
        # Overfit one batch at a constant rate: the loss must fall.
        del state
        gc.collect()
        torch.cuda.empty_cache()
        const = optim.TrainConfig(learning_rate=1e-4, vision_tower_lr=1e-4, lr_schedule="constant",
                                  warmup_ratio=0.0, grad_accum_steps=1)
        ostate, step_fn, _ = tstep.setup_training(cfg, const, model)
        with open(data_path) as f:
            cells = json.load(f)
        loader = PrefetchLoader(
            LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=tok.encode,
                             max_len=TRAIN_BUCKET.max_len),
            1, buckets=run.buckets, seed=run.seed, num_workers=2, pack_factor=2)
        batch = batch_to_device(next(iter(loader.epoch(0))), dev)
        losses = []
        for _ in range(OVERFIT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ostate, m = step_fn(ostate, batch)
            losses.append(float(m["loss"]))
            wall = time.perf_counter() - t0
        print(f"  overfit of one batch at a constant 1e-4: losses "
              f"{[round(l, 4) for l in losses]}", flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError("the overfit loss did not fall")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ostate, m = step_fn(ostate, batch)
            torch.cuda.synchronize()
        device_breakdown(prof, wall, "SFT step (update every step)", top=20)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def fingerprint(model) -> list:
    """A sum per parameter, exact for the integer ones: changes if a byte does."""
    return [(n, float(p.double().sum()) if p.is_floating_point() else int(p.long().sum()))
            for n, p in model.named_parameters()]


def phase_qlora(dev, seed: int):
    """QLoRA of radvlm_7b over an int8 base through `training.loop.train`."""
    cfg, tok = radvlm_7b(), CharTokenizer()
    t0 = time.perf_counter()
    base = convert.random_quantized_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                           device=dev, fuse=False)
    torch.cuda.synchronize()
    print(f"  radvlm_7b int8 base (unfused): {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"on the card, init {time.perf_counter() - t0:.2f} s", flush=True)
    before = fingerprint(base)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_qlora_{os.getpid()}")
    try:
        data_path = write_training_data(root, np.random.default_rng(seed + 4), QLORA_STEPS)
        train_cfg = optim.TrainConfig(learning_rate=1e-4, lr_schedule="constant", warmup_ratio=0.0,
                                      grad_accum_steps=1)
        run = training_run_config(cfg, train_cfg, data_path, root, tok, seed, QLORA_STEPS,
                                  max_steps=QLORA_STEPS, lora_rank=LORA_RANK, quantize_base=True)
        lcfg = lora_lib.LoraConfig(rank=LORA_RANK, alpha=run.lora_alpha)
        first = lora_lib.init_lora(base, lcfg, torch.Generator(device=dev).manual_seed(run.seed))
        a0 = {p: ad["a"].detach().clone() for p, ad in first.items()}
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        state, seen = run_training(run, tok, base, "QLoRA")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_adapter = sum(t.numel() for ad in state.params.values() for t in ad.values())
    print(f"  QLoRA: rank {LORA_RANK}, {n_adapter / 1e6:.1f} M adapter parameters over "
          f"{len(state.params)} stacked kernels; last step {seen[-1][2]:.3f} s, "
          f"{seen[-1][1]['tokens_per_sec']:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    print(f"  launches in the measured run: {counts}", flush=True)
    require_launched("qlora", counts)
    layers = cfg.text.num_layers
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        if counts[name] != QLORA_STEPS * layers:
            raise AssertionError(f"{name} launched {counts[name]} times, not {layers} a step")
    if counts["tower_attention"] != QLORA_STEPS * cfg.vision.num_layers:
        raise AssertionError("K1 must serve every layer of the frozen tower once a step")
    for name in ("w8a8_matmul", "int8_matmul", "w8a8_matmul_fused", "int4_matmul"):
        if counts[name]:
            raise AssertionError(f"{name} launched {counts[name]} times in training mode")
    for path, ad in state.params.items():
        if not float(ad["b"].detach().abs().max()) > 0 or torch.equal(ad["a"].detach(), a0[path]):
            raise AssertionError(f"adapter {path} did not change")
        if not (torch.isfinite(ad["a"]).all() and torch.isfinite(ad["b"]).all()):
            raise AssertionError(f"adapter {path} is not finite")
    if fingerprint(base) != before:
        raise AssertionError("the frozen base changed")
    print("  every adapter's A and B changed and is finite; the base's parameters did not change",
          flush=True)
    return counts


def post_json(url: str, req: dict) -> dict:
    body = json.dumps(req).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=600) as resp:
        return json.loads(resp.read())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    print(f"[1/9] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t_start = t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"[2/9] build: {time.perf_counter() - t0:.2f} s ({kernels.BUILD_DIR})", flush=True)

    def header(text):
        print(f"{text} (at {time.perf_counter() - t_start:.0f} s)", flush=True)

    header("[3/9] kernels against their plain versions")
    results = phase_kernels(dev, 1234 + args.seed)

    header("[4/9] bf16 slice: radvlm_7b, random bf16 weights")
    counts = {"bf16": phase_slice(dev, args.seed)}
    gc.collect()  # the bf16 model (15 GiB) goes before the int8 one comes
    torch.cuda.empty_cache()

    header("[5/9] int8 continuous path: radvlm_7b, weights born int8, BatchWorker")
    counts["int8"], ctx = phase_int8(dev, args.seed)
    gc.collect()  # phase 5's KV cache goes before the spec engines' come
    torch.cuda.empty_cache()

    header(f"[6/9] speculative decoding (spec_k={SPEC_K}) and sessions on the int8 model")
    counts["spec_int8"] = phase_spec(ctx, True, SPEC_REQUESTS)
    gc.collect()
    torch.cuda.empty_cache()
    counts["spec_bf16"] = phase_spec(ctx, False, SPEC_REQUESTS // 2)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7/9] the pre-quantized artifact: radvlm_7b int4, save_quantized -> worker_cli")
    counts["int4"] = phase_artifact(dev, args.seed, ctx)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7b/9] fused W8A8 (K13) on the int8 model")
    counts["fused"] = phase_fused(ctx)
    del ctx  # the int8 model goes before the trainers' come
    gc.collect()
    torch.cuda.empty_cache()

    header("[8/9] SFT: radvlm_0_5b, f32 master weights, every part tunable, training.loop.train")
    counts["sft"] = phase_sft(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[9/9] QLoRA: radvlm_7b, int8 base, rank-128 adapters, training.loop.train")
    counts["qlora"] = phase_qlora(dev, args.seed)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[path][name], **results[name]}
        for name, (src, replaces, path) in KERNELS.items()
    ]}
    header("done")
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
