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
7c. batch evaluation on the int8 model of phase 5: a synthetic test split
   written under build/ from --seed in the public archives' layouts (a
   MIMIC-CXR-JPG and a VinDr-CXR tree: CSVs by the stdlib csv module, 16
   CXR-sized JPEGs each), then `build_task_dataset` + `run_task` (the
   continuous engine: 8 slots, the int8 KV cache, 32 new tokens) over the
   16 samples of abnormality_classification, of abnormality_grounding and
   of report_generation (scored by the port's own ROUGE, BLEU-4 and
   CIDEr-D). Every sample must have a result cell carrying its question,
   answer and ground truth (a report's `txt`), both files
   (`{model}_{task}_output.json`, `{model}_{task}.json`) must hold the
   run's cells and metrics, the metric keys must be the JAX package's for
   the task and every value finite, and a second run of the first task
   must give every text again. K1, K2, K3, K4 and K5/K6 must have
   launched. Samples/s of each task (with the card's name and power
   limit), the feeder's host seconds against the engine's host_stats, and
   the provenance are printed;
7d. text-LM serving, the GREEN judge and the local LLM client: an HF Llama
   directory at meta-llama/Llama-2-7b-hf's widths (MHA: 32 heads and 32
   KV heads of 128, vocab 32000), cut to 8 of its 32 layers, with random bf16
   weights made on the card from --seed is written under build/ by
   `safetensors_io.write_file` (size, seconds and free disk printed; it
   fails before writing if the disk is short; deleted afterwards).
   `make_torch_judge` (TextLMEngine: 8 slots, 64 new tokens, the bf16
   cache, a byte tokenizer of this script) loads it; a reference check of
   one GREEN prompt (prefill and first-decode logits, `check_against_f32`),
   then `green_batched` over 16 synthetic report pairs with the launch
   counts reset: K2 and K9 must have launched; pairs/s, decode tokens/s and
   host_stats are printed; then `engine_kernels` holds K2 (a fill of the
   prompt bucket, left-padded to the run's shortest and longest prompt) and
   K9 (the engine's own cache after the run, its first and last layer) to
   their plain versions at the judge's shapes; a repeat of the batch and
   each request alone must give the same tokens; a decode chunk runs under
   the sync check, timed and profiled (so does one of the int8 judge
   below). Then, the bf16 judge freed, the int8 judge as a
   `LocalTorchClient` (llama_2 template): the int8 reference check of one
   GREEN prompt with the bf16 cache (`check_int8_against_f32`), then
   `synth.filter_reports` over 8 synthetic reports (8 files; K2, K3, K5/K6
   and K9 must have launched, and the provenance must name the W8A8 fill
   and the int8 decode), `engine_kernels` again, now with K3 at a fill's
   rows and K5/K6 at 8 rows on the last layer's and the lm_head's own int8
   weights, and `evaluate_conversations` over 4 two-turn conversations replayed on
   phase 5's int8 model, the client as the judge: every replay must give
   two answers and the judge must be called once a sample (with random
   weights its scores may not parse: n is printed, not checked);
7e. the serving front on the int8 model of phase 5: the port's
   `Controller` on 127.0.0.1:0, a `BatchWorker` registered with it through
   `controller_address` (8 slots, the int8 cache, phase 5's buckets, 8-step
   chunks) and the web UI (`WebApp` + `make_handler`) on a third port,
   launch counts reset, then HTTP only: `/api/new` lists the model; a
   first `/api/chat` turn with one CXR-sized image (greedy, 32 new tokens)
   must give the text of the same rendered prompt sent straight to the
   worker (through the chat CLI's `stream_request`) and arrive in more than
   one piece, the first before the last; a second turn must be one delta
   prefill (`resume_fills` + 1) whose text is a full prefill's (or differs
   at a near tie, as in phase 6); `/api/regenerate` must give the full
   prefill's text again without a resume; `/v1/chat/completions` through
   the controller, plain and streamed, must give the worker's own answer;
   the conversation log (under build/, deleted) must hold one chat record
   a turn with the image as its sha256. K1, K2, K3, K4 and K5/K6 must have
   launched. The first and last chunk times, direct and through web ->
   controller -> worker, are printed with the card's name and power limit;
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
   tower, K3 and K5/K6 never launch;
10. DPO and GRPO, radvlm_0_5b at full width and depth, f32 master weights
   made on the card from --seed, the language model tunable (the tower and
   projector frozen, the trainers' default), remat on. DPO: a reference check
   of the DPO loss and its per-group gradient norms on one small pair batch
   (the rule of phase 8, against a reference model whose final norm is
   perturbed), then `dpo.train_dpo` over a preference json of synthetic
   CXR-sized PNGs written under build/: 2 pairs a micro-step in the 4096
   bucket, 4 steps (no checkpoint: writing and restoring one repeated
   phase 8's checkpoint at the same model size, and
   tests/test_torch_dpo.py holds the DPO resume). The first step's loss
   must be ln 2 to within 1e-3
   (policy = reference); K1 (4 tower passes a step), K2 (the reference's two
   decoder passes), K2-lse, K7 and K8 (the policy's two) must launch exactly
   that often and nothing else must; 4 constant-rate steps on one pair batch
   must raise the reward margin; one step is profiled. 10b. GRPO:
   `grpo.train_grpo` over a GRPO-REC jsonl of synthetic CXR images with the
   rec reward, 2 prompts x 4 completions a wave, temperature 1, 32 new
   tokens, the rollouts through a ContinuousBatcher (8 slots, the 4096
   prompt bucket, max_len 4608, 6 pad tiles, the bf16 cache) over a bf16
   copy of the policy, 2 waves at mu = 1 and then a run of one wave at
   mu = 2. A byte tokenizer that reads one id in 8 as a box lets the random
   model's completions earn rewards that differ. Every wave's first update
   must be unclipped, each run's first at KL < 1e-5 (the policy is its
   reference), and after every weight sync the rollout copy must equal a
   fresh bf16 copy of the policy, tensor for tensor. K1, K2 (fills and the
   reference and score passes) and K9 (decode) must launch in the rollouts,
   K2-lse, K7 and K8 in the updates, with exact counts (K9's a multiple of
   the layers); seconds a wave (rollout, reward, update, sync), decode
   tokens/s and peak memory are printed. The rollout engine is the one
   `train_grpo` builds itself (a recording subclass of ContinuousBatcher
   shows it to the phase). After the run `engine_kernels` holds K2 (a fill
   of the 4096 bucket left-padded to the shortest and the longest rollout
   prompt, 2 rows, GQA 14|2 x 64) and K9 (the last engine's own cache and
   segment ids, every slot, layers 0 and 23) against their plain versions;
11. the decoder families, each radvlm_7b's SigLIP tower and mlp2x_gelu
   projector into a decoder preset at full width, weights born int8 on the
   card from --seed (an MoE's router and experts dense bf16, as the JAX
   quantizer leaves them): the int8 reference check on one small image
   prompt, then a BatchWorker (8 slots, the int8 cache, 8-step chunks)
   serving concurrent greedy requests with CXR-sized images over HTTP,
   launch counts from 0 after its warmup. The provenance must name the
   kernel route for the prefill and decode attention where the dispatch's
   predicates take it (K2 and K4 launched) and the plain route elsewhere
   (neither launched); K1, K3 and K5/K6 launch in every family and no
   other kernel does; a prefill of the last prompt on the engine's routes
   gives finite logits. After the run `engine_kernels` holds the path's
   kernels at the family's own shapes against their plain versions: K2 (a
   fill of the served bucket left-padded to the shortest and the longest
   prompt) and K4 (the engine's own int8 cache and segment ids, every slot,
   the first and the last layer) where the family takes them, K3 at a
   fill's rows and K5/K6 at the 8 slots' rows on the last layer's own int8
   projections and lm_head (not the dense experts, not a tied head). 11a: LLaVA-Mixtral-8x7B (8 experts of 14336, top-2, exact mode)
   cut to 8 of its 32 layers (the bf16 experts take 2.82 GB a layer),
   buckets 3072-4096, 4 requests. 11b: LLaVA-MPT-7B (ALiBi, LayerNorm, a
   non-gated GELU MLP, a tied lm_head; plain attention) cut to
   FAMILY_LAYERS of its 32 layers (the script's time, PR 20); its
   2048 positions keep the prompts to one 384-px tile ("pad") in the 1024
   bucket, 4 requests. Both time and profile a decode chunk of every slot.
   11c: Llama-3-8B (the kernels), Mistral-7B (its 4096-token window: plain
   attention; one prompt of 4080 tokens, so decode crosses the window) and
   Gemma-2B (head_dim 256: plain attention), each cut to FAMILY_LAYERS of
   its layers (the script's time), 2 requests each;
12. M10's towers and resamplers, each served as a family of phase 11 in
   front of Qwen2-7B cut to TOWER_DECODER_LAYERS of its 28 layers (the
   script's time, PR 20; so too the int8 model and EVA-CLIP-8B's f32
   reference copy fit) (weights born int8, the int8 reference check, a
   BatchWorker of 8 slots on the int8 cache, 8-step chunks, 4 CXR requests
   of 32 greedy tokens, a prompt bucket fitted to the requests): 12a CLIP
   ViT-L/14-336 with S2 at 336 / 672 / 1008 px (23 layers, 14 crops a tile,
   features 3072 wide), 12b EVA02-CLIP-L-14-336 (rope, subln, swiglu), 12c
   EVA-CLIP-8B (32 x 4096, D = 128, 224 px), 12d
   ImageBind-huge (one pooled token, "pad"), 12e radvlm_7b's SigLIP with a
   Q-Former (bert-base, 32 queries, "pad"; its attention plain, as the
   provenance must say) and with spatial_pool (stride 2, anyres). The
   shapes K1 ran at in the measured run must be the tower's own
   ([n, tokens + class token, heads, head_dim]); after the run a fill of
   one request is timed and profiled, K1 at the largest of those shapes is
   held to its plain version and timed beside SDPA and its bound, and K3
   at the tower pass's rows on the last tower layer's own int8 projections
   must equal its plain version. 12f: `training.loop.train` runs 2
   micro-steps (one update) of radvlm_0_5b's decoder under a tunable
   CLIP-L/14-336 tower with the masked_drop resampler on packed
   2048-token rows: the loss finite, the tower's gradient non-zero, and
   K2-lse, K7 and K8 called at the tower's [n, 577, 16, 64].
13. M12's serving layouts on the card (`parallel/`), over radvlm_7b's int8
   weights made once from --seed (the decoder cut to LAYOUT_LAYERS of its
   28 layers, the script's time, PR 20) and 8 anyres CXR prompts, first
   served by
   a one-card engine (4 slots, the int8 cache, 32 greedy tokens) whose
   tokens, logits and decode step the layouts are held to. 13a: a TP = 2
   engine, two processes spawned on the card over gloo (which carries
   all_reduce of CUDA tensors), each making the same weights and sharding
   them: 4 requests with the launch counts from 0 (K1, K2 at 14 local
   heads, K3, K4, K5/K6 on every rank), then on each rank K2, K4, K3 and
   K5/K6 held to their plain versions at the rank's local shapes (its own
   cache and sharded projections), the prefill and first-step logits
   within 0.03 of the one-card engine's maximum (the int8 rule's allowance;
   W8A8 of a row-parallel layer quantizes the rank's half of K), the greedy
   tokens counted against its, a decode step timed against its; then
   spec_k = 3 on the same ranks (K11), whose tokens must be TP greedy's or
   leave them only at a near tie. 13b: `make_sp_generate_fn` over one
   prompt of the 4096 bucket, the bf16 and then the int8 cache, one rank
   under NCCL (gloo sends no CUDA tensor point to point): K1, K2-lse once a
   layer for the ring's one pair, K3, K5/K6, no K2 or K4; the int8 cache's
   tokens the bf16 cache's (or a near tie); the ring prefill's and one SP
   decode step's logits against the one-card engine's. 13c: a fleet of two
   engines on the card sharing the model, the 8 requests (the one engine's
   tokens, or a near tie), overlapping busy windows, engine 0's kernels
   held to their plain versions on its 4-slot cache, then a keep_kv turn
   whose resume goes back to the engine that holds its rows and gives a
   full re-prefill's tokens (or a near tie).
14. M12's training half (`parallel/sharding.py`, `parallel/ring.py`,
   `parallel/pp.py`) on radvlm_0_5b at full width and depth, f32 masters
   from the seed, two of phase 8's packed 4096-token rows: the one-card
   LoRA step (rank 16 over the frozen f32 base) and the one-card step (one
   profiled micro-step each; the second saved while the ranks run); the
   two processes on the card over gloo (which reduce-scatters and
   all-gathers CUDA tensors) start up meanwhile and then take one profiled
   micro-step a case: 14a ZeRO-3
   `{fsdp: 2}` (saved), 14b TP `{tensor: 2}` (7 | 1 local heads), 14d GPipe
   and 14e the interleaved schedule (V = 2) over `{stage: 2}`, 2
   microbatches of one row, the hop through host memory, and 14f the LoRA
   step under TP: the loss and grad norm against the one-card step's (2e-3
   for 14a, 14d, 14e; 2e-2 for 14b and, against the one-card LoRA step,
   14f), the peak memory a rank, the hop's transport, and for 14d-14f the
   K2-lse / K7 / K8 (and K1) launches a rank exactly (stage 0 the tower and
   12 layers x 2 microbatches, stage 1 12 x 2); 14g `read_params` of 14a's
   step against the one-card step's, leaf for leaf within 2.5 x lr; 14c the
   zigzag ring at seq = 1 on one NCCL rank, three K2-lse pairs a decoder
   layer: the launch counts exactly 2 x (3 x 24 + 26) K2-lse and 3 x 24 + 26
   K7 / K8, the loss and grad norm within 2e-2, and K2-lse, K7 and K8 at the
   half-chunk shape [2, 2048, 14 | 2, 64] (causal and full) held to their
   plain versions, timed beside SDPA and their bounds.

Ends with a JSON line of per-kernel results and then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import threading
import time
import types
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.config import (gemma_2b, llama3_8b, mistral_7b, mixtral_8x7b, mpt_7b,
                                     radvlm_0_5b, radvlm_7b)
from radvlm_tpu_torch.data.loader import Bucket, LlavaJsonDataset, PrefetchLoader
from radvlm_tpu_torch.data.chat import QWEN_CHATML, TEMPLATES, render_generation_prompt
from radvlm_tpu_torch.data.datasets import CHEXPERT_PATHOLOGIES
from radvlm_tpu_torch.eval.harness import (GT_FIELDS, VLMRunner, batch_to_device,
                                           build_task_dataset, run_task)
from radvlm_tpu_torch.eval.metrics import evaluate_reports
from radvlm_tpu_torch.generation import engine
from radvlm_tpu_torch.generation.engine import GenerationConfig
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
from radvlm_tpu_torch.config import ResamplerConfig, tokens_per_tile
from radvlm_tpu_torch.models import (convert, multimodal, quant_io, radvlm, safetensors_io,
                                     towers)
from radvlm_tpu_torch.models.layers import QLinear
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as da
from radvlm_tpu_torch.ops import flash_attention as fa
from radvlm_tpu_torch.ops import int4_matmul as i4
from radvlm_tpu_torch.ops import int8_matmul as i8
from radvlm_tpu_torch.ops import kv_quant
from radvlm_tpu_torch.ops import quant as tquant
from radvlm_tpu_torch.ops import w8a8_matmul as w8
from radvlm_tpu_torch.parallel import mesh as pmesh
from radvlm_tpu_torch.parallel import tp as tplib
from radvlm_tpu_torch.serve import cli as chat_cli
from radvlm_tpu_torch.serve import controller as front
from radvlm_tpu_torch.serve import openai_api as oai
from radvlm_tpu_torch.serve import web as web_ui
from radvlm_tpu_torch.serve import worker_cli
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from radvlm_tpu_torch.serve.fleet import FleetEngine
from radvlm_tpu_torch.serve.worker import ModelWorker
from radvlm_tpu_torch.training import dpo as dpo_lib
from radvlm_tpu_torch.training import grpo as grpo_lib
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
EVAL_SAMPLES, EVAL_SLOTS = 16, 8  # per task of the evaluation phase
EVAL_TASKS = ("abnormality_classification", "abnormality_grounding", "report_generation")
FRONT_MODEL, FRONT_STEPS = "radvlm-7b-int8", 8  # the serving front's worker: 8-step chunks
QUESTIONS = ("Write the findings section of the report.", "Is there a pleural effusion?",
             "Describe the cardiac silhouette.", "Is there a pneumothorax?")
# The text-LM phase: the GREEN judge at meta-llama/Llama-2-7b-hf's config.json
# (the base of StanfordAIMI/GREEN-radllama2-7b), random bf16 weights, cut to
# 8 of its 32 layers: its steps are host-bound and their time grows with the
# depth, and the phase replays its 16 requests one at a time too. At 32
# layers (149 s for this phase) the whole script took 1039 s of its 1200 on
# an H100 80GB HBM3 host, at 16 layers 958 s (91 s); phase 14 came after.
JUDGE_LAYERS = 8
LLAMA2_7B = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 4096,
             "intermediate_size": 11008, "num_hidden_layers": JUDGE_LAYERS,
             "num_attention_heads": 32,
             "num_key_value_heads": 32, "vocab_size": 32000, "rms_norm_eps": 1e-5,
             "rope_theta": 10000.0, "max_position_embeddings": 4096, "hidden_act": "silu",
             "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
             "torch_dtype": "bfloat16"}
JUDGE_PAIRS, JUDGE_SLOTS, JUDGE_NEW = 16, 8, 64  # GREEN report pairs, slots, tokens a reply
JUDGE_REPORTS, JUDGE_CONVERSATIONS, CONV_NEW_TOKENS = 8, 4, 16
REPORT_SENTENCES = ("The heart size is normal.", "There is a small left pleural effusion.",
                    "No pneumothorax.", "Mild pulmonary edema.", "Lines and tubes in place.",
                    "Compared to the prior study, the cardiomediastinal silhouette is stable.",
                    "There is a right lower lobe opacity, possibly atelectasis.",
                    "Moderate cardiomegaly.", "No acute cardiopulmonary process.")

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
    # Evaluation (run_task) on the int8 model: phase 5's path.
    "eval": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
             "int8_matmul"),
    # The serving front (web UI -> controller -> BatchWorker) on the int8 model.
    "front": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
              "int8_matmul"),
    # Phase 13: the TP engine's ranks (K2, K3, K4, K5/K6 at the local
    # shapes), spec_k on them (K11), the SP generation (K1 on the replicated
    # tower, K2-lse in the ring's pairs, K3, K5/K6), and the fleet.
    "tp": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
           "int8_matmul"),
    "tp_spec": ("tower_attention", "prefill_attention", "w8a8_matmul", "int8_matmul",
                "decode_attention_window_q8"),
    "sp": ("tower_attention", "prefill_attention_lse", "w8a8_matmul", "int8_matmul"),
    "fleet": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
              "int8_matmul"),
    # The GREEN judge (Llama-2-7B, MHA) on TextLMEngine: bf16, then int8
    # (W8A8 fills, weight-only int8 decode), both over the bf16 cache.
    "text_lm": ("prefill_attention", "decode_attention"),
    "text_lm_int8": ("prefill_attention", "w8a8_matmul", "int8_matmul", "decode_attention"),
    # Full finetuning: every attention is under a gradient, the tower's too.
    "sft": ("prefill_attention_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    # QLoRA: the decoder as above, the frozen tower through K1.
    "qlora": ("tower_attention", "prefill_attention_lse", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"),
    # DPO of radvlm_0_5b, the tower frozen: K1 in every pass, K2 in the
    # reference's (no gradient), K2-lse, K7 and K8 in the policy's.
    "dpo": ("tower_attention", "prefill_attention", "prefill_attention_lse",
            "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    # 14c: the zigzag ring's pairs and the tower's attention under a gradient.
    "mesh_ring": ("prefill_attention_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    # GRPO: the rollouts' fills (K1, K2) and decode over the bf16 cache (K9),
    # the updates as DPO's.
    "grpo": ("tower_attention", "prefill_attention", "decode_attention", "prefill_attention_lse",
             "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
}
TRAIN_BUCKET = Bucket(4096, 6)
SFT_STEPS, SFT_RESUMED_STEPS, OVERFIT_STEPS, QLORA_STEPS = 6, 2, 4, 2
# Phase 10: DPO pairs a micro-step and steps, GRPO waves at mu = 1 and then
# at mu = 2, and the GRPO rollout engine.
DPO_PAIRS, DPO_STEPS = 2, 4
GRPO_CELLS, GRPO_WAVES = 4, 2
GRPO = dict(prompts_per_wave=2, group_size=4, temperature=1.0, max_new_tokens=32, reward="rec")
GRPO_SLOTS, GRPO_MAX_LEN, GRPO_PAD_TILES = 8, 4608, 6
LORA_RANK = 128
SPEC_K = 4
K5_ROWS = (8, 32, 40)  # decode slots, and a verify step of 8 slots x (SPEC_K + 1)
SPEC_BUCKETS = (3456, 3840)
# Phase 11: the decoder families. Mixtral's bf16 experts take 2.82 GB a
# layer, so 8 of its 32 layers (and the f32 copy of the reference check)
# fit the card; MPT has 2048 positions, so its prompts are one 384-px tile
# in the 1024 bucket; one Mistral prompt of 4080 real tokens in the 4096
# bucket, whose 32 decode steps cross its 4096-token window.
MIXTRAL_LAYERS, FAMILY_SLOTS, FAMILY_STEPS = 8, 8, 8  # layers, slots, steps a chunk
MPT_BUCKETS, MPT_MAX_LEN = (1024,), 1152
MISTRAL_LONG_PROMPT = 4080
# Phase 12: the towers. S2 over the 336-px tile at 1x, 2x and 3x (14 crops a
# tile); EVA-CLIP-8B's int8 tower (7.5 GB) and its f32 reference copy
# (30 GB) leave room for 8 of the decoder's 28 layers beside the check's
# f32 decoder; the tunable tower trains 2 micro-steps of one image cell and
# one text cell a packed 2048-token row.
S2_SCALES = (336, 672, 1008)
TOWER_DECODER_LAYERS = 8
TOWER_REQUESTS = 4
TOWER_SFT_STEPS = 2
TOWER_TRAIN_BUCKET = Bucket(2048, 4)
FAMILY_BUCKETS = (3840, 4096)  # 11c: the buckets its prompts fill, warmed up alone
FAMILY_LAYERS = 8  # 11c: the depth each family is cut to
# Phase 13: M12's serving layouts on the one card. 13a: a TP = 2 engine (two
# processes on the card over gloo) serving LAYOUT_REQUESTS[:TP_REQUESTS] at
# LAYOUT_SLOTS slots, 32 new tokens, then spec_k = TP_SPEC_K; 13b: one prompt
# in the 4096 bucket through make_sp_generate_fn (SP_BACKEND, SP_WORLD);
# 13c: a fleet of FLEET_SIZE engines on the card over all LAYOUT_REQUESTS,
# then a keep_kv turn and its resume.
LAYOUT_REQUESTS, TP_REQUESTS, LAYOUT_SLOTS, LAYOUT_STEPS = 8, 4, 4, 8
LAYOUT_LAYERS = 8  # of radvlm_7b's 28 decoder layers: the script's time (PR 20)
TP_WORLD, TP_SPEC_K = 2, 3
SP_NEW, SP_BUCKET = 16, 4096
SP_BACKEND, SP_WORLD = "nccl", 1  # gloo sends no CUDA tensor point to point (PERF.md)
FLEET_SIZE = 2
# Phase 14: M12's training half on radvlm_0_5b, MESH_ROWS packed 4096-token
# rows; 14a (ZeRO-3, fsdp = 2) and 14b (TP = 2) run as two processes on the
# card over gloo, which reduce-scatters and all-gathers CUDA tensors
# (tools/torch_gloo_probe.py). Bounds on the loss and grad norm against the
# one-card step, relative.
MESH_ROWS = 2
FSDP_TOL, TP_TRAIN_TOL, RING_TOL = 2e-3, 2e-2, 2e-2
# 14d / 14e: the pipeline over {stage: MESH_STAGES} (GPipe, then the
# interleaved schedule), PP_MICROBATCHES microbatches of one row; 14f:
# rank-MESH_LORA_RANK adapters under TP = 2, against the one-card LoRA step.
# Every step runs at a constant MESH_LR, warmup 0; 14g holds the ZeRO-3
# step's read_params to the one-card step's within 2.5 x MESH_LR.
MESH_STAGES, PP_MICROBATCHES, PP_INTERLEAVE, MESH_LORA_RANK = 2, 2, 2, 16
PP_TOL, LORA_TP_TOL = 2e-3, 2e-2
MESH_LR = 1e-5
LAYOUT_LOGITS_TOL = 0.03  # the int8 rule's allowance for W8A8 and the int8 cache
FAMILY_KERNELS = ("tower_attention", "w8a8_matmul", "int8_matmul")  # K1, K3, K5/K6
# K2 and K4: not under ALiBi, a sliding window or head_dim 256.
FAMILY_ATTENTION = ("prefill_attention", "decode_attention_q8")
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


class JudgeTokenizer(CharTokenizer):
    """CharTokenizer behind the methods TextLMEngine calls on an HF
    tokenizer, for a judge of `vocab_size` ids: text beyond ASCII (another
    model's answers, decoded by CharTokenizer) maps to the id `unk` where
    its id would fall outside the judge's vocabulary, and every id the
    judge emits decodes to a character of its own."""

    eos_token_id, pad_token_id, unk_token_id = 1, 0, None
    unk = 2  # the id of a NUL byte, which no prompt holds

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text, add_special_tokens=True):
        ids = [i if i < self.vocab_size else self.unk for i in self.encode(text)]
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=True):
        return super().decode(ids)

    def convert_tokens_to_ids(self, token):
        return None  # no stop string is one token here


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
    for label, *shape in shapes:
        r_lse, r_dkv, r_dq = training_kernel_case(dev, g, randn, label, *shape)
        if label == "0.5B decoder":
            results.update(prefill_attention_lse=r_lse, flash_attention_bwd_dkv=r_dkv,
                           flash_attention_bwd_dq=r_dq)
    return results


def training_kernel_case(dev, g, randn, label, b, s, h, hkv, d, causal, layout):
    """K2 writing the lse, K7 and K8 at one shape against their plain
    versions, each timed beside SDPA and its bound. `layout` is None (no
    mask), "packed" or "left_pad". Returns the three kernels' numbers."""
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
    del q, k, v, do, o, lse, dlse, delta, dk, dv, dq, mask
    torch.cuda.empty_cache()
    return r_lse, r_dkv, r_dq


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
    """The slice on one small input at full width (`check_against_f32`)."""
    cfg, tok = runner.cfg, runner.tokenizer
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(tok.encode, prompt(runner, "Any effusion?"))
    batch = multimodal.collate([multimodal.build_sample(ids, [img], cfg)],
                               pad_to_multiple=512, left_pad=True)
    check_against_f32(runner.model, cfg, batch_to_device(batch, runner.device))


def check_against_f32(model, cfg, batch, label: str = "") -> None:
    """One input three ways: kernels in bf16, plain attention
    (attn_impl="xla") in bf16, and plain attention on an f32 copy of the
    same (fused) weights (the reference). Prefill logits and one decode
    step; the kernel path must be about as close to the f32 reference as
    the plain bf16 path is (within 2x, or 1e-2)."""
    l = batch["tokens"].shape[1]
    max_len = engine.cache_length(l, 8)
    ref32 = radvlm.fuse_for_inference(
        radvlm.RadVLM(cfg, device=model.device, dtype=torch.float32), cfg)
    ref32.load_state_dict(model.state_dict())
    logits, tok0 = {}, None
    for name, m, impl in (("f32 plain", ref32, "xla"), ("kernels", model, "auto"),
                          ("bf16 plain", model, "xla")):
        cache, cache_seg, lg = engine.prefill(m, cfg, batch, max_len, attn_impl=impl)
        if tok0 is None:  # every path decodes the reference's greedy token
            tok0 = lg.argmax(-1)
        _, _, lg1 = engine.decode_step(m, cfg, cache, cache_seg, tok0,
                                       batch["lengths"].to(model.device), l, attn_impl=impl)
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
        print(f"  {label}{stage} logits [{ref.shape[0]},{ref.shape[1]}], prompt {l} tokens, max "
              f"rel err vs f32: kernels {err['kernels']:.3e}, plain bf16 {err['bf16 plain']:.3e}; "
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


def reference_check_int8(model, cfg, tok, rng, label: str = "int8 ") -> None:
    """`check_int8_against_f32` on one small image prompt, the kernels
    writing the int8 cache (K3/K4/K5)."""
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(
        tok.encode, "<|im_start|>user\n<image>\nAny effusion?<|im_end|>\n<|im_start|>assistant\n")
    batch = multimodal.collate([multimodal.build_sample(ids, [img], cfg)],
                               pad_to_multiple=128, left_pad=True)
    check_int8_against_f32(model, cfg, batch_to_device(batch, model.device), "int8", label)


@contextlib.contextmanager
def plain_matmuls():
    """The quantized projections through the plain versions of K3 and K5/K6:
    `ops.quant.qmm` calls the wrappers by these names. For a reference path
    of the kernel path's own arithmetic."""
    def w8a8_plain(xq, xs, wq, ws, *, out_dtype=torch.bfloat16):
        lead, k = xq.shape[:-1], xq.shape[-1]
        return w8.w8a8_matmul_plain(xq.reshape(-1, k), xs.reshape(-1).float(), wq, ws.float(),
                                    out_dtype).reshape(*lead, wq.shape[0])

    def int8_plain(x, w, scale):
        lead, k = x.shape[:-1], x.shape[-1]
        return i8.int8_matmul_plain(x.reshape(-1, k), w, scale).reshape(*lead, w.shape[0])

    saved = tquant.w8a8_matmul, tquant.int8_matmul
    tquant.w8a8_matmul, tquant.int8_matmul = w8a8_plain, int8_plain
    try:
        yield
    finally:
        tquant.w8a8_matmul, tquant.int8_matmul = saved


def check_int8_against_f32(model, cfg, batch, cache_format: str, label: str,
                           same_arithmetic: bool = False) -> None:
    """The int8 path on one input at full width, three ways: the kernels
    (W8A8 prefill, K5/K6 decode, the cache in `cache_format`), the same
    int8 weights weight-only (RADVLM_W8A8=0) with plain attention and a
    bf16 cache, and the reference: plain attention on an f32 copy of the
    dequantized weights. Prefill logits and one decode step. The kernel
    path must stay within 2x the weight-only path's error plus 0.03: on the
    CPU, W8A8 and the int8 cache add ~1e-3 per two layers of the tiny
    config over the weight-only path (PERF.md), ~0.015 over Qwen2-7B's 28
    layers, doubled.

    With `same_arithmetic`, a fourth path runs the kernel path's own
    arithmetic (W8A8, the cache in `cache_format`) through the plain
    versions of its kernels (`plain_matmuls`, plain attention), and the
    kernel path must instead be about as close to the reference as that
    path is (within 2x, or 1e-2), the rule `check_against_f32` holds the
    bf16 kernels to. The int8 judge needs it: at Llama-2-7B's widths with
    random weights, W8A8 itself moves the logits several times as far as
    the weight-only path's bf16 rounding does (PERF.md, §6)."""
    l = batch["tokens"].shape[1]
    max_len = engine.cache_length(l, 8)
    ref32 = convert.dequantized_copy(model, cfg, torch.float32)
    logits, tok0 = {}, None
    paths = [("f32 plain", ref32, "xla", "bf16", "1"),
             ("kernels", model, "auto", cache_format, "1"),
             ("weight-only plain", model, "xla", "bf16", "0")]
    if same_arithmetic:
        paths.append(("W8A8 plain", model, "xla", cache_format, "1"))
    for name, m, impl, fmt, w8a8 in paths:
        os.environ["RADVLM_W8A8"] = w8a8
        try:
            with plain_matmuls() if name == "W8A8 plain" else contextlib.nullcontext():
                cache, cache_seg, lg = engine.prefill(m, cfg, batch, max_len, attn_impl=impl,
                                                      cache_format=fmt)
                if tok0 is None:  # every path decodes the reference's greedy token
                    tok0 = lg.argmax(-1)
                _, _, lg1 = engine.decode_step(m, cfg, cache, cache_seg, tok0, batch["lengths"],
                                               l, attn_impl=impl)
        finally:
            os.environ.pop("RADVLM_W8A8")
        logits[name] = (lg.float(), lg1.float())
        del cache
    del ref32
    torch.cuda.empty_cache()
    for i, stage in enumerate(("prefill", "decode")):
        ref = logits["f32 plain"][i]
        err = {}
        for name, _, _, _, _ in paths[1:]:
            out = logits[name][i]
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"int8 reference check: {name} {stage} logits malformed")
            err[name] = float((out - ref).abs().max() / ref.abs().max())
        if same_arithmetic:
            bound = max(2 * err["W8A8 plain"], 1e-2)
            plain = logits["W8A8 plain"][i]
            gap = float((logits["kernels"][i] - plain).abs().max() / ref.abs().max())
            w8a8_plain = (f", W8A8 plain {err['W8A8 plain']:.3e} (argmax {int(plain.argmax())}; "
                          f"the kernels off it by {gap:.3e})")
        else:
            bound, w8a8_plain = 2 * err["weight-only plain"] + 0.03, ""
        print(f"  {label}{stage} logits [{ref.shape[0]},{ref.shape[1]}], prompt {l} tokens, max "
              f"rel err vs f32: kernels {err['kernels']:.3e}, weight-only plain "
              f"{err['weight-only plain']:.3e}{w8a8_plain} (bound {bound:.3e}); argmax f32 "
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
    """Every slot filled with `req`'s prompt (and `image`, if not None; the
    engine thread is stopped), then three greedy
    decode chunks (verify chunks on a spec engine): one under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host sync
    inside it; one timed by the host's clock; one under torch.profiler
    (device time by kernel, busy share). Returns the timed chunk's ms per
    step."""
    from torch.profiler import ProfilerActivity, profile

    sample = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, req["prompt"]),
                                     [] if image is None else [image], cfg)
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


def write_eval_split(root: str, rng, n: int) -> None:
    """A synthetic test split under `root` in the layouts of the public
    archives (those of tests/test_datasets.py): MIMIC-CXR-JPG (metadata,
    split, CheXpert labels with missing and uncertain values, reports) and
    VinDr-CXR (two radiologists' boxes an image, fused by WBF), `n` frontal
    CXR-sized JPEGs each. CSVs by the stdlib csv module, images by PIL."""
    import csv

    from PIL import Image

    def table(path, rows):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(rows)

    def jpg(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(cxr_image(rng)).save(path, quality=90)

    mimic, vindr = os.path.join(root, "MIMIC-CXR-JPG"), os.path.join(root, "VinDr-CXR")
    dicoms = [(f"dcm{i:03d}", 10000000 + i, 50000 + i) for i in range(n)]
    table(f"{mimic}/mimic-cxr-2.0.0-metadata.csv",
          [["dicom_id", "subject_id", "study_id", "ViewPosition", "Rows", "Columns"]]
          + [[d, s, st, ("PA", "AP")[i % 2], 3000, 2500] for i, (d, s, st) in enumerate(dicoms)])
    table(f"{mimic}/mimic-cxr-2.0.0-split.csv", [["dicom_id", "subject_id", "study_id", "split"]]
          + [[d, s, st, "test"] for d, s, st in dicoms])
    labels = CHEXPERT_PATHOLOGIES[:6] + ["No Finding"]
    table(f"{mimic}/mimic-cxr-2.0.0-chexpert.csv", [["subject_id", "study_id"] + labels]
          + [[s, st] + [rng.choice(["1.0", "0.0", "-1.0", "", ""]) for _ in labels]
             for _, s, st in dicoms])
    sentences = ["The heart size is normal.", "There is a small left pleural effusion.",
                 "No pneumothorax.", "Mild pulmonary edema.", "Lines and tubes in place."]
    table(f"{mimic}/reports.csv", [["study", "findings", "impression", "last_paragraph"]]
          + [[f"s{st}", " ".join(rng.choice(sentences, 3)), "No acute process.", ""]
             for _, _, st in dicoms])
    for d, s, st in dicoms:
        jpg(f"{mimic}/files/p{str(s)[:2]}/p{s}/s{st}/{d}.jpg")
    classes = ["Cardiomegaly", "Pleural effusion", "Nodule/Mass", "Aortic enlargement"]
    ann = [["image_id", "class_name", "rad_id", "x_min", "y_min", "x_max", "y_max"]]
    for i in range(n):
        x, y = rng.uniform(100, 1200, 2)
        for rad in ("R1", "R2"):
            jit = rng.uniform(-20, 20, 4)
            ann.append([f"img{i:03d}", classes[i % len(classes)], rad, x + jit[0], y + jit[1],
                        x + 500 + jit[2], y + 400 + jit[3]])
        jpg(f"{vindr}/test_jpg/img{i:03d}.jpg")
    table(f"{vindr}/annotations/annotations_test.csv", ann)
    with open(f"{vindr}/annotations/image_resolutions_test.json", "w") as f:
        json.dump({f"img{i:03d}": [2048, 2500] for i in range(n)}, f)


def metric_keys_ok(task: str, metrics: dict) -> bool:
    """The JAX package's metric keys for `task` (eval/metrics/__init__.py)."""
    keys = set(metrics)
    if task == "abnormality_classification":
        return keys == {"Precision(macro)", "Precision(micro)", "Recall(macro)", "Recall(micro)",
                        "F1 Score(macro)", "F1 Score(micro)",
                        *(p.lower() for p in CHEXPERT_PATHOLOGIES)}
    if task == "abnormality_grounding":
        return keys - {"avg_iou"} == {"mAP_0.5"}
    return keys == {"blue", "ciderd", "rouge1", "rouge2", "rougel"}  # report_generation


def phase_eval(ctx, seed: int):
    """Batch evaluation on phase 5's int8 model: `build_task_dataset` +
    `run_task` (the continuous engine, int8 KV cache) over a synthetic split
    of each task in EVAL_TASKS; every sample's result cell, both files and
    the metrics are checked."""
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    # Phase 5's runner fused the model in place: this one must not fuse again.
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=EVAL_SLOTS, fuse=False, kv_quant=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_eval_{os.getpid()}")
    try:
        t0 = time.perf_counter()
        write_eval_split(root, np.random.default_rng(seed + 13), EVAL_SAMPLES)
        print(f"  synthetic split ({EVAL_SAMPLES} MIMIC-CXR + {EVAL_SAMPLES} VinDr-CXR JPEGs): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        out_dir = os.path.join(root, "results")
        first = {}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for task in EVAL_TASKS:
            dataset = build_task_dataset(task, root)
            if len(dataset) != EVAL_SAMPLES:
                raise AssertionError(f"{task}: {len(dataset)} samples, not {EVAL_SAMPLES}")
            stats: dict = {}
            t0 = time.perf_counter()
            results, metrics = run_task(runner, dataset, task, output_dir=out_dir,
                                        model_name="radvlm-7b-int8", with_clinical=False,
                                        stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            cells = {c["idx"]: c for c in results}
            if sorted(cells) != list(range(EVAL_SAMPLES)):
                raise AssertionError(f"{task}: result cells for {sorted(cells)}")
            for i, cell in cells.items():
                s = dataset[i]
                if (not isinstance(cell["output"], str)
                        or (task == "report_generation" and not cell.get("txt"))
                        or cell["instr"] != s["instr"]["question"]
                        or cell["answer"] != s["instr"]["answer"]
                        or any(cell[f] != s[f] for f in GT_FIELDS[task])):
                    raise AssertionError(f"{task}: cell {i} does not carry its sample: {cell}")
            base = os.path.join(out_dir, f"radvlm-7b-int8_{task}")
            with open(base + "_output.json") as f:
                saved_cells = json.load(f)
            with open(base + ".json") as f:
                saved_metrics = json.load(f)
            if saved_cells != json.loads(json.dumps(results)) or saved_metrics != {
                    k: float(v) for k, v in metrics.items()}:
                raise AssertionError(f"{task}: the files do not hold the run's cells and metrics")
            if not metric_keys_ok(task, metrics) or not all(
                    math.isfinite(v) for v in saved_metrics.values()):
                raise AssertionError(f"{task}: metrics {metrics}")
            hs = stats["host_stats"]
            if hs["fills"] != EVAL_SAMPLES or hs["tokens"] == 0:
                raise AssertionError(f"{task}: engine host_stats {hs}")
            first[task] = cells
            print(f"  {task}: {EVAL_SAMPLES} samples in {wall:.3f} s, "
                  f"{EVAL_SAMPLES / wall:.3f} samples/s ({EVAL_SLOTS} slots, {NEW_TOKENS} new "
                  f"tokens, bucket {stats['bucket']}, {hs['tokens']} tokens); "
                  f"{nvidia_smi_line()}", flush=True)
            print(f"  {task} host seconds: bucket sizing pass {stats['sizing_s']:.3f} s, feeder "
                  f"build_mm {stats['build_s']:.3f} s, engine wall {stats['engine_wall_s']:.3f} s; "
                  f"engine host_stats { {k: round(v, 3) for k, v in hs.items()} }", flush=True)
            print(f"  {task} metrics: { {k: round(v, 4) for k, v in metrics.items()} }",
                  flush=True)
            if task == "report_generation":
                # A random model's replies share no word with the reports:
                # the scorers are also read on the split's own reports.
                refs = [cells[i]["txt"] for i in range(EVAL_SAMPLES)]
                same = evaluate_reports(refs, refs, with_clinical=False)
                other = evaluate_reports(refs, refs[1:] + refs[:1], with_clinical=False)
                if not (same["rouge1"] == same["rouge2"] == same["rougel"] == 1.0
                        and 0 < other["rougel"] < 1 and 0 < other["rouge2"] < other["rouge1"]):
                    raise AssertionError(f"report metrics on the reports: {same}, {other}")
                print(f"  report metrics, each report against itself: "
                      f"{ {k: round(v, 4) for k, v in same.items()} }; against the next one: "
                      f"{ {k: round(v, 4) for k, v in other.items()} }", flush=True)
        counts = kernels.launch_counts()
        print(f"  launches in the measured run: {counts}", flush=True)
        print(f"  provenance: {stats['provenance']}", flush=True)
        require_launched("eval", counts)
        # Greedy evaluation is deterministic: a second run of the first task
        # (requests finish in another order) must give every sample's text again.
        task = EVAL_TASKS[0]
        again, _ = run_task(runner, build_task_dataset(task, root), task, with_clinical=False)
        if {c["idx"]: c["output"] for c in again} != {
                i: c["output"] for i, c in first[task].items()}:
            raise AssertionError(f"{task}: a second run gave other texts")
        print(f"  a second run of {task} gave every sample's text again", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def stream_timed(url: str, body: dict):
    """POST `body` and read the streamed answer piece by piece as it arrives
    (the port's `serve.controller.pieces`): (the body, seconds to each piece)."""
    t0 = time.perf_counter()
    raw, times = b"", []
    for piece in front.pieces(front.open_post(url, body, 600)):
        times.append(time.perf_counter() - t0)
        raw += piece
    return raw, times


def chunks_of(raw: bytes) -> list:
    return [json.loads(c) for c in raw.split(b"\0") if c]


def final_text(label: str, chunks: list) -> str:
    """The last text of a stream's chunks, which must hold no error chunk."""
    if not chunks or any(c.get("error_code") for c in chunks):
        raise AssertionError(f"front {label}: stream failed: {chunks[-1:]}")
    return chunks[-1]["text"]


def direct_stream(addr: str, payload: dict):
    """The worker's own stream through the chat CLI's `stream_request`:
    (the final text, seconds to each chunk)."""
    t0 = time.perf_counter()
    chunks, times = [], []
    for chunk in chat_cli.stream_request(addr, payload):
        times.append(time.perf_counter() - t0)
        chunks.append(chunk)
    return final_text("direct", chunks), times


def sse_text(raw: bytes) -> str:
    text = ""
    for line in raw.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            text += json.loads(line[6:])["choices"][0]["delta"].get("content") or ""
    return text


def phase_front(ctx, seed: int):
    """The serving front on phase 5's int8 model: the port's `Controller`, a
    `BatchWorker` registered with it (8 slots, the int8 cache, phase 5's
    buckets, 8-step chunks) and the web UI (`WebApp` + `make_handler`),
    driven over HTTP only: a first chat turn equal to the worker's direct
    answer, a second turn by delta prefill held to a full prefill, a
    regenerate, the OpenAI gateway streamed and not, the conversation log,
    and the stream's first chunk arriving before its last through both
    hops. Times to the first and last chunk, direct and through the front,
    are printed."""
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=1, pad_to_multiple=128, fuse=False)
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           f"smoke_front_{os.getpid()}")
    image = cxr_image(np.random.default_rng(seed + 17))
    b64 = png_b64(image)
    ctl = front.Controller(host="127.0.0.1", port=0)
    ctl.serve_forever(background=True)
    caddr = f"http://127.0.0.1:{ctl.port}"
    worker = web = None
    try:
        worker = BatchWorker(runner, model_names=[FRONT_MODEL], num_slots=8, max_len=4224,
                             kv_quant=True, prompt_buckets=INT8_BUCKETS,
                             steps_per_sync=FRONT_STEPS, pipeline_depth=2, fill_batch=2,
                             controller_address=caddr)
        b = worker.batcher
        waddr = f"http://127.0.0.1:{worker.serve_forever(host='127.0.0.1', port=0, background=True)}"
        app = web_ui.WebApp(caddr, log_dir=log_dir)
        web = ThreadingHTTPServer(("127.0.0.1", 0), web_ui.make_handler(app))
        threading.Thread(target=web.serve_forever, daemon=True).start()
        uaddr = f"http://127.0.0.1:{web.server_address[1]}"
        print(f"  controller, BatchWorker (warmup {worker.warmup_seconds:.2f} s) and web UI up",
              flush=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # A new session lists the worker's model.
        new = post_json(uaddr + "/api/new", {})
        if new["models"] != [FRONT_MODEL]:
            raise AssertionError(f"front: /api/new lists {new['models']}")
        gen = {"session_id": new["session_id"], "model": FRONT_MODEL,
               "max_new_tokens": NEW_TOKENS, "temperature": 0.0}
        template = TEMPLATES[app.template]
        q1, q2 = QUESTIONS[1], QUESTIONS[2]
        turns = [("user", "<image>\n" + q1)]
        # Turn 1 through the web UI and the controller, and the same
        # prompt and image straight to the worker: the same text.
        direct = {"model": FRONT_MODEL, "prompt": render_generation_prompt(turns, template=template),
                  "images": [b64], "max_new_tokens": NEW_TOKENS, "temperature": 0.0}
        text_direct, t_direct = direct_stream(waddr, direct)
        # The web UI sends a session id, whose request keeps its KV and so is
        # not refilled early: the same prompt direct with a session id of
        # its own is what the two hops are compared with.
        text_kept, t_kept = direct_stream(waddr, dict(direct, session_id="direct-1"))
        raw, t_web = stream_timed(uaddr + "/api/chat", dict(gen, text=q1, images=[b64]))
        reply1 = final_text("turn 1", chunks_of(raw))
        if not reply1 or not reply1 == text_direct == text_kept:
            raise AssertionError("front: turn 1 through the web UI is not the worker's direct text")
        # Streaming is real through the two hops.
        n_chunks = len(chunks_of(raw))
        if not (len(t_web) >= 2 and t_web[0] < t_web[-1] and len(t_direct) >= 2):
            raise AssertionError(f"front: the stream came in one piece ({t_web})")
        print(f"  turn 1 ({n_chunks} chunks, {len(t_web)} pieces), first / last chunk: direct to "
              f"the worker {t_direct[0]:.4f} / {t_direct[-1]:.4f} s; direct with a session id "
              f"{t_kept[0]:.4f} / {t_kept[-1]:.4f} s; web -> controller -> worker "
              f"{t_web[0]:.4f} / {t_web[-1]:.4f} s; {nvidia_smi_line()}", flush=True)
        # Turn 2 extends the stored conversation: a delta prefill, held
        # to a full prefill of the same conversation (no session id).
        fills = b.resume_fills
        raw, t_turn2 = stream_timed(uaddr + "/api/chat", dict(gen, text=q2))
        reply2 = final_text("turn 2", chunks_of(raw))
        if b.resume_fills != fills + 1:
            raise AssertionError(f"front: turn 2 was not one delta prefill "
                                 f"(resume_fills {fills} -> {b.resume_fills})")
        conversation = render_generation_prompt(turns + [("assistant", reply1), ("user", q2)],
                                                template=template)
        full2, t_full2 = direct_stream(waddr, dict(direct, prompt=conversation))
        same_tokens_or_near_tie("front turn 2", ctx, conversation, image, reply2, full2, True)
        # Regenerate: the same prompt again, a prefix of the stored
        # conversation, so a full prefill: the full prefill's text.
        raw, t_regen = stream_timed(uaddr + "/api/regenerate", gen)
        regen = final_text("regenerate", chunks_of(raw))
        if b.resume_fills != fills + 1 or regen != full2:
            raise AssertionError("front: regenerate is not a full prefill of turn 2's text")
        print(f"  turn 2 by delta prefill: first chunk {t_turn2[0]:.4f} s, last "
              f"{t_turn2[-1]:.4f} s; its full prefill direct {t_full2[0]:.4f} / "
              f"{t_full2[-1]:.4f} s; regenerate {t_regen[0]:.4f} / {t_regen[-1]:.4f} s; "
              f"{'same text' if reply2 == full2 else 'texts differ at a near tie'}", flush=True)
        # The OpenAI gateway, plain and streamed, against the worker.
        body = chat_body([q1], image, None)
        want = post_json(waddr + "/v1/chat/completions", body)["choices"][0]["message"]["content"]
        got = post_json(caddr + "/v1/chat/completions", body)["choices"][0]["message"]["content"]
        raw, t_sse = stream_timed(caddr + "/v1/chat/completions", dict(body, stream=True))
        if not want or got != want or sse_text(raw) != want:
            raise AssertionError("front: the gateway's answer is not the worker's")
        print(f"  /v1/chat/completions through the controller = the worker's, plain and streamed "
              f"(first event {t_sse[0]:.4f} s, last {t_sse[-1]:.4f} s)", flush=True)
        # The conversation log: one chat record a turn, the image hashed.
        logs = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        records = []
        for path in logs:
            with open(path) as f:
                records += [json.loads(line) for line in f]
        sha = hashlib.sha256(b64.encode()).hexdigest()
        texts = [r["state"]["messages"][-1][1] for r in records]
        if (len(logs) != 1 or [r["type"] for r in records] != ["chat"] * 3
                or any(r["images"] != [sha] for r in records) or texts != [reply1, reply2, regen]):
            raise AssertionError(f"front: conversation log {records}")
        print("  conversation log: 3 chat records, the image as its sha256", flush=True)
    finally:
        if web is not None:
            web.shutdown()
            web.server_close()
        if worker is not None:
            worker.shutdown()
        ctl.shutdown()
        shutil.rmtree(log_dir, ignore_errors=True)
    counts = kernels.launch_counts()
    print(f"  launches in the measured run: {counts}", flush=True)
    require_launched("front", counts)
    return counts


def write_judge(path: str, seed: int, dev) -> int:
    """An HF Llama directory at LLAMA2_7B's widths and (cut) depth under `path`:
    random bf16 weights made on the card from `seed` (matrices N(0, 0.02),
    norm scales 1), written by `safetensors_io.write_file`, and its
    config.json. Fails before writing if the disk cannot hold it. Returns
    the bytes written."""
    c = LLAMA2_7B
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    shapes = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,),
              "lm_head.weight": (v, d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (d,),
                       p + "post_attention_layernorm.weight": (d,),
                       p + "mlp.gate_proj.weight": (f, d), p + "mlp.up_proj.weight": (f, d),
                       p + "mlp.down_proj.weight": (d, f)})
        shapes.update({p + f"self_attn.{n}_proj.weight": (d, d) for n in "qkvo"})
    size = 2 * sum(math.prod(s) for s in shapes.values())
    os.makedirs(path)
    free = shutil.disk_usage(path).free
    print(f"  judge checkpoint: {len(shapes)} tensors, {size / 1e9:.3f} GB; "
          f"{free / 1e9:.1f} GB free on its disk before the write", flush=True)
    if free < size + 2 ** 30:
        raise AssertionError(f"{free} bytes free, the judge checkpoint needs {size} + 1 GiB")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tensors = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, device=dev, dtype=torch.bfloat16)
        tensors[name] = t.fill_(1.0) if name.endswith("norm.weight") else t.normal_(
            0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    safetensors_io.write_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(c, fh, indent=2)
    del tensors
    torch.cuda.empty_cache()
    print(f"  wrote it in {time.perf_counter() - t0:.2f} s", flush=True)
    return size


def green_pairs(rng, n: int):
    """`n` synthetic (reference, candidate) report pairs from REPORT_SENTENCES."""
    pick = lambda k: " ".join(rng.choice(REPORT_SENTENCES, k, replace=False))
    return [(pick(int(rng.integers(3, 6))), pick(int(rng.integers(2, 5)))) for _ in range(n)]


def record_lengths(b) -> list:
    """The prompt lengths `b.submit` receives from now on, in a list."""
    lengths, submit = [], b.submit

    def recording_submit(sample, *args, **kw):
        lengths.append(sample.length)
        return submit(sample, *args, **kw)

    b.submit = recording_submit
    return lengths


def engine_kernels(b, prompt_lengths, seed: int, label: str, attention: bool = True) -> None:
    """The kernels of a ContinuousBatcher's path at its own shapes, against
    their plain versions. Where the engine's attention takes the kernels
    (`attention`): K2 on a fill of the prompt bucket left-padded to the
    shortest and to the longest prompt it was given, then K9 (bf16 cache)
    or K4 (int8 cache) on the engine's own cache and segment ids after its
    run (every slot, the first and the last layer; a slot that holds no key
    must give 0, and one slot at least must hold keys; K9's path fills
    every slot). For an int8 model, K3 at a fill's rows and K5/K6 at the
    slots' rows on the last layer's own int8 projections (qkv, o, gateup
    or MPT's up, down; an MoE's dense experts are no kernel's) and the
    lm_head's, where it is one (a tied head is the dequantized embedding)."""
    tcfg, text = b.cfg.text, b.model.text
    dev = b.model.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)

    h, hkv, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
    rows = min(x for x in b.prompt_buckets if x >= max(prompt_lengths))
    if attention:
        q, k, v = randn(2, rows, h, hd), randn(2, rows, hkv, hd), randn(2, rows, hkv, hd)
        seg = torch.ones((2, rows), dtype=torch.int32, device=dev)
        seg[0, :rows - min(prompt_lengths)] = 0
        seg[1, :rows - max(prompt_lengths)] = 0
        out = fa.prefill_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, causal=True)
        torch.cuda.synchronize()
        check_close("prefill_attention",
                    f"{label} K2 prefill_attention [2,{rows},{h}|{hkv},{hd}]",
                    out, fa.attention_plain(q, k, v, seg, seg, True, hd ** -0.5),
                    rows=seg.bool())
        if out[~seg.bool()].abs().max() != 0:
            raise AssertionError(f"{label} K2: padding rows must be 0")
        del q, k, v, out
        name, kn = ("decode_attention_q8", "K4") if b.kv_quant else ("decode_attention", "K9")
        visible = (b.cache_seg != 0).sum(1).tolist()
        if max(visible) == 0 or (not b.kv_quant and min(visible) == 0):
            raise AssertionError(f"{label} {kn}: slots of the engine's cache hold no key: "
                                 f"{visible}")
        qd = randn(b.num_slots, h, hd)
        for layer in (0, tcfg.num_layers - 1):
            if b.kv_quant:
                ck, cv, ks, vs = b.cache
                out = da.decode_attention_stacked_q8(qd, ck, cv, ks, vs, b.cache_seg, layer,
                                                     num_kv_heads=hkv)
                ref = da.decode_attention_q8_plain(qd, ck[layer], cv[layer], ks[layer],
                                                   vs[layer], b.cache_seg, num_kv_heads=hkv,
                                                   scale=hd ** -0.5)
            else:
                ck, cv = b.cache
                out = da.decode_attention_stacked(qd, ck, cv, b.cache_seg, layer,
                                                  num_kv_heads=hkv)
                ref = da.decode_attention_plain(qd, ck[layer], cv[layer], b.cache_seg,
                                                num_kv_heads=hkv, scale=hd ** -0.5)
            torch.cuda.synchronize()
            empty = [i for i, n in enumerate(visible) if n == 0]
            if empty and out[empty].abs().max() != 0:
                raise AssertionError(f"{label} {kn}: slots {empty} hold no key and must give 0")
            check_close(name, f"{label} {kn} {name} [{b.num_slots},{h}|{hkv},{hd}] x layer "
                        f"{layer} of the engine's cache [{b.num_slots},{b.max_len},{hkv * hd}] "
                        f"({min(visible)}-{max(visible)} keys a slot)", out, ref)
    blk = text.layers[-1]
    if not isinstance(blk.o, QLinear):
        return
    lins = [(n, getattr(blk, n)) for n in ("qkv", "o", "gateup", "up", "down")
            if isinstance(getattr(blk, n, None), QLinear)]
    if isinstance(text.lm_head, QLinear):
        lins.append(("lm_head", text.lm_head))
    fill_rows = b.fill_batch * rows
    for name, lin in lins:
        n, kk = lin.weight.shape
        if name != "lm_head":  # the lm_head of a fill is weight-only
            xq, xs = w8.quantize_rows(randn(fill_rows, kk))
            out = w8.w8a8_matmul(xq, xs, lin.weight, lin.scale)
            torch.cuda.synchronize()
            check_close("w8a8_matmul", f"{label} K3 w8a8_matmul {name} "
                        f"[{fill_rows},{kk}]x[{kk},{n}]", out,
                        w8.w8a8_matmul_plain(xq, xs[:, 0], lin.weight, lin.scale,
                                             torch.bfloat16))
            del xq, xs, out
        x = randn(b.num_slots, kk)
        out = i8.int8_matmul(x, lin.weight, lin.scale)
        torch.cuda.synchronize()
        check_close("int8_matmul", f"{label} K5/K6 int8_matmul {name} "
                    f"[{b.num_slots},{kk}]x[{kk},{n}]", out,
                    i8.int8_matmul_plain(x, lin.weight, lin.scale))


def phase_text_lm(ctx, seed: int):
    """The GREEN judge and the local LLM client at Llama-2-7B's full width
    and depth (TextLMEngine on the continuous engine, the bf16 cache): a
    checkpoint written under build/, the bf16 judge scoring JUDGE_PAIRS
    report pairs through `make_torch_judge` + `green_batched`, then the int8
    judge as a `LocalTorchClient` driving `synth.filter_reports` and judging
    `evaluate_conversations`, whose replay runs on phase 5's int8 model.
    Returns the launch counts of the bf16 and the int8 judge's runs."""
    from radvlm_tpu_torch.data.llm_clients import LocalTorchClient
    from radvlm_tpu_torch.data.synth import filter_reports
    from radvlm_tpu_torch.eval.conversations import evaluate_conversations
    from radvlm_tpu_torch.eval.green_cli import make_torch_judge
    from radvlm_tpu_torch.eval.metrics.clinical import green_batched, green_prompt

    t_phase = time.perf_counter()
    dev = ctx["model"].device
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_judge_{os.getpid()}")
    tok = JudgeTokenizer(LLAMA2_7B["vocab_size"])
    rng = np.random.default_rng(seed + 17)
    counts = {}
    try:
        write_judge(root, seed + 5, dev)

        # The bf16 judge.
        t0 = time.perf_counter()
        judge = make_torch_judge(root, num_slots=JUDGE_SLOTS, max_new_tokens=JUDGE_NEW,
                                 tokenizer=tok)
        eng = judge.engine
        b = eng.batcher
        torch.cuda.synchronize()
        print(f"  bf16 judge: load {time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card "
              f"(phase 5's int8 model included), cache [{b.num_slots} x {b.max_len}], "
              f"buckets {b.prompt_buckets}", flush=True)
        pairs = green_pairs(rng, JUDGE_PAIRS)
        prompts = [green_prompt(r, h) for r, h in pairs]
        try:
            ids = tok(prompts[0]).input_ids
            batch = multimodal.collate([multimodal.build_sample(ids, [], eng.cfg)],
                                       pad_tiles=1, pad_to_multiple=128, left_pad=True)
            check_against_f32(eng.model, eng.cfg, batch_to_device(batch, dev), "judge ")
            responses = []

            def batch_judge(ps):
                out = judge(ps)
                responses.extend(out)
                return out

            fill_lengths = record_lengths(b)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            b.host_stats = dict.fromkeys(b.host_stats, 0)
            t0 = time.perf_counter()
            mean, scores = green_batched([r for r, _ in pairs], [h for _, h in pairs],
                                         batch_judge)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts["text_lm"] = kernels.launch_counts()
            hs = dict(b.host_stats)
            if len(responses) != JUDGE_PAIRS or len(scores) != JUDGE_PAIRS or not all(
                    responses):
                raise AssertionError(f"GREEN: {len(responses)} responses, scores {scores}")
            lengths = sorted(len(tok(p).input_ids) for p in prompts)
            print(f"  GREEN over {JUDGE_PAIRS} pairs (prompts {lengths[0]}-{lengths[-1]} tokens, "
                  f"{JUDGE_SLOTS} slots, {JUDGE_NEW} new tokens): {wall:.3f} s, "
                  f"{JUDGE_PAIRS / wall:.3f} pairs/s, {hs['tokens']} tokens, "
                  f"{hs['tokens'] / wall:.1f} decode tokens/s; mean {mean:.4f} over "
                  f"{sum(s is not None for s in scores)} parsed; {nvidia_smi_line()}", flush=True)
            print(f"  host_stats: { {k: round(v, 3) for k, v in hs.items()} }", flush=True)
            print(f"  launches in the measured run: {counts['text_lm']}", flush=True)
            print(f"  provenance: {b.kernel_provenance()}", flush=True)
            require_launched("text_lm", counts["text_lm"])
            engine_kernels(b, fill_lengths, seed + 19, "bf16 judge")
            if judge(prompts) != responses:
                raise AssertionError("a repeat of the GREEN batch gave other tokens")
            t0 = time.perf_counter()
            alone = [eng.generate(p) for p in prompts]
            if alone != responses:
                bad = [i for i, (a, r) in enumerate(zip(alone, responses)) if a != r]
                raise AssertionError(f"requests {bad} gave other tokens alone than in the batch")
            print(f"  a repeat of the batch gave the same tokens, and each request alone "
                  f"({time.perf_counter() - t0:.2f} s for {JUDGE_PAIRS}) its batch tokens",
                  flush=True)
        finally:
            eng.shutdown()
        engine_chunks(b, eng.cfg, tok, {"prompt": prompts[0]}, None, label="bf16 judge")
        del judge, eng, b
        gc.collect()
        torch.cuda.empty_cache()

        # The int8 judge as the pipelines' local LLM client.
        t0 = time.perf_counter()
        client = LocalTorchClient(root, int8=True, num_slots=JUDGE_SLOTS, max_tokens=JUDGE_NEW,
                                  template="llama_2", tokenizer=tok)
        b = client.engine.batcher
        torch.cuda.synchronize()
        print(f"  int8 judge (LocalTorchClient, llama_2 template): load + quantize "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card", flush=True)
        try:
            ids = tok(prompts[0]).input_ids
            batch = multimodal.collate([multimodal.build_sample(ids, [], client.engine.cfg)],
                                       pad_tiles=1, pad_to_multiple=128, left_pad=True)
            check_int8_against_f32(client.engine.model, client.engine.cfg,
                                   batch_to_device(batch, dev), "bf16", "int8 judge ",
                                   same_arithmetic=True)
            reports = [{"study_id": f"s{i:02d}", "txt": text}
                       for i, (text, _) in enumerate(green_pairs(rng, JUDGE_REPORTS))]
            out_dir = os.path.join(root, "filtered_reports")
            fill_lengths = record_lengths(b)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            b.host_stats = dict.fromkeys(b.host_stats, 0)
            t0 = time.perf_counter()
            n = filter_reports(reports, client, out_dir, num_workers=JUDGE_REPORTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts["text_lm_int8"] = kernels.launch_counts()
            hs = dict(b.host_stats)
            files = sorted(os.listdir(out_dir))
            if n != JUDGE_REPORTS or files != [f"{r['study_id']}.txt" for r in reports]:
                raise AssertionError(f"filter_reports wrote {n}: {files}")
            print(f"  filter_reports over {JUDGE_REPORTS} reports ({JUDGE_REPORTS} threads): "
                  f"{wall:.3f} s, {JUDGE_REPORTS / wall:.3f} reports/s, {hs['tokens']} tokens, "
                  f"{hs['tokens'] / wall:.1f} decode tokens/s; {nvidia_smi_line()}", flush=True)
            print(f"  host_stats: { {k: round(v, 3) for k, v in hs.items()} }", flush=True)
            print(f"  launches in the measured run: {counts['text_lm_int8']}", flush=True)
            prov = b.kernel_provenance()
            print(f"  provenance: {prov}", flush=True)
            if prov["prefill_matmul"] != "w8a8" or prov["decode_matmul"] != "int8":
                raise AssertionError(f"the int8 judge's matmul routes: {prov}")
            require_launched("text_lm_int8", counts["text_lm_int8"])
            engine_kernels(b, fill_lengths, seed + 23, "int8 judge")

            # Conversations replayed on phase 5's int8 model, judged by the client.
            runner = VLMRunner(model=ctx["model"], cfg=ctx["cfg"], tokenizer=ctx["tok"],
                               max_new_tokens=CONV_NEW_TOKENS, batch_size=1,
                               pad_to_multiple=128, fuse=False)
            answers, verdicts = [], []
            replay = runner.generate_batch

            def counted_replay(prompts_, images_, **kw):
                out = replay(prompts_, images_, **kw)
                answers.extend(out)
                return out

            runner.generate_batch = counted_replay

            class CountingJudge:
                def complete(self, p):
                    verdicts.append(client.complete(p))
                    return verdicts[-1]

            convs = [{"img": cxr_image(rng), "conversation": [
                {"from": "human", "value": QUESTIONS[i % 4]}, {"from": "gpt", "value": "No."},
                {"from": "human", "value": QUESTIONS[(i + 1) % 4]},
                {"from": "gpt", "value": "Stable."}]} for i in range(JUDGE_CONVERSATIONS)]
            t0 = time.perf_counter()
            res = evaluate_conversations(runner, convs, CountingJudge(),
                                         output_path=os.path.join(root, "conv_eval.json"))
            wall = time.perf_counter() - t0
            if len(answers) != 2 * JUDGE_CONVERSATIONS or len(verdicts) != JUDGE_CONVERSATIONS \
                    or not all(isinstance(a, str) for a in answers) or not all(verdicts):
                raise AssertionError(f"conversations: {len(answers)} answers, "
                                     f"{len(verdicts)} verdicts")
            print(f"  evaluate_conversations over {JUDGE_CONVERSATIONS} two-turn conversations: "
                  f"{wall:.3f} s ({2 * JUDGE_CONVERSATIONS} replays of {CONV_NEW_TOKENS} tokens "
                  f"on the radvlm_7b int8 model, {JUDGE_CONVERSATIONS} verdicts of "
                  f"{JUDGE_NEW} tokens); mean {res['mean_score']:.2f} over n = {int(res['n'])} "
                  f"parsed (random weights)", flush=True)
        finally:
            client.shutdown()
        engine_chunks(b, client.engine.cfg, tok, {"prompt": prompts[0]}, None,
                      label="int8 judge")
        del client, b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 7d: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def write_training_data(root: str, rng, n_pairs: int, height: int = 560,
                        widths=(400, 448)) -> str:
    """A llava-json under `root`: `n_pairs` cells with a synthetic CXR-sized
    PNG each (portrait, 560 x 400-448 by default: ~3.1k tokens with its text
    under SigLIP's anyres) and as many text-only cells (~0.5k tokens), so
    that one of each packs into a 4096-token row. Returns the json's path."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    findings = ("No focal consolidation, pleural effusion or pneumothorax. The cardiac silhouette "
                "is within normal limits. No acute osseous abnormality.")
    cells = []
    for i in range(n_pairs):
        name = f"cxr{i}.png"
        img = rng.integers(0, 255, size=(height, int(rng.integers(*widths)), 3), dtype=np.uint8)
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


def training_run_config(cfg, train_cfg, data_path, root, tok, seed: int, n_rows: int,
                        bucket: Bucket = TRAIN_BUCKET, **kw):
    """A RunConfig over `data_path` (`n_rows` image cells and as many text
    cells) whose epoch is `n_rows` rows of one image cell and one text cell
    each: the loader's seed is the first of seed, seed + 1, ... with that
    plan (a row of two images would be clipped at the bucket's 4096 tokens,
    a row of two texts would be mostly padding)."""
    run = train_loop.RunConfig(
        model=cfg, train=train_cfg, data_path=data_path, image_root=root, micro_batch_size=1,
        log_every=1, buckets=(bucket,), pack_factor=2, loader_workers=4, **kw)
    with open(data_path) as f:
        cells = json.load(f)
    dataset = LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=tok.encode,
                               max_len=bucket.max_len)
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
          f"tokens in the {bucket.max_len} bucket", flush=True)
    if max(lengths) > bucket.max_len:
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


class BoxTokenizer(CharTokenizer):
    """CharTokenizer whose decode reads every id divisible by 8 as a whole
    box, "[x0, y0, x1, y1]" with coordinates taken from the id (a BPE
    vocabulary has multi-character tokens too). A random model samples
    nearly uniform ids, so through CharTokenizer it would never write a box
    and every REC reward would be 0: no advantage, no update. Here about one
    token in 8 is a box, at coordinates that differ, so the rewards of a
    group differ and the policy moves."""

    def decode(self, ids):
        out = []
        for i in ids:
            if i % 8:
                out.append(self._char(i))
                continue
            x0, y0 = (i // 8) % 6 / 10, (i // 48) % 6 / 10
            out.append(f" [{x0:.2f}, {y0:.2f}, {x0 + 0.35:.2f}, {y0 + 0.4:.2f}] ")
        return "".join(out)


def write_preference_data(root: str, rng, n_pairs: int) -> str:
    """A preference json under `root`: `n_pairs` cells, each a synthetic
    CXR-sized PNG (portrait, 560 x 400-448), a question, and a chosen and a
    rejected reply of different lengths (~3.1k tokens a side). Returns the
    json's path."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    findings = ("No focal consolidation, pleural effusion or pneumothorax. The cardiac silhouette "
                "is within normal limits. No acute osseous abnormality.")
    cells = []
    for i in range(n_pairs):
        name = f"cxr{i}.png"
        img = rng.integers(0, 255, size=(560, int(rng.integers(400, 448)), 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, name))
        cells.append({"image": name, "prompt": "<image>\n" + QUESTIONS[i % len(QUESTIONS)],
                      "chosen": findings, "rejected": REPORT_SENTENCES[i % len(REPORT_SENTENCES)]})
    path = os.path.join(root, "prefs.json")
    with open(path, "w") as f:
        json.dump(cells, f)
    return path


def write_rec_data(root: str, rng, n: int) -> str:
    """A GRPO-REC jsonl under `root` in `data/export.grpo_rec_cell`'s format:
    `n` cells, each a synthetic CXR-sized PNG, a grounding question and its
    solution box as JSON. Returns the jsonl's path."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        name = f"rec{i}.png"
        Image.fromarray(cxr_image(rng)).save(os.path.join(root, name))
        x0, y0 = float(rng.uniform(0.05, 0.5)), float(rng.uniform(0.05, 0.5))
        box = [round(x0, 2), round(y0, 2), round(x0 + 0.3, 2), round(y0 + 0.35, 2)]
        finding = CHEXPERT_PATHOLOGIES[i % len(CHEXPERT_PATHOLOGIES)]
        lines.append(json.dumps({
            "id": f"rec{i}", "image": name,
            "problem": f"<image>\nLocate the {finding.lower()} on this chest X-ray. Output the "
                       "bounding box as [x_min, y_min, x_max, y_max].",
            "solution": json.dumps({"bbox": [box], "label": finding})}))
    path = os.path.join(root, "rec.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def dpo_reference_check(model, cfg, tok, rng) -> None:
    """The DPO loss and per-group gradient norms on one small pair batch,
    three ways as `training_reference_check`: the train step's path (bf16
    autocast; K1, K2, K2-lse, K7, K8), plain attention under the same
    autocast, and plain attention in f32 (the reference). The reference
    model is the policy with its final norm's scale perturbed, so the loss
    is not ln 2 by construction. The kernel path must be within 2x the
    plain bf16 path's relative error, or 1e-2."""
    img = rng.integers(0, 255, size=(384, 384, 3), dtype=np.uint8)
    ids = multimodal.tokenize_with_images(
        tok.encode, "<|im_start|>user\n<image>\nAny effusion?<|im_end|>\n<|im_start|>assistant\n")
    sides = []
    for reply in ("No pleural effusion.<|im_end|>\n", "Small left effusion.<|im_end|>\n"):
        r = tok.encode(reply)
        sample = multimodal.build_sample(ids + r, [img], cfg, labels=[-100] * len(ids) + r)
        sides.append(batch_to_device(multimodal.collate([sample], pad_to_multiple=128),
                                     model.device))
    ref = dpo_lib.frozen_copy(model)
    with torch.no_grad():
        ref.text.norm.mul_(1 + 0.1 * torch.randn(ref.text.norm.shape, device=model.device,
                                                 generator=torch.Generator(device=model.device)
                                                 .manual_seed(0)))
    got = {}
    for name, impl, autocast in (("f32 plain", "xla", False), ("kernels", "auto", True),
                                 ("bf16 plain", "xla", True)):
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            loss, _ = dpo_lib.dpo_loss(model, ref, cfg, dpo_lib.DPOConfig(), *sides,
                                       attn_impl=impl)
        loss.backward()
        got[name] = dict(loss=float(loss.detach()), **group_grad_norms(model))
    del ref
    ref_vals = got["f32 plain"]
    for key in ref_vals:
        err = {n: abs(got[n][key] - ref_vals[key]) / abs(ref_vals[key])
               for n in ("kernels", "bf16 plain")}
        limit = max(2 * err["bf16 plain"], 1e-2)
        print(f"  {key}: f32 plain {ref_vals[key]:.6f}, kernels {got['kernels'][key]:.6f} (rel "
              f"err {err['kernels']:.3e}), bf16 plain {got['bf16 plain'][key]:.6f} (rel err "
              f"{err['bf16 plain']:.3e}); limit {limit:.3e}", flush=True)
        if not (np.isfinite(got["kernels"][key]) and err["kernels"] <= limit):
            raise AssertionError(f"DPO reference check: kernel path off the f32 {key}")


def dpo_counts_per_step(cfg) -> dict:
    """Launches of one DPO step with the tower frozen and remat on: two
    policy passes (a K1 per tower layer, a K2-lse per decoder layer in the
    forward and again in the recompute, a K7 and a K8 in the backward) and
    two reference passes (K1 and K2, no gradient)."""
    t, v = cfg.text.num_layers, cfg.vision.num_layers
    return {"tower_attention": 4 * v, "prefill_attention": 2 * t,
            "prefill_attention_lse": 4 * t, "flash_attention_bwd_dkv": 2 * t,
            "flash_attention_bwd_dq": 2 * t}


def require_counts(label: str, counts: dict, want: dict) -> None:
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, not {n}")
    idle = [k for k, n in counts.items() if n and k not in want]
    if idle:
        raise AssertionError(f"{label}: kernels off the path launched: {idle}")


def phase_dpo(dev, seed: int):
    """DPO of radvlm_0_5b at full width and depth through `dpo.train_dpo`."""
    cfg, tok = radvlm_0_5b(), CharTokenizer()
    t0 = time.perf_counter()
    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                                dtype=torch.float32)
    train_cfg = optim.TrainConfig(learning_rate=1e-6, lr_schedule="constant", warmup_ratio=0.0,
                                  grad_accum_steps=1, mm_tunable_parts="mm_language_model")
    labels = optim.mark_trainable(model, train_cfg)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for n, p in model.named_parameters() if n in labels)
    print(f"  radvlm_0_5b: {n_train / 1e6:.1f} M trainable f32 parameters (the language model; "
          f"tower and projector frozen), init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed + 5)
    dpo_reference_check(model, cfg, tok, rng)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_dpo_{os.getpid()}")
    try:
        data_path = write_preference_data(root, rng, DPO_PAIRS * DPO_STEPS)
        run = train_loop.RunConfig(
            model=cfg, train=train_cfg, data_path=data_path, image_root=root,
            micro_batch_size=DPO_PAIRS, max_steps=DPO_STEPS, log_every=1,
            buckets=(TRAIN_BUCKET,), seed=seed)
        seen, t_prev = [], [time.perf_counter()]

        def on_metrics(step, m):
            now = time.perf_counter()
            seen.append((step, m, now - t_prev[0]))
            t_prev[0] = now

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = dpo_lib.train_dpo(run, tok.encode, init_params=model, metrics_callback=on_metrics)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for step, m, dt in seen:
            print(f"  DPO step {step}: loss {m['loss']:.6f}, reward_accuracy "
                  f"{m['reward_accuracy']:.2f}, chosen_reward {m['chosen_reward']:.3e}, "
                  f"rejected_reward {m['rejected_reward']:.3e}, reward_margin "
                  f"{m['reward_margin']:.3e}, grad_norm {m['grad_norm']:.4f}, {dt:.3f} s",
                  flush=True)
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"DPO step {step}: a metric is not finite")
        if [s for s, _, _ in seen] != list(range(1, DPO_STEPS + 1)):
            raise AssertionError(f"DPO ran steps {[s for s, _, _ in seen]}")
        if abs(seen[0][1]["loss"] - math.log(2.0)) > 1e-3:
            raise AssertionError("the first DPO step's loss is not ln 2 (policy = reference)")
        steady = [dt for _, _, dt in seen[1:]]
        print(f"  DPO: {DPO_STEPS} steps of {DPO_PAIRS} pairs, median "
              f"{statistics.median(steady):.3f} s a step past the first, peak memory {peak / 2**30:.2f} GiB; the whole call "
              f"{t_run:.2f} s (set-up included)", flush=True)
        print(f"  launches in the measured run: {counts}", flush=True)
        require_launched("dpo", counts)
        require_counts("DPO", counts,
                       {k: DPO_STEPS * n for k, n in dpo_counts_per_step(cfg).items()})
        # A constant rate on one pair batch, the reference the policy now:
        # the margin must rise.
        del state
        gc.collect()
        torch.cuda.empty_cache()
        const = dataclasses.replace(train_cfg, learning_rate=1e-5)
        opt = optim.make_optimizer(model, const)
        ostate = tstep.TrainState(step=0, params=model, opt_state=opt)
        ref = dpo_lib.frozen_copy(model)
        step_fn = dpo_lib.make_dpo_step(cfg, dpo_lib.DPOConfig(), opt)
        with open(data_path) as f:
            cells = json.load(f)
        dataset = dpo_lib.DPOPairDataset(cells=cells, image_root=root, cfg=cfg,
                                         tokenize_fn=tok.encode, max_len=TRAIN_BUCKET.max_len)
        idxs = list(range(DPO_PAIRS))
        chosen, rejected = (batch_to_device(b, dev) for b in
                            dpo_lib._build_pair_batch(dataset, idxs, TRAIN_BUCKET))
        margins = []
        for _ in range(OVERFIT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ostate, m = step_fn(ostate, ref, chosen, rejected)
            margins.append(float(m["reward_margin"]))
            wall = time.perf_counter() - t0
        print(f"  {OVERFIT_STEPS} steps on one pair batch at a constant 1e-5: reward_margin "
              f"{[f'{x:.4e}' for x in margins]}", flush=True)
        if not (all(np.isfinite(margins)) and margins[-1] > margins[0]):
            raise AssertionError("the reward margin did not rise")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ostate, m = step_fn(ostate, ref, chosen, rejected)
            torch.cuda.synchronize()
        device_breakdown(prof, wall, "DPO step (2 pairs, 4 passes)", top=16)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def same_as_fresh_copy(engine_model, policy, cfg) -> int:
    """Compare every parameter of the rollout engine's copy with a fresh
    `rollout_model(policy)` (the bf16 cast of the policy, the fused weights
    `fuse_linears`' cat of their parts); raises on a difference. Returns
    the number of tensors compared."""
    fresh = dict(grpo_lib.rollout_model(policy, cfg).named_parameters())
    got = dict(engine_model.named_parameters())
    if got.keys() != fresh.keys():
        raise AssertionError("the rollout copy's parameters are not a fresh copy's")
    differ = [n for n in got if not torch.equal(got[n], fresh[n])]
    if differ:
        raise AssertionError(f"the rollout copy differs from the policy at {differ[:4]}")
    return len(got)


def grpo_counts(cfg, waves: int, updates: int, scores: int) -> dict:
    """Launches of GRPO waves with the tower frozen and remat on, the decode
    steps aside: a fill a rollout (K1 a tower layer, K2 a decoder layer),
    and a wave's update passes: a reference pass a update and a score pass
    a mu > 1 wave (K1, K2), a policy pass a update (K1, K2-lse twice, K7,
    K8)."""
    t, v = cfg.text.num_layers, cfg.vision.num_layers
    fills = waves * GRPO["prompts_per_wave"] * GRPO["group_size"]
    return {"tower_attention": (fills + 2 * updates + scores) * v,
            "prefill_attention": (fills + updates + scores) * t,
            "prefill_attention_lse": 2 * updates * t,
            "flash_attention_bwd_dkv": updates * t, "flash_attention_bwd_dq": updates * t}


def recorded_engines(lengths: list):
    """A ContinuousBatcher class that keeps each engine built from it in the
    list it returns, and the prompt lengths each one's `submit` receives in
    `lengths`; set in place of `grpo.train_grpo`'s, it shows the driver's
    own rollout engine to the phase."""
    engines = []

    class RecordingBatcher(ContinuousBatcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)
            submit = self.submit

            def recording_submit(sample, *a, **k):
                lengths.append(sample.length)
                return submit(sample, *a, **k)

            self.submit = recording_submit

    return RecordingBatcher, engines


def phase_grpo(dev, seed: int):
    """GRPO of radvlm_0_5b at full width and depth through `grpo.train_grpo`:
    two waves at mu = 1, then a run of one wave at mu = 2; then K2 and K9
    at the rollouts' shapes, on the last engine's own cache."""
    cfg, tok = radvlm_0_5b(), BoxTokenizer()
    t0 = time.perf_counter()
    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 1),
                                device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"  radvlm_0_5b f32 policy: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_grpo_{os.getpid()}")
    lengths = []
    recording, engines = recorded_engines(lengths)
    built_by_train_grpo = grpo_lib.ContinuousBatcher
    grpo_lib.ContinuousBatcher = recording
    try:
        data_path = write_rec_data(root, np.random.default_rng(seed + 6), GRPO_CELLS)
        run = train_loop.RunConfig(
            model=cfg, train=optim.TrainConfig(learning_rate=1e-6, lr_schedule="constant",
                                               warmup_ratio=0.0, grad_accum_steps=1,
                                               mm_tunable_parts="mm_language_model"),
            data_path=data_path, image_root=root, log_every=1, seed=seed)
        engine_kw = dict(num_slots=GRPO_SLOTS, rollout_max_len=GRPO_MAX_LEN,
                         prompt_buckets=(TRAIN_BUCKET.max_len,), pad_tiles=GRPO_PAD_TILES,
                         eos_token_ids=tok.eos_token_ids)
        seen = []

        def on_wave(step, m):
            n = same_as_fresh_copy(engines[-1].model, model, cfg)
            seen.append((step, m))
            print(f"  GRPO step {step}: loss {m['loss']:.6f}, kl {m['kl']:.3e} (first update "
                  f"{m['first_kl']:.3e}), clip_frac {m['clip_frac']:.3f} (first update "
                  f"{m['first_clip_frac']:.3f}), reward mean {m['reward_mean']:.4f} std "
                  f"{m['reward_std']:.4f}, {m['completion_tokens']:.1f} completion tokens; wave "
                  f"{m['sec_per_wave']:.3f} s: rollout {m['rollout_s']:.3f}, reward "
                  f"{m['reward_s']:.4f}, update {m['update_s']:.3f}, sync {m['sync_s']:.4f}; "
                  f"{m['rollout_tokens_per_sec']:.1f} decode tokens/s; the rollout copy equals "
                  f"the policy ({n} tensors)", flush=True)

        start = {n: p.clone() for n, p in grpo_lib.rollout_model(model, cfg).named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = grpo_lib.train_grpo(
            dataclasses.replace(run, max_steps=GRPO_WAVES), tok.encode, tok.decode, QWEN_CHATML,
            grpo_cfg=grpo_lib.GRPOConfig(mu=1, **GRPO), init_params=model,
            metrics_callback=on_wave, **engine_kw)
        waves_mu1 = len(seen)
        del state
        engines.clear()  # the first run's engine goes before the second's comes
        gc.collect()
        state = grpo_lib.train_grpo(
            dataclasses.replace(run, max_steps=2), tok.encode, tok.decode, QWEN_CHATML,
            grpo_cfg=grpo_lib.GRPOConfig(mu=2, **GRPO), init_params=model,
            metrics_callback=on_wave, **engine_kw)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        (engine_,) = engines
        if [s for s, _ in seen] != [1, 2, 2] or waves_mu1 != GRPO_WAVES or state.step != 2:
            raise AssertionError(f"GRPO ran waves ending at steps {[s for s, _ in seen]}")
        for i, (_, m) in enumerate(seen):
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"GRPO wave {i + 1}: a metric is not finite")
            if m["first_clip_frac"] != 0.0:
                raise AssertionError(f"GRPO wave {i + 1}: the first update clipped")
        for i in (0, GRPO_WAVES):  # each run's first wave: the policy is its reference
            if not seen[i][1]["first_kl"] < 1e-5:
                raise AssertionError(f"GRPO wave {i + 1}: KL {seen[i][1]['first_kl']} to a "
                                     "reference equal to the policy")
        moved = sum(not torch.equal(p, start[n]) for n, p in engine_.model.named_parameters())
        if not moved:
            raise AssertionError("no rollout weight moved: the updates changed nothing")
        print(f"  the rollout engine: a {next(engine_.model.parameters()).dtype} copy, "
              f"{'int8' if engine_.kv_quant else 'bf16'} KV cache, {engine_.num_slots} slots, "
              f"max_len {engine_.max_len}, prompt buckets {engine_.prompt_buckets}, "
              f"{engine_.pad_tiles} pad tiles; prompts of {min(lengths)}-{max(lengths)} tokens",
              flush=True)
        print(f"  GRPO: {len(seen)} waves, {GRPO_WAVES + 2} updates, {t_run:.2f} s in all; "
              f"peak memory {peak / 2**30:.2f} GiB; {moved} rollout tensors moved", flush=True)
        print(f"  launches in the measured run: {counts}", flush=True)
        require_launched("grpo", counts)
        want = grpo_counts(cfg, len(seen), GRPO_WAVES + 2, 1)
        k9 = counts["decode_attention"]
        if k9 % cfg.text.num_layers:
            raise AssertionError(f"K9 launched {k9} times, not a multiple of the layers")
        print(f"  {k9 // cfg.text.num_layers} decode steps of {GRPO_SLOTS} slots in the rollouts",
              flush=True)
        require_counts("GRPO", counts, dict(want, decode_attention=k9))
        engine_kernels(engine_, lengths, seed + 29, "GRPO rollouts")
    finally:
        grpo_lib.ContinuousBatcher = built_by_train_grpo
        shutil.rmtree(root, ignore_errors=True)
    return counts


def question_of_length(runner, cfg, tok, question: str, image, target: int) -> str:
    """A chat prompt about `image` whose sample is exactly `target` tokens:
    `question` followed by filler text (CharTokenizer: one token a
    character)."""
    def length(q):
        ids = multimodal.tokenize_with_images(tok.encode, prompt(runner, q))
        return multimodal.build_sample(ids, [image], cfg).length

    filler = " Compare with the prior study of this patient and describe any interval change."
    need = target - length(question)
    if need < 0:
        raise AssertionError(f"the image alone takes {length(question)} tokens, over {target}")
    text = question + (filler * (need // len(filler) + 1))[:need]
    if length(text) != target:
        raise AssertionError(f"prompt of {length(text)} tokens, wanted {target}")
    return prompt(runner, text)


def require_family_launches(label: str, counts, kernel_attention: bool) -> None:
    """K1, K3 and K5/K6 launched, and K2 and K4 exactly where the family's
    attention takes the kernels; no other kernel."""
    launched = FAMILY_KERNELS + (FAMILY_ATTENTION if kernel_attention else ())
    missing = [k for k in launched if counts[k] == 0]
    stray = [k for k, n in counts.items() if n and k not in launched]
    if missing or stray:
        raise AssertionError(f"{label}: kernels never launched {missing}, launched off the "
                             f"path {stray}")


@contextlib.contextmanager
def recorded_shapes(names):
    """The shapes of q (the first argument) that the wrappers `names` of
    `ops.flash_attention` are called with inside the block, as
    {name: set of shapes}."""
    seen = {n: set() for n in names}
    saved = {n: getattr(fa, n) for n in names}

    def recorder(name, fn):
        def call(q, *a, **k):
            seen[name].add(tuple(q.shape))
            return fn(q, *a, **k)
        return call

    for n in names:
        setattr(fa, n, recorder(n, saved[n]))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(fa, n, fn)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def serve_family(dev, seed: int, label: str, cfg, *, n_requests: int, kernel_attention: bool,
                 profile: bool, buckets=None, max_len: int = 0, pad_tiles: int = 0,
                 long_prompt: int = 0, cut: str = "", fill_batch: int = 2, after=None):
    """One decoder family at full width: weights born int8 on the card from
    `seed` (the experts of an MoE dense bf16), the int8 reference check,
    then a BatchWorker (8 slots, the int8 cache, 8-step chunks) serving `n_requests`
    concurrent greedy requests with CXR-sized images over HTTP, launch
    counts from 0 after its warmup. The provenance must name the kernel
    route for the prefill and decode attention where `kernel_attention`
    (K2, K4 launched) and the plain route elsewhere (neither launched); K1,
    K3 and K5/K6 launch in every family, nothing else does. With `profile`
    a decode chunk of every slot is timed and profiled. Then
    `engine_kernels` holds the path's kernels at the family's shapes on the
    engine's own cache and weights against their plain versions.

    With `buckets` None, the prompt bucket is the requests' longest prompt
    rounded up to 128 (max_len and pad_tiles are then derived too); the
    shapes K1 was called with in the measured run must be the tower's own
    (`towers.sequence_length` tokens, its heads and head dim).
    `after(b, samples, k1_shapes)` runs on the engine before it is freed."""
    t_phase = time.perf_counter()
    t = cfg.text
    model = convert.random_quantized_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                            device=dev)
    torch.cuda.synchronize()
    int8_gb = sum(p.numel() for p in model.parameters() if p.dtype == torch.int8) / 1e9
    dense_gb = sum(p.numel() * p.element_size() for p in model.parameters()
                   if p.dtype != torch.int8) / 1e9
    print(f"  {label}: {t.num_layers} layers{cut}, hidden {t.hidden_size}, heads {t.num_heads}|"
          f"{t.num_kv_heads} x {t.head_dim}, MLP {t.intermediate_size}"
          + (f", {t.num_experts} experts of {t.moe_intermediate_size} (top-"
             f"{t.num_experts_per_tok})" if t.num_experts else "")
          + f", {t.pos_embedding}, window {t.sliding_window}; {int8_gb:.3f} GB int8 + "
          f"{dense_gb:.3f} GB dense, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the "
          f"card, init {time.perf_counter() - t_phase:.2f} s", flush=True)
    tok = CharTokenizer()
    rng = np.random.default_rng(seed + 11)
    t_check = time.perf_counter()
    # Mixtral's f32 copy (45 GB of experts) fits beside its 8 int8 layers.
    reference_check_int8(model, cfg, tok, rng, f"{label} ")
    print(f"  reference check {time.perf_counter() - t_check:.2f} s", flush=True)
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=tok, max_new_tokens=NEW_TOKENS,
                       batch_size=1, pad_to_multiple=128)
    images = [cxr_image(rng) for _ in range(n_requests)]
    prompts = [prompt(runner, QUESTIONS[i % len(QUESTIONS)]) for i in range(n_requests)]
    if long_prompt:
        prompts[-1] = question_of_length(runner, cfg, tok, QUESTIONS[0], images[-1], long_prompt)
    reqs = [{"prompt": p, "images": [png_b64(im)], "max_new_tokens": NEW_TOKENS,
             "temperature": 0.0} for p, im in zip(prompts, images)]
    samples = [multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, p), [im], cfg)
               for p, im in zip(prompts, images)]
    lengths = [smp.length for smp in samples]
    if buckets is None:
        buckets = (round_up(max(lengths), 128),)
        max_len = buckets[0] + 128
        pad_tiles = max(smp.tiles.shape[0] for smp in samples)
    # No session ids are sent: sessions off skips their warmup's two runs.
    saved_cap = os.environ.get("RADVLM_SESSION_CAP")
    os.environ["RADVLM_SESSION_CAP"] = "0"
    try:
        worker = BatchWorker(runner, model_names=[label], num_slots=FAMILY_SLOTS,
                             max_len=max_len, kv_quant=True, prompt_buckets=buckets,
                             steps_per_sync=FAMILY_STEPS, pipeline_depth=4,
                             fill_batch=fill_batch, pad_tiles=pad_tiles)
    finally:
        if saved_cap is None:
            os.environ.pop("RADVLM_SESSION_CAP")
        else:
            os.environ["RADVLM_SESSION_CAP"] = saved_cap
    b = worker.batcher
    print(f"  warmup {worker.warmup_seconds:.2f} s: "
          f"{ {k: round(v, 3) for k, v in b.warmup_timings.items()} }", flush=True)
    print(f"  prompts: {lengths} tokens, buckets {sorted({b._bucket_for(n) for n in lengths})}, "
          f"{NEW_TOKENS} new tokens each; positions up to {max(lengths) + NEW_TOKENS} of "
          f"{t.max_position_embeddings}", flush=True)
    if max(lengths) + NEW_TOKENS > t.max_position_embeddings or max(lengths) > max(buckets):
        raise AssertionError(f"{label}: prompts run past the model's positions or the buckets")
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        b.host_stats = dict.fromkeys(b.host_stats, 0)
        t0 = time.perf_counter()
        with recorded_shapes(("tower_attention",)) as shapes, \
                concurrent.futures.ThreadPoolExecutor(n_requests) as pool:
            outs = list(pool.map(lambda r: post_json(base + "/worker_generate", r), reqs))
        t_load = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        worker.shutdown()
    counts = kernels.launch_counts()
    for i, out in enumerate(outs):
        if out.get("error_code") != 0 or not out.get("text"):
            raise AssertionError(f"{label} request {i} failed: {out}")
    n_tok = b.host_stats["tokens"]
    print(f"  {n_requests} concurrent requests: {t_load:.3f} s, {n_tok} tokens, "
          f"{n_tok / t_load:.1f} tokens/s (prefills included)", flush=True)
    print(f"  host_stats: { {k: round(v, 3) for k, v in b.host_stats.items()} }", flush=True)
    prov = b.kernel_provenance()
    print(f"  provenance: {prov}", flush=True)
    print(f"  launches in the measured run: {counts}", flush=True)
    attention = ("kernel", "kernel_q8") if kernel_attention else ("plain", "plain")
    want = dict(tower_attention="kernel", prefill_attention=attention[0],
                decode_attention=attention[1], prefill_matmul="w8a8", decode_matmul="int8")
    wrong = {k: prov[k] for k, v in want.items() if prov[k] != v}
    if wrong:
        raise AssertionError(f"{label}: provenance {wrong}, expected {want}")
    require_family_launches(label, counts, kernel_attention)
    v = cfg.vision
    own = (towers.sequence_length(v), v.num_heads, v.head_dim)
    k1_shapes = sorted(shapes["tower_attention"])
    print(f"  K1 shapes in the measured run: {k1_shapes}", flush=True)
    if not k1_shapes or any(sh[1:] != own for sh in k1_shapes):
        raise AssertionError(f"{label}: K1 ran at {k1_shapes}, not the tower's own "
                             f"[n, {own[0]}, {own[1]}, {own[2]}]")
    # The served prompt's logits through a prefill on the engine's own
    # routes (the kernels where the dispatch takes them): finite, of the
    # vocabulary's width.
    batch = batch_to_device(multimodal.collate([samples[-1]], pad_to_multiple=128,
                                               left_pad=True), dev)
    with torch.inference_mode():
        _, _, lg = engine.prefill(model, cfg, batch,
                                  engine.cache_length(lengths[-1], NEW_TOKENS),
                                  cache_format="int8")
    if lg.shape != (1, t.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError(f"{label}: prefill logits malformed")
    if profile:
        t_chunks = time.perf_counter()
        engine_chunks(b, cfg, tok, reqs[0], images[0], label)
        print(f"  decode chunks {time.perf_counter() - t_chunks:.2f} s", flush=True)
    t_check = time.perf_counter()
    engine_kernels(b, lengths, seed + 31, label, attention=kernel_attention)
    print(f"  the path's kernels at its own shapes {time.perf_counter() - t_check:.2f} s",
          flush=True)
    if after is not None:
        after(b, samples, k1_shapes)
    torch.cuda.synchronize()
    print(f"  {label}: {time.perf_counter() - t_phase:.1f} s; {nvidia_smi_line()}", flush=True)
    del worker, runner, b, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_families(dev, seed: int, header) -> dict:
    """Phase 11: LLaVA-Mixtral and then Llama-3-8B, Mistral-7B and Gemma-2B
    and LLaVA-MPT-7B (depth cut), each radvlm_7b's tower and
    projector into the family's decoder at full width."""
    counts = {}
    cfg = dataclasses.replace(radvlm_7b(), text=dataclasses.replace(
        mixtral_8x7b(), num_layers=MIXTRAL_LAYERS))
    header(f"[11a/12] LLaVA-Mixtral-8x7B, {MIXTRAL_LAYERS} of 32 layers (the bf16 experts: "
           "2.82 GB a layer)")
    counts["mixtral"] = serve_family(dev, seed, "mixtral_8x7b", cfg, buckets=INT8_BUCKETS,
                                     max_len=4224, pad_tiles=6, n_requests=4,
                                     kernel_attention=True, profile=True,
                                     cut=" (of 32: depth cut)")
    # MPT has 2048 positions: one 384-px tile an image ("pad") in the 1024 bucket.
    cfg = dataclasses.replace(radvlm_7b(), text=dataclasses.replace(
        mpt_7b(), num_layers=FAMILY_LAYERS), image_aspect_ratio="pad")
    header(f"[11b/12] LLaVA-MPT-7B, {FAMILY_LAYERS} of 32 layers, one 384-px tile an image, "
           "the 1024 bucket")
    counts["mpt"] = serve_family(dev, seed, "mpt_7b", cfg, buckets=MPT_BUCKETS,
                                 max_len=MPT_MAX_LEN, pad_tiles=1, n_requests=4,
                                 kernel_attention=False, profile=True,
                                 cut=" (of 32: depth cut)")
    for name, preset, kernel_attention, long_prompt in (
            ("llama3_8b", llama3_8b, True, 0),
            ("mistral_7b", mistral_7b, False, MISTRAL_LONG_PROMPT),
            ("gemma_2b", gemma_2b, False, 0)):
        n = preset().num_layers
        header(f"[11c/12] LLaVA-{name}, {FAMILY_LAYERS} of {n} layers")
        counts[name] = serve_family(
            dev, seed, name, dataclasses.replace(radvlm_7b(), text=dataclasses.replace(
                preset(), num_layers=FAMILY_LAYERS)),
            buckets=FAMILY_BUCKETS, max_len=4224, pad_tiles=6, n_requests=2,
            kernel_attention=kernel_attention, profile=False, long_prompt=long_prompt,
            fill_batch=1, cut=f" (of {n}: depth cut)")
    return counts


def tower_kernels(b, label: str, shape, seed: int) -> dict:
    """The tower's kernels at its own shapes on the served engine: K1 at
    `shape` (the largest the measured run gave it) against its plain
    version, timed beside SDPA and its bound; K3 at the tower pass's rows on
    the last tower layer's own int8 projections, bit for bit. Returns K1's
    numbers."""
    dev = b.model.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev, dtype=torch.bfloat16)

    n, sq, h, d = shape
    q, k, v = randn(*shape), randn(*shape), randn(*shape)
    scale = d ** -0.5
    out = fa.tower_attention(q, k, v)
    torch.cuda.synchronize()
    err = check_close("tower_attention", f"{label} K1 tower_attention [{n},{sq},{h},{d}]", out,
                      fa.attention_plain(q, k, v, None, None, False, scale))
    r = dict(shape=list(shape), max_abs_err=err,
             ms=cuda_ms(lambda: fa.tower_attention(q, k, v), batch=ATTN_BATCH),
             plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, None, None, False, scale),
                              reps=3),
             library_ms=cuda_ms(lambda: sdpa(q, k, v), batch=ATTN_BATCH),
             **bound(nbytes(q, k, v, out), 4 * n * h * sq * sq * d, "bf16"))
    print(f"  {label} K1 [{n},{sq},{h},{d}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA {r['library_ms']:.4f} ms"
          f"{against(r)}", flush=True)
    del q, k, v, out
    layer = b.model.vision_tower.layers[-1]
    for name in ("q", "k", "v", "o", "fc1", "fc2"):
        lin = getattr(layer, name, None)
        if not isinstance(lin, QLinear):
            continue
        kk = lin.weight.shape[1]
        xq, xs = w8.quantize_rows(randn(n * sq, kk))
        out = w8.w8a8_matmul(xq, xs, lin.weight, lin.scale)
        torch.cuda.synchronize()
        check_close("w8a8_matmul", f"{label} K3 w8a8_matmul tower {name} [{n * sq},{kk}]x"
                    f"[{kk},{lin.weight.shape[0]}]", out,
                    w8.w8a8_matmul_plain(xq, xs[:, 0], lin.weight, lin.scale, torch.bfloat16))
        del xq, xs, out
    return r


def tower_line(cfg) -> str:
    v, kind = cfg.vision, towers.kind(cfg.vision)
    extra = ""
    if kind == "clip" and v.s2_scales:
        extra = f", S2 scales {v.s2_scales} ({towers.passes_per_tile(v)} passes a tile)"
    elif kind == "eva":
        extra = f", rope {v.rope}, subln {v.subln}, swiglu {v.swiglu}, {v.norm} norms"
    return (f"  tower {kind}: {v.num_layers} layers, hidden {v.hidden_size}, {v.num_heads} heads "
            f"of {v.head_dim}, {towers.sequence_length(v)} tokens a pass at {v.image_size} px"
            f"{extra}; resampler {cfg.resampler.kind}: {tokens_per_tile(cfg)} image tokens a "
            f"tile of width {towers.feature_size(v)}; aspect {cfg.image_aspect_ratio}")


def phase_towers(dev, seed: int, header) -> dict:
    """Phase 12: M10's towers and resamplers in front of Qwen2-7B, each
    served like a decoder family of phase 11 (weights born int8, the int8
    reference check, a BatchWorker of 8 slots on the int8 cache, 4 CXR
    requests), then K1 and K3 at the tower's own shapes, a fill timed and
    profiled; then a tunable CLIP tower trained two micro-steps."""
    counts, k1 = {}, {}
    base7 = radvlm_7b()
    base = dataclasses.replace(base7, text=dataclasses.replace(
        base7.text, num_layers=TOWER_DECODER_LAYERS))
    cut = f" (of {base7.text.num_layers}: depth cut)"
    clip_name = "openai/clip-vit-large-patch14-336"
    rows = [
        ("a", "clip_s2", towers.with_tower(base, clip_name, s2=True, s2_scales=S2_SCALES),
         f"CLIP ViT-L/14-336 with S2 {S2_SCALES}", cut),
        ("b", "eva02_l_336", towers.with_tower(base, "EVA02-CLIP-L-14-336"),
         "EVA02-CLIP-L-14-336 (rope, subln, swiglu), anyres", cut),
        ("c", "eva_clip_8b", towers.with_tower(base, "EVA-CLIP-8B"),
         "EVA-CLIP-8B (32 x 4096, D = 128)", cut),
        ("d", "imagebind_huge", towers.with_tower(base, "imagebind_huge"),
         "ImageBind-huge, one pooled token, pad", cut),
        ("e", "siglip_qformer", dataclasses.replace(
            base, resampler=ResamplerConfig(kind="qformer"), image_aspect_ratio="pad"),
         "radvlm_7b's SigLIP + a Q-Former (bert-base, 32 queries, cross every 3 layers), pad",
         cut),
        ("e", "siglip_spatial_pool", dataclasses.replace(
            base, resampler=ResamplerConfig(kind="spatial_pool", stride=2)),
         "radvlm_7b's SigLIP + spatial_pool (stride 2, average), anyres", cut),
    ]
    for letter, label, cfg, what, cut in rows:
        header(f"[12{letter}/12] {what}")
        print(tower_line(cfg), flush=True)

        def after(b, samples, k1_shapes, label=label):
            from torch.profiler import ProfilerActivity, profile

            walls = [timed_fill(b, samples[0]) for _ in range(2)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiled = timed_fill(b, samples[0])
            print(f"  a fill of one request ({samples[0].length} tokens, "
                  f"{samples[0].tiles.shape[0]} tiles): {[round(w, 4) for w in walls]} s",
                  flush=True)
            device_breakdown(prof, min(walls), f"{label} fill", profiled_wall=profiled, top=8)
            k1[label] = tower_kernels(b, label, max(k1_shapes), seed + 41)

        counts[label] = serve_family(
            dev, seed, label, cfg, n_requests=TOWER_REQUESTS, kernel_attention=True,
            profile=False, cut=cut, after=after)
    header("[12f/12] a tunable CLIP-L/14-336 tower under radvlm_0_5b's decoder, masked_drop, "
           "training.loop.train")
    counts["tower_sft"] = phase_tower_sft(dev, seed)
    print("  K1 at the towers' shapes (NVIDIA card as above; kernel and SDPA: samples of "
          f"{ATTN_BATCH} calls in a row): " + json.dumps(k1), flush=True)
    return counts


def phase_tower_sft(dev, seed: int) -> dict:
    """Two micro-steps (one update) of `training.loop.train`: radvlm_0_5b's
    decoder under a tunable CLIP-L/14-336 tower, the masked_drop resampler,
    packed rows of 2048 tokens. The loss must be finite, the tower's
    gradient non-zero, and K2-lse, K7 and K8 must run at the tower's own
    [n, 577, 16, 64] (and the decoder's), where they are then held to their
    plain versions at the largest n the run gave them."""
    cfg = dataclasses.replace(
        towers.with_tower(radvlm_0_5b(), "openai/clip-vit-large-patch14-336"),
        resampler=ResamplerConfig(kind="masked_drop"))
    tok = CharTokenizer()
    t0 = time.perf_counter()
    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                                dtype=torch.float32)
    labels = optim.mark_trainable(model, optim.TrainConfig())
    torch.cuda.synchronize()
    n_tower = sum(p.numel() for n, p in model.named_parameters()
                  if n in labels and n.startswith("vision_tower"))
    print(f"  init {time.perf_counter() - t0:.2f} s: {n_tower / 1e6:.1f} M trainable tower "
          f"parameters, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card", flush=True)
    tower_sq = torch.zeros((), device=dev)

    def add_tower_grad(p) -> None:  # on the card: no host sync
        tower_sq.add_(p.grad.float().square().sum())

    hooks = [p.register_post_accumulate_grad_hook(add_tower_grad)
             for n, p in model.named_parameters()
             if n.startswith("vision_tower") and p.requires_grad]
    rng = np.random.default_rng(seed + 5)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_tower_train_{os.getpid()}")
    try:
        data_path = write_training_data(root, rng, TOWER_SFT_STEPS, height=336, widths=(300, 336))
        run = training_run_config(cfg, optim.TrainConfig(grad_accum_steps=2, total_steps=100),
                                  data_path, root, tok, seed, TOWER_SFT_STEPS,
                                  bucket=TOWER_TRAIN_BUCKET, max_steps=TOWER_SFT_STEPS)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        names = ("prefill_attention_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
        with recorded_shapes(names) as shapes:
            state, seen = run_training(run, tok, model, "tower SFT")
        torch.cuda.synchronize()
        print(f"  {TOWER_SFT_STEPS} micro-steps ({state.opt_state.count} update): "
              f"{time.perf_counter() - t0:.2f} s (the loader's start included)", flush=True)
    finally:
        for hk in hooks:
            hk.remove()
        shutil.rmtree(root, ignore_errors=True)
    counts = kernels.launch_counts()
    print(f"  launches: {counts}", flush=True)
    tower_norm = float(tower_sq) ** 0.5
    print(f"  tower gradient norm over the micro-steps: {tower_norm:.6e}", flush=True)
    if not (np.isfinite(tower_norm) and tower_norm > 0):
        raise AssertionError("tower SFT: the tower's gradient is zero or not finite")
    require_launched("sft", counts)
    own = (towers.sequence_length(cfg.vision), cfg.vision.num_heads, cfg.vision.head_dim)
    for name in names:
        at = sorted(shapes[name])
        print(f"  {name} shapes: {at}", flush=True)
        if not any(sh[1:] == own for sh in at):
            raise AssertionError(f"tower SFT: {name} never ran at the tower's [n, {own[0]}, "
                                 f"{own[1]}, {own[2]}]")
    if counts["tower_attention"]:
        raise AssertionError("tower SFT: K1 launched under a gradient")
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    # The tower's non-causal, unmasked D = 64 case at the run's own shape.
    n, sq, h, d = max(sh for sh in shapes["prefill_attention_lse"] if sh[1:] == own)
    g = torch.Generator(device=dev).manual_seed(seed + 43)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device=dev, dtype=torch.bfloat16)

    print(f"  K2-lse, K7 and K8 at the tower's [{n},{sq},{h},{d}] against their plain versions:",
          flush=True)
    training_kernel_case(dev, g, randn, "CLIP tower", n, sq, h, h, d, False, None)
    return counts


# ---------------------------------------------------------------------------
# Phase 13: M12's serving layouts (tensor parallelism, sequence parallelism,
# the engine fleet) on the one card.
# ---------------------------------------------------------------------------


def layout_samples(tok, cfg, prompts):
    return [multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, text), [img], cfg)
            for text, img in prompts]


def layout_engine(model, cfg, gen, buckets, **kw) -> ContinuousBatcher:
    return ContinuousBatcher(model, cfg, gen, num_slots=LAYOUT_SLOTS, max_len=4224,
                             prompt_buckets=buckets, kv_quant=True,
                             steps_per_sync=LAYOUT_STEPS, pipeline_depth=2, **kw)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def served_tokens(b, samples):
    """Greedy tokens of each sample through a batcher's run(), and the wall."""
    sync(b.device)
    t0 = time.perf_counter()
    reqs = [b.submit(s) for s in samples]
    done = {r.uid: r for r in b.run()}
    sync(b.device)
    wall = time.perf_counter() - t0
    for r in reqs:
        if done[r.uid].error:
            raise AssertionError(f"request {r.uid} failed: {done[r.uid].error}")
    return [done[r.uid].emitted for r in reqs], wall


@torch.inference_mode()
def first_step_logits(model, cfg, sample, tok0=None):
    """Prefill logits and, after feeding `tok0` (default: the prefill's
    argmax), the first decode step's, as the engine prefills (int8 cache):
    f32 on the host. Under `tp.active` on a TP rank: the rank-local model."""
    batch = batch_to_device(multimodal.collate([sample], pad_tiles=6, pad_to_multiple=128,
                                               left_pad=True), model.device)
    l = batch["tokens"].shape[1]
    cache, seg, lg0 = engine.prefill(model, cfg, batch, 4224, cache_format="int8")
    tok0 = lg0.argmax(-1) if tok0 is None else torch.tensor([tok0], device=model.device)
    _, _, lg1 = engine.decode_step(model, cfg, cache, seg, tok0, batch["lengths"], l)
    return lg0[0].float().cpu(), lg1[0].float().cpu()


@torch.inference_mode()
def sample_path_logits(model, cfg, sample, ids, step: int):
    """`path_logits` for a built sample (int8 cache): the logits from which
    the plain path picks token `step` after a full prefill and `ids` fed
    back one by one."""
    batch = batch_to_device(multimodal.collate([sample], pad_tiles=6, pad_to_multiple=128,
                                               left_pad=True), model.device)
    l = batch["tokens"].shape[1]
    cache, seg, logits = engine.prefill(model, cfg, batch, 4224, cache_format="int8")
    for t in range(step):
        cur = torch.tensor([ids[t]], device=model.device)
        cache, seg, logits = engine.decode_step(model, cfg, cache, seg, cur,
                                                batch["lengths"] + t, l + t)
    return logits[0].float()


def first_difference(got, want):
    return next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                None if len(got) == len(want) else min(len(got), len(want)))


def near_tie_gap(logits_fn, want, step) -> float:
    """The plain path's top-2 logit gap where tokens leave it (1e-2: the
    rule `same_tokens_or_near_tie` holds a kernel path to)."""
    top = torch.topk(logits_fn(want, step), 2).values
    return float(top[0] - top[1])


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def spawn_ranks(fn, world: int, payload: dict, root: str) -> list:
    """`world` processes on the card (torch.multiprocessing, spawned), a
    gloo group over a file store under `root`; rank r returns
    fn(rank, world, payload), pickled back."""
    return join_ranks(start_ranks(fn, world, payload, root), world, root)


def start_ranks(fn, world: int, payload: dict, root: str):
    """`spawn_ranks`' processes, started without waiting for them."""
    os.makedirs(root, exist_ok=True)
    return mp.start_processes(_rank_entry, args=(world, fn, payload, root), nprocs=world,
                              join=False, start_method="spawn")


def join_ranks(context, world: int, root: str) -> list:
    """Wait for `start_ranks`' processes (raising where one failed) and
    return each rank's result; on any failure stop the ones left."""
    import pickle

    try:
        while not context.join():
            pass
    finally:
        for proc in context.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_entry(rank, world, fn, payload, root):
    import pickle

    # Few intra-op threads: ranks whose idle threads spin beside each
    # other's collectives slow both down many times over.
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * world)))
    if payload["device"].startswith("cuda"):
        torch.cuda.set_device(payload["device"])
        kernels.lib()
    pmesh.init_distributed("gloo", "file://" + os.path.join(root, "store"), rank=rank,
                           world_size=world)
    try:
        result = fn(rank, world, payload)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


@torch.inference_mode()
def chunk_step_ms(b, sample) -> float:
    """Every slot filled with `sample`, then one greedy chunk timed by the
    host's clock around synchronizes: ms per decode step."""
    for _ in range(b.num_slots):
        b.submit(sample, 4 * b.steps_per_sync)
    pending = [b.queue.get_nowait() for _ in range(b.num_slots)]
    for i, r in enumerate(pending):
        b._fill_group([(i, r)])
    inflight = collections.deque()
    b._dispatch_chunk(inflight, force_sampling=False)  # the first chunk after fills
    b._process_chunk(inflight, [])
    sync(b.device)
    t0 = time.perf_counter()
    b._dispatch_chunk(inflight, force_sampling=False)
    b._process_chunk(inflight, [])
    sync(b.device)
    wall = time.perf_counter() - t0
    b.slot_req = [None] * b.num_slots
    return 1e3 * wall / b.steps_per_sync


def tp_rank(rank, world, payload):
    """One rank of the TP engine: radvlm_7b's int8 weights made from the
    seed (as the parent made them), sharded to this rank; the requests
    served, launch counts and K2's shapes over that run, the path's kernels
    at the rank's shapes against their plain versions, the first-step
    logits, a decode step timed, then spec_k."""
    dev, cfg = torch.device(payload["device"]), payload["cfg"]
    model = convert.random_quantized_params(
        cfg, torch.Generator(device=dev).manual_seed(payload["seed"]), device=dev, fuse=False)
    mesh = pmesh.make_mesh({"tensor": world})
    group = mesh.get_group("tensor")
    tok = CharTokenizer()
    samples = layout_samples(tok, cfg, payload["prompts"])
    gen = GenerationConfig(max_new_tokens=payload["new_tokens"], eos_token_ids=tok.eos_token_ids)
    t0 = time.perf_counter()
    b = layout_engine(model, cfg, gen, payload["buckets"], mesh=mesh)
    b.warmup()
    warm = time.perf_counter() - t0
    local = b.cfg
    kernels.reset_launch_counts()
    with recorded_shapes(["prefill_attention"]) as shapes:
        toks, wall = served_tokens(b, samples)
    counts = kernels.launch_counts()
    # K2, K4, K3 and K5/K6 at the rank's local shapes against their plain
    # versions, on the rank's own cache and sharded projections.
    engine_kernels(b, [s.length for s in samples], payload["seed"], f"TP rank {rank}")
    with tplib.active(group):
        lg0, lg1 = first_step_logits(b.model, local, samples[0], payload["tok0"])
    step_ms = chunk_step_ms(b, samples[0])
    # Not warmed up: the plain engine's fills and kernels already ran.
    bs = layout_engine(b.model, cfg, gen, payload["buckets"], mesh=mesh, spec_k=TP_SPEC_K)
    kernels.reset_launch_counts()
    spec_toks, spec_wall = served_tokens(bs, samples)
    spec_counts = kernels.launch_counts()
    gaps = []
    for i, (got, want) in enumerate(zip(spec_toks, toks)):
        step = first_difference(got, want)
        if step is not None:  # every rank takes the same branch: same tokens
            with tplib.active(group):
                gaps.append((i, step, near_tie_gap(
                    lambda ids, t: sample_path_logits(b.model, local, samples[i], ids, t),
                    want, step)))
    return dict(tokens=toks, wall=wall, warmup=warm, counts=counts, shapes=shapes,
                lg0=lg0, lg1=lg1, step_ms=step_ms, spec_tokens=spec_toks, spec_wall=spec_wall,
                spec_counts=spec_counts, spec_stats=dict(bs.spec_stats), gaps=gaps,
                provenance={k: v for k, v in b.kernel_provenance().items() if k != "launches"},
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0,
                weights_gb=sum(p.numel() * p.element_size() for p in b.model.parameters()) / 1e9)


def phase_tp(ctx, seed: int) -> dict:
    """13a: the TP engine (two processes on the card) against the one-card
    engine of the same weights."""
    t_phase = time.perf_counter()
    cfg, tok, samples = ctx["cfg"], ctx["tok"], ctx["samples"][:TP_REQUESTS]
    one_lg0, one_lg1 = first_step_logits(ctx["model"], cfg, samples[0])
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"smoke_tp_{os.getpid()}")
    try:
        ranks = spawn_ranks(tp_rank, TP_WORLD, dict(
            device=str(ctx["model"].device), cfg=cfg, seed=ctx["seed"],
            prompts=ctx["prompts"][:TP_REQUESTS], buckets=ctx["buckets"],
            new_tokens=NEW_TOKENS, tok0=int(one_lg0.argmax())), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    if any(r["tokens"] != r0["tokens"] or r["spec_tokens"] != r0["spec_tokens"] for r in ranks):
        raise AssertionError("TP: the ranks emitted other tokens")
    t = cfg.text
    h, hkv = t.num_heads // TP_WORLD, t.num_kv_heads // TP_WORLD
    print(f"  TP = {TP_WORLD} over gloo on the one card: rank weights {r0['weights_gb']:.3f} GB, "
          f"peak {max(r['peak_gib'] for r in ranks):.2f} GiB a rank, warmup "
          f"{r0['warmup']:.2f} s; local heads {h}|{hkv}, intermediate "
          f"{t.intermediate_size // TP_WORLD}", flush=True)
    print(f"  provenance (rank 0): {r0['provenance']}", flush=True)
    for r, rk in enumerate(ranks):
        print(f"  rank {r} launches in the measured run: {rk['counts']}", flush=True)
        require_launched("tp", rk["counts"])
    k2 = sorted(r0["shapes"]["prefill_attention"])
    print(f"  K2 shapes in the measured run: {k2}", flush=True)
    if not k2 or any(sh[2] != h for sh in k2):
        raise AssertionError(f"TP: K2 ran at other than {h} local heads: {k2}")
    n_tok = sum(len(x) for x in r0["tokens"])
    print(f"  {TP_REQUESTS} requests, {n_tok} tokens in {r0['wall']:.3f} s "
          f"({n_tok / r0['wall']:.1f} tokens/s, fills included)", flush=True)
    for stage, out, ref in (("prefill", r0["lg0"], one_lg0), ("first decode step", r0["lg1"],
                                                               one_lg1)):
        err = rel_err(out, ref)
        print(f"  TP {stage} logits against the one-card engine's: max rel err {err:.3e} "
              f"(bound {LAYOUT_LOGITS_TOL}); argmax TP {int(out.argmax())}, one card "
              f"{int(ref.argmax())}", flush=True)
        if not err <= LAYOUT_LOGITS_TOL:
            raise AssertionError(f"TP: {stage} logits off the one-card engine's")
    one = ctx["one_tokens"][:TP_REQUESTS]
    agree = sum(a == b for x, y in zip(r0["tokens"], one) for a, b in zip(x, y))
    lead = [first_difference(x, y) for x, y in zip(r0["tokens"], one)]
    print(f"  greedy tokens equal to the one-card engine's: {agree} of {sum(map(len, one))} "
          f"(first difference per request: {lead}; W8A8 of a row-parallel layer quantizes "
          f"the rank's half of K)", flush=True)
    print(f"  TP decode step ({LAYOUT_SLOTS} slots): {r0['step_ms']:.2f} ms against "
          f"{ctx['one_step_ms']:.2f} ms on the one-card engine "
          f"({r0['step_ms'] / ctx['one_step_ms']:.2f}x)", flush=True)
    print(f"  spec_k={TP_SPEC_K}: {r0['spec_stats']}, {r0['spec_wall']:.3f} s; launches "
          f"(rank 0): {r0['spec_counts']}", flush=True)
    for rk in ranks:
        require_launched("tp_spec", rk["spec_counts"])
    for i, step, gap in r0["gaps"]:
        print(f"  spec request {i}: tokens leave TP plain greedy at step {step}; the plain "
              f"path's top-2 logit gap there is {gap:.3e} (limit 1.000e-02)", flush=True)
        if not gap < 1e-2:
            raise AssertionError("TP spec: tokens differ from TP plain greedy")
    print(f"  13a: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}


def phase_sp(ctx, seed: int) -> dict:
    """13b: make_sp_generate_fn over one prompt in the 4096 bucket, the
    bf16 and the int8 cache, against the one-card engine."""
    t_phase = time.perf_counter()
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    dev = model.device
    rng = np.random.default_rng(seed + 31)
    text = render_generation_prompt([("user", "<image>\n" + QUESTIONS[0])], template=QWEN_CHATML)
    sample = question_sample(tok, cfg, text, cxr_image(rng), SP_BUCKET)
    batch = batch_to_device(multimodal.collate([sample], pad_len=SP_BUCKET, pad_tiles=6,
                                               pad_to_multiple=128, left_pad=True), dev)
    pmesh.init_distributed(SP_BACKEND, device=dev)
    try:
        mesh = pmesh.make_mesh({"seq": SP_WORLD})
        gen = GenerationConfig(max_new_tokens=SP_NEW, eos_token_ids=())
        out, counts = {}, {}
        for q8 in (False, True):
            fn = engine.make_sp_generate_fn(cfg, mesh, gen, kv_quant=q8)
            sync(dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn(model, batch)
            sync(dev)
            wall = time.perf_counter() - t0
            counts[q8] = c = kernels.launch_counts()
            out[q8] = res["tokens"][0].tolist()
            print(f"  SP generate ({SP_BACKEND}, seq = {SP_WORLD}), {'int8' if q8 else 'bf16'}"
                  f" cache: prompt {sample.length} tokens in the {SP_BUCKET} bucket, {SP_NEW} "
                  f"tokens in {wall:.3f} s; launches {c}", flush=True)
            require_launched("sp", c)
            # The ring: one K2-lse launch a layer for each pair a rank holds
            # (rank r of n: r + 1 under the causal mask).
            pairs = cfg.text.num_layers * (dist.get_rank() + 1)
            if c["prefill_attention_lse"] != pairs:
                raise AssertionError(f"SP: K2-lse launched {c['prefill_attention_lse']} times, "
                                     f"the ring's pairs are {pairs}")
            if c["prefill_attention"] or c["decode_attention_q8"]:
                raise AssertionError("SP: K2 or K4 ran beside the ring and the SP merge")
        step = first_difference(out[True], out[False])
        if step is not None:
            gap = near_tie_gap(lambda ids, t: sample_path_logits(model, cfg, sample, ids, t),
                               out[False], step)
            print(f"  SP int8-cache tokens leave the bf16 cache's at step {step}; the plain "
                  f"path's top-2 gap there {gap:.3e} (limit 1.000e-02)", flush=True)
            if not gap < 1e-2:
                raise AssertionError("SP: the int8 cache's tokens differ from the bf16 cache's")
        else:
            print(f"  SP int8-cache tokens equal the bf16 cache's ({SP_NEW} of {SP_NEW})",
                  flush=True)
        # The first step's logits against the one-card engine's: the ring
        # prefill, then one SP decode step over the split int8 cache.
        l = batch["tokens"].shape[1]
        max_len = l + 128
        prefill = engine.make_sp_prefill_fn(cfg, mesh)
        cache, seg, lg0 = prefill(model, batch, max_len)
        from radvlm_tpu_torch.parallel.sp_decode import make_sp_decode_step

        n, r = dist.get_world_size(), dist.get_rank()
        own = slice(r * max_len // n, (r + 1) * max_len // n)
        kq = [kv_quant.quantize_kv(c, cfg.text.num_kv_heads) for c in cache]
        local = (kq[0][0][:, :, own].contiguous(), kq[1][0][:, :, own].contiguous(),
                 kq[0][1][..., own].contiguous(), kq[1][1][..., own].contiguous())
        tok0 = lg0.argmax(-1)
        _, _, lg1 = make_sp_decode_step(cfg.text, mesh, kv_quant=True)(
            model.text, local, seg[:, own].contiguous(), tok0, batch["lengths"], l)
        del cache, local, kq
    finally:
        dist.destroy_process_group()
    ref0, ref1 = first_step_logits(model, cfg, sample, int(tok0[0]))
    for stage, got, ref in (("prefill", lg0[0].float().cpu(), ref0),
                            ("first decode step", lg1[0].float().cpu(), ref1)):
        err = rel_err(got, ref)
        print(f"  SP {stage} logits against the one-card engine's: max rel err {err:.3e} "
              f"(bound {LAYOUT_LOGITS_TOL}); argmax SP {int(got.argmax())}, one card "
              f"{int(ref.argmax())}", flush=True)
        if not err <= LAYOUT_LOGITS_TOL:
            raise AssertionError(f"SP: {stage} logits off the one-card engine's")
    print(f"  13b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts[True]


def question_sample(tok, cfg, text, image, bucket):
    """`text` with its question repeated until the prompt fills most of
    `bucket` (an anyres CXR image beside it)."""
    sample = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, text), [image],
                                     cfg)
    pad = " Compare with the prior study and describe any change."
    while True:
        longer = text.replace("<image>\n", "<image>\n" + pad, 1)
        s = multimodal.build_sample(multimodal.tokenize_with_images(tok.encode, longer), [image],
                                    cfg)
        if s.length > bucket - 128:
            return sample
        text, sample = longer, s


def phase_fleet(ctx, seed: int) -> dict:
    """13c: a fleet of FLEET_SIZE engines sharing the card and the model."""
    t_phase = time.perf_counter()
    model, cfg, tok = ctx["model"], ctx["cfg"], ctx["tok"]
    samples = ctx["samples"]
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=tok.eos_token_ids)
    dev = model.device
    fleet = FleetEngine(model, cfg, gen, fleet_size=FLEET_SIZE, devices=[dev] * FLEET_SIZE,
                        num_slots=LAYOUT_SLOTS, max_len=4224, prompt_buckets=ctx["buckets"],
                        kv_quant=True, steps_per_sync=LAYOUT_STEPS, pipeline_depth=2)
    t0 = time.perf_counter()
    fleet.warmup()
    print(f"  fleet of {FLEET_SIZE} on {dev}: one model ({fleet.batchers[0].model is model}), "
          f"warmup {time.perf_counter() - t0:.2f} s", flush=True)
    fleet.start()
    try:
        sync(dev)
        kernels.reset_launch_counts()
        t0, t_mono = time.perf_counter(), time.monotonic()
        reqs = [fleet.submit(s) for s in samples]
        done = {r.uid: r for r in fleet.drain(idle_timeout=600)}
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        toks = [done[r.uid].emitted for r in reqs]
        if any(done[r.uid].error for r in reqs):
            raise AssertionError(f"fleet: failed requests {[done[r.uid].error for r in reqs]}")
        n_tok = sum(map(len, toks))
        print(f"  {len(samples)} requests, {n_tok} tokens in {wall:.3f} s "
              f"({n_tok / wall:.1f} tokens/s, fills included) against {ctx['one_wall']:.3f} s "
              f"on one engine; fills per engine "
              f"{[b.host_stats['fills'] for b in fleet.batchers]}", flush=True)
        print(f"  launches in the measured run: {counts}", flush=True)
        require_launched("fleet", counts)
        engine_kernels(fleet.batchers[0], [s.length for s in samples], seed, "fleet engine 0")
        windows = [(i, a, z) for i, a, z in fleet.busy_log]
        overlap = max((min(z0, z1) - max(a0, a1) for i0, a0, z0 in windows
                       for i1, a1, z1 in windows if i0 < i1), default=0.0)
        print(f"  busy windows {[(i, round(a - t_mono, 3), round(z - t_mono, 3)) for i, a, z in windows]}"
              f" s; engines 0 and 1 busy together {overlap:.3f} s", flush=True)
        if not overlap > 0:
            raise AssertionError("fleet: the engines' busy windows do not overlap")
        for i, (got, want) in enumerate(zip(toks, ctx["one_tokens"])):
            step = first_difference(got, want)
            if step is not None:
                gap = near_tie_gap(lambda ids, t: sample_path_logits(model, cfg, samples[i], ids,
                                                                     t), want, step)
                print(f"  fleet request {i}: tokens leave the one engine's at step {step}; "
                      f"the plain path's top-2 gap there {gap:.3e} (limit 1.000e-02)",
                      flush=True)
                if not gap < 1e-2:
                    raise AssertionError("fleet: tokens differ from one engine's")
        print(f"  fleet tokens: {sum(g == w for g, w in zip(toks, ctx['one_tokens']))} of "
              f"{len(toks)} requests equal one engine's", flush=True)
        # A keep_kv turn, then its resume: back to the engine that holds
        # the rows; the tokens of a full re-prefill.
        r1 = fleet.submit(samples[0], keep_kv=True)
        list(fleet.drain(idle_timeout=600))
        snap = r1.kv_snapshot
        e = snap.engine_idx
        q2 = tok.encode("<|im_end|>\n<|im_start|>user\nIs the heart enlarged?<|im_end|>\n"
                        "<|im_start|>assistant\n")
        delta = list(r1.emitted[snap.n_reply:]) + q2
        before = [b.resume_fills for b in fleet.batchers]
        r2 = fleet.submit(multimodal.build_sample(delta, [], cfg), resume=snap)
        list(fleet.drain(idle_timeout=600))
        gained = [b.resume_fills - n for b, n in zip(fleet.batchers, before)]
        if r2.error or gained[e] != 1 or sum(gained) != 1:
            raise AssertionError(f"fleet resume: routed {gained} for engine {e}, {r2.error}")
    finally:
        fleet.shutdown()
    full = multimodal.build_sample(ctx["ids"][0] + list(r1.emitted) + q2, [ctx["prompts"][0][1]],
                                   cfg)
    one = layout_engine(model, cfg, gen, ctx["buckets"] + (4096,))
    want, _ = served_tokens(one, [full])
    step = first_difference(r2.emitted, want[0])
    print(f"  turn 2 resumed on engine {e} (snapshot of {snap.widx} positions, delta "
          f"{len(delta)} tokens): {len(r2.emitted)} tokens, first difference from a full "
          f"re-prefill at {step}", flush=True)
    if step is not None:
        gap = near_tie_gap(lambda ids, t: sample_path_logits(model, cfg, full, ids, t), want[0],
                           step)
        print(f"  the full re-prefill's top-2 gap there {gap:.3e} (limit 1.000e-02)", flush=True)
        if not gap < 1e-2:
            raise AssertionError("fleet resume: tokens differ from a full re-prefill's")
    print(f"  13c: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def phase_layouts(dev, seed: int, header) -> dict:
    """13: radvlm_7b's int8 weights made once from the seed (unfused, for
    the TP ranks to make alike), its decoder cut to LAYOUT_LAYERS of 28,
    fused for the one-card engine, whose tokens, logits and decode step the
    layouts are held to."""
    cfg = radvlm_7b()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=LAYOUT_LAYERS))
    t0 = time.perf_counter()
    model = convert.random_quantized_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 13), device=dev, fuse=False)
    radvlm.fuse_for_inference(model, cfg)
    tok = CharTokenizer()
    rng = np.random.default_rng(seed + 13)
    prompts = [(render_generation_prompt([("user", "<image>\n" + QUESTIONS[i % len(QUESTIONS)])],
                                         template=QWEN_CHATML), cxr_image(rng))
               for i in range(LAYOUT_REQUESTS)]
    samples = layout_samples(tok, cfg, prompts)
    # The fewest phase-5 buckets that hold the prompts: a bucket costs a fill
    # in every engine's warmup.
    buckets = tuple(sorted({min(b for b in INT8_BUCKETS + (4096,) if b >= s.length)
                            for s in samples}))
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=tok.eos_token_ids)
    b = layout_engine(model, cfg, gen, buckets)
    b.warmup()
    one_tokens, one_wall = served_tokens(b, samples)
    one_step_ms = chunk_step_ms(b, samples[0])
    del b
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"  radvlm_7b int8 (seed {seed + 13}), {LAYOUT_REQUESTS} prompts of "
          f"{sorted(s.length for s in samples)} tokens, buckets {buckets}; one-card engine "
          f"({LAYOUT_SLOTS} slots, int8 cache): {one_wall:.3f} s, decode step "
          f"{one_step_ms:.2f} ms; set up in {time.perf_counter() - t0:.1f} s", flush=True)
    ctx = dict(model=model, cfg=cfg, tok=tok, prompts=prompts, samples=samples,
               ids=[multimodal.tokenize_with_images(tok.encode, p) for p, _ in prompts],
               buckets=buckets, one_tokens=one_tokens, one_wall=one_wall,
               one_step_ms=one_step_ms, seed=seed + 13)
    counts = {}
    header(f"[13a/13] tensor parallelism: TP = {TP_WORLD} (gloo, two processes on the card)")
    counts["tp"] = phase_tp(ctx, seed)
    header(f"[13b/13] sequence parallelism: ring prefill and SP decode ({SP_BACKEND}, "
           f"seq = {SP_WORLD})")
    counts["sp"] = phase_sp(ctx, seed)
    header(f"[13c/13] a fleet of {FLEET_SIZE} engines on the card")
    counts["fleet"] = phase_fleet(ctx, seed)
    return counts


# ---------------------------------------------------------------------------
# Phase 14: M12's training half (parallel/sharding.py, parallel/ring.py)
# ---------------------------------------------------------------------------


def mesh_host_batch(cfg, tok, seed: int, root: str) -> dict:
    """MESH_ROWS packed 4096-token rows of phase 8's data (one image cell and
    one text cell a row), collated into one host batch."""
    rng = np.random.default_rng(seed + 14)
    data_path = write_training_data(root, rng, MESH_ROWS)
    run = training_run_config(cfg, optim.TrainConfig(), data_path, root, tok, seed, MESH_ROWS)
    with open(data_path) as f:
        cells = json.load(f)
    loader = PrefetchLoader(
        LlavaJsonDataset(cells=cells, image_root=root, cfg=cfg, tokenize_fn=tok.encode,
                         max_len=TRAIN_BUCKET.max_len),
        1, buckets=run.buckets, seed=run.seed, num_workers=2, pack_factor=2)
    rows = list(loader.epoch(0))
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def smoke_adapters(model, seed: int) -> dict:
    """Rank-MESH_LORA_RANK adapters over the decoder's projections from the
    seed (`init_lora`), b drawn non-zero too, so both factors take a
    gradient on the first step; every process makes the same ones."""
    g = torch.Generator(device=model.device).manual_seed(seed + 15)
    adapters = lora_lib.init_lora(model, lora_lib.LoraConfig(rank=MESH_LORA_RANK), g)
    with torch.no_grad():
        for ad in adapters.values():
            ad["b"].normal_(0.0, 0.01, generator=g)
    return adapters


def mesh_micro_step(dev, cfg, seed: int, host: dict, mesh=None, attn_impl: str = "auto",
                    steps: int = 2, pp_cfg=None, lora: bool = False, save=None,
                    keep: bool = False) -> dict:
    """radvlm_0_5b's f32 masters from the seed, set up over `mesh` (None: one
    card) with every part tunable (or, with `lora`, frozen under rank-16
    adapters; with `pp_cfg`, as pipeline stages), and `steps` micro-steps
    of this rank's part of `host` (the same batch each time): the first's
    loss, grad norm and launch counts (from 0 just before it), the last's
    wall and device time under torch.profiler, the peak memory; with
    `save`, the state after the first step saved there (seconds); with
    `keep`, the train state itself under "state"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radvlm_tpu_torch.parallel import pp
    from radvlm_tpu_torch.training import checkpoint as ckpt

    model = convert.init_params(cfg, torch.Generator(device=dev).manual_seed(seed + 14),
                                device=dev, dtype=torch.float32)
    tc = optim.TrainConfig(grad_accum_steps=1, warmup_ratio=0.0, learning_rate=MESH_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if lora:
        lcfg = lora_lib.LoraConfig(rank=MESH_LORA_RANK)
        state, base, lora_step = tstep.setup_lora_training(
            cfg, tc, lcfg, model, attn_impl=attn_impl, mesh=mesh,
            adapters=smoke_adapters(model, seed))

        def step_fn(state, batch):
            return lora_step(state, base, batch)
    elif pp_cfg is not None:
        state, step_fn, _ = pp.setup_pp_training(mesh, cfg, tc, model, pp_cfg=pp_cfg)
    else:
        state, step_fn, _ = tstep.setup_training(cfg, tc, model, attn_impl=attn_impl, mesh=mesh)
    batch = batch_to_device(train_loop.rank_batch(host, state.mesh, attn_impl), dev)
    kernels.reset_launch_counts()
    out = {}
    for i in range(steps):
        with contextlib.ExitStack() as stack:
            if i == steps - 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prof = stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
        if i == steps - 1:
            out["wall"] = time.perf_counter() - t0
        if i == 0:
            out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       counts=dict(kernels.launch_counts()))
            if save:
                t1 = time.perf_counter()
                assert ckpt.save_state(ckpt.CheckpointManager(save), 1, state, force=True)
                out["save_s"] = time.perf_counter() - t1
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    if pp_cfg is not None:
        out["transport"] = pp.hop_transport(state.mesh.group("stage"), dev)
    if keep:
        out["state"] = state
    return dict(out, device=busy if busy > 0 else None, peak=torch.cuda.max_memory_allocated(dev),
                rows=int(batch["tokens"].shape[0]), length=int(batch["tokens"].shape[1]),
                stage=None if state.mesh is None else state.mesh.index["stage"])


def mesh_rank(rank, world, payload):
    """A spawned rank of 14a, 14b, 14d, 14e and 14f: one micro-step of each
    case of `payload["cases"]` (label, mesh shape, options) in turn (gloo,
    the card shared)."""
    import pickle

    from radvlm_tpu_torch.parallel import pp

    dev = torch.device(payload["device"])
    # The parent measures its one-card steps while the ranks start up; the
    # cases begin once it writes `go` beside the host batch.
    while not os.path.exists(payload["go"]):
        time.sleep(0.05)
    with open(payload["host_file"], "rb") as f:
        host = pickle.load(f)
    out, meshes = [], {}
    for label, shape, opts in payload["cases"]:
        t0 = time.perf_counter()
        opts = dict(opts)
        if "pp" in opts:
            opts["pp_cfg"] = pp.PPStepConfig(**opts.pop("pp"))
        key = tuple(sorted(shape.items()))
        if key not in meshes:  # a shape's groups serve each of its cases
            meshes[key] = pmesh.make_mesh(shape)
        out.append(mesh_micro_step(dev, payload["cfg"], payload["seed"], host, meshes[key],
                                   steps=1, **opts))
        gc.collect()
        torch.cuda.empty_cache()
        out[-1]["case_s"] = time.perf_counter() - t0
    return out


def mesh_report(label: str, r: dict, one: dict, tol: float) -> None:
    """Print a run's numbers against the one-card step's; fail past `tol`."""
    device = "not measured" if r["device"] is None else f"{r['device']:.3f} s"
    extra = f"; hop {r['transport']}" if "transport" in r else ""
    extra += f"; saved in {r['save_s']:.1f} s" if "save_s" in r else ""
    extra += f"; the case {r['case_s']:.1f} s" if "case_s" in r else ""
    print(f"  {label}: {r['rows']} x {r['length']} tokens a rank, loss {r['loss']:.6f}, "
          f"grad_norm {r['grad_norm']:.6f}; a micro-step under torch.profiler {r['wall']:.3f} s "
          f"wall, device {device}; peak memory {r['peak'] / 2**30:.2f} GiB (one card "
          f"{one['peak'] / 2**30:.2f} GiB){extra}; launches {r['counts']}", flush=True)
    for key in ("loss", "grad_norm"):
        err = abs(r[key] - one[key]) / abs(one[key])
        print(f"    {key} against the one-card step's {one[key]:.6f}: rel err {err:.3e} "
              f"(bound {tol:.0e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{label}: {key} off the one-card step's")


def mesh_counts(cfg, *, decoder_calls: int, tower: bool, lora: bool = False) -> dict:
    """K2-lse / K7 / K8 (and K1 under a frozen tower) a micro-step:
    `decoder_calls` attention calls of the decoder (a layer a microbatch),
    the forward twice under remat, and on the rank that runs the tower its
    layers once (the forward twice) under a gradient, or through K1 once
    when it is frozen (LoRA)."""
    tower_calls = cfg.vision.num_layers if tower else 0
    bwd = decoder_calls + (0 if lora else tower_calls)
    want = {"prefill_attention_lse": 2 * bwd, "flash_attention_bwd_dkv": bwd,
            "flash_attention_bwd_dq": bwd}
    if lora and tower:
        want["tower_attention"] = tower_calls
    return want


def same_trees(label: str, got: dict, want: dict, atol: float) -> float:
    """Leaf for leaf: the same paths and shapes, every element within atol;
    returns the largest difference."""
    a, b = quant_io._flatten_tree(got), quant_io._flatten_tree(want)
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: leaves differ: {sorted(set(a) ^ set(b))[:5]}")
    worst = 0.0
    for k in b:
        if a[k].shape != b[k].shape:
            raise AssertionError(f"{label}: {k} is {tuple(a[k].shape)}, not {tuple(b[k].shape)}")
        worst = max(worst, float((a[k].float() - b[k].float()).abs().max()))
    print(f"  {label}: {len(b)} leaves, largest difference {worst:.3e} (bound {atol:.1e})",
          flush=True)
    if not worst <= atol:
        raise AssertionError(f"{label}: {worst} past {atol}")
    return worst


def phase_train_mesh(dev, seed: int, header) -> dict:
    """14: radvlm_0_5b at full width (SigLIP-SO400M 26 layers, Qwen2-0.5B 24
    layers), f32 masters from the seed, MESH_ROWS of phase 8's packed
    4096-token rows: the one-card step and the one-card LoRA step; one
    spawn of two gloo processes for 14a ZeRO-3 (its step saved), 14b TP,
    14d GPipe and 14e the interleaved pipeline over {stage: 2}, 14f LoRA
    under TP; 14c the zigzag ring at seq = 1 (one NCCL rank) with its
    launch counts and its pairs' kernels held to their plain versions at
    the half-chunk shape; 14g `read_params` of 14a's saved step against the
    one-card step's, leaf for leaf."""
    import pickle

    from radvlm_tpu_torch.training import checkpoint as ckpt

    cfg, tok = radvlm_0_5b(), CharTokenizer()
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    saves = os.path.join(build, f"smoke_mesh_ckpt_{os.getpid()}")
    spawn_root = os.path.join(build, f"smoke_mesh_ranks_{os.getpid()}")
    go, host_file = os.path.join(spawn_root, "go"), os.path.join(spawn_root, "host.pkl")
    pipe = dict(n_microbatches=PP_MICROBATCHES)
    cases = [("14a", {"fsdp": 2}, dict(save=os.path.join(saves, "fsdp"))),
             ("14b", {"tensor": 2}, {}),
             ("14d", {"stage": MESH_STAGES}, dict(pp=pipe)),
             ("14e", {"stage": MESH_STAGES}, dict(pp=dict(pipe, interleave=PP_INTERLEAVE))),
             ("14f", {"tensor": 2}, dict(lora=True))]
    # The two ranks start up (imports, CUDA, gloo) while this process makes
    # the data and measures the one-card steps; they begin at `go`.
    ranks_ctx = start_ranks(mesh_rank, 2, dict(device=str(dev), cfg=cfg, seed=seed, cases=cases,
                                               go=go, host_file=host_file), spawn_root)
    saver = None
    try:
        root = os.path.join(build, f"smoke_mesh_{os.getpid()}")
        try:
            host = mesh_host_batch(cfg, tok, seed, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        with open(host_file + ".tmp", "wb") as f:
            pickle.dump(host, f)
        os.replace(host_file + ".tmp", host_file)
        lora_one = mesh_micro_step(dev, cfg, seed, host, steps=1, lora=True)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_report("one card, LoRA", lora_one, lora_one, 0.0)
        lora_want = mesh_counts(cfg, decoder_calls=cfg.text.num_layers, tower=True, lora=True)
        require_counts("one card, LoRA", lora_one["counts"], lora_want)
        one = mesh_micro_step(dev, cfg, seed, host, steps=1, keep=True)
        mesh_report("one card", one, one, 0.0)
        # The one-card step is written while the ranks run (14g reads it).
        one_state = one.pop("state")
        saved = {}

        def save_one():
            t0 = time.perf_counter()
            saved["ok"] = ckpt.save_state(ckpt.CheckpointManager(os.path.join(saves, "one")), 1,
                                          one_state, force=True)
            saved["s"] = time.perf_counter() - t0

        saver = threading.Thread(target=save_one)
        saver.start()
        header("[14a-f/14] ZeRO-3 {fsdp: 2}, TP {tensor: 2} (7 | 1 local heads), GPipe and "
               "the interleaved pipeline {stage: 2}, LoRA under TP: two processes on the card "
               "over gloo")
        open(go, "w").close()
        ranks = join_ranks(ranks_ctx, 2, spawn_root)
        ranks_ctx = None
        saver.join()
        print(f"  the one-card step saved in {saved['s']:.1f} s, beside the ranks", flush=True)
        if not saved.get("ok"):
            raise AssertionError("the one-card step was not saved")
        del one_state
        gc.collect()
        torch.cuda.empty_cache()
        tols = {"14a": FSDP_TOL, "14b": TP_TRAIN_TOL, "14d": PP_TOL, "14e": PP_TOL,
                "14f": LORA_TP_TOL}
        for r, results in enumerate(ranks):
            for (label, shape, opts), res in zip(cases, results):
                yard = lora_one if opts.get("lora") else one
                mesh_report(f"{label} {shape} rank {r}", res, yard, tols[label])
                if "pp" in opts:
                    want = mesh_counts(cfg, tower=res["stage"] == 0, decoder_calls=(
                        cfg.text.num_layers // MESH_STAGES * PP_MICROBATCHES))
                    print(f"    {label} rank {r} launches predicted {want}", flush=True)
                    require_counts(f"{label} rank {r}", res["counts"], want)
                elif opts.get("lora"):
                    require_counts(f"{label} rank {r}", res["counts"], lora_want)
                elif not all(res["counts"][k] for k in PATH_KERNELS["mesh_ring"]):
                    raise AssertionError(f"{label}: K2-lse, K7 or K8 never launched on rank {r}")
        header("[14g/14] read_params of 14a's ZeRO-3 step against the one-card step's")
        t_read = time.perf_counter()
        zero3 = ckpt.read_params(ckpt.CheckpointManager(os.path.join(saves, "fsdp")), 1)
        card = ckpt.read_params(ckpt.CheckpointManager(os.path.join(saves, "one")), 1)
        print(f"  read_params of both steps: {time.perf_counter() - t_read:.1f} s", flush=True)
        # One Adam step moves an element by at most lr / (1 - b1) x (1 - b1):
        # lr; where the two gradients differ in sign, the steps differ by 2 lr.
        same_trees("14g ZeRO-3 step vs one card", zero3, card, 2.5 * MESH_LR)
        del zero3, card
    finally:
        if ranks_ctx is not None:  # a failure before the ranks were joined: stop them
            for proc in ranks_ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        if saver is not None:
            saver.join()
        shutil.rmtree(spawn_root, ignore_errors=True)
        shutil.rmtree(saves, ignore_errors=True)
    counts = {}
    header("[14c/14] the zigzag ring at seq = 1 (one NCCL rank): three K2-lse pairs a layer")
    pmesh.init_distributed("nccl", device=dev)
    try:
        from radvlm_tpu_torch.parallel import ring as ring_lib

        mesh = pmesh.make_mesh({"seq": 1})
        ring_lib.enable_ring_attention(mesh, schedule="zigzag")
        try:
            res = mesh_micro_step(dev, cfg, seed, host, mesh, attn_impl="ring")
        finally:
            ring_lib.enable_ring_attention(None)
    finally:
        dist.destroy_process_group()
    mesh_report("14c zigzag ring", res, one, RING_TOL)
    counts["mesh_ring"] = c = res["counts"]
    require_launched("mesh_ring", c)
    # Three pairs a decoder layer (lo x lo, hi x lo, hi x hi), one call a
    # tower layer; remat runs each forward twice.
    pairs = 3 * cfg.text.num_layers + cfg.vision.num_layers
    want = {"prefill_attention_lse": 2 * pairs, "flash_attention_bwd_dkv": pairs,
            "flash_attention_bwd_dq": pairs}
    print(f"  14c launches: {c}; predicted {want}", flush=True)
    require_counts("14c", c, want)
    if c["prefill_attention"] or c["tower_attention"]:
        raise AssertionError("14c: K1 / K2 without the lse launched under a gradient")
    g = torch.Generator(device=dev).manual_seed(seed + 141)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)

    half = res["length"] // 2
    for label, causal in (("zigzag lo x lo, hi x hi", True), ("zigzag hi x lo", False)):
        training_kernel_case(dev, g, randn, label, res["rows"], half, cfg.text.num_heads,
                             cfg.text.num_kv_heads, cfg.text.head_dim, causal, "packed")
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
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
    print(f"[1/12] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t_start = t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"[2/12] build: {time.perf_counter() - t0:.2f} s ({kernels.BUILD_DIR})", flush=True)

    def header(text):
        print(f"{text} (at {time.perf_counter() - t_start:.0f} s)", flush=True)

    header("[3/12] kernels against their plain versions")
    results = phase_kernels(dev, 1234 + args.seed)

    header("[4/12] bf16 slice: radvlm_7b, random bf16 weights")
    counts = {"bf16": phase_slice(dev, args.seed)}
    gc.collect()  # the bf16 model (15 GiB) goes before the int8 one comes
    torch.cuda.empty_cache()

    header("[5/12] int8 continuous path: radvlm_7b, weights born int8, BatchWorker")
    counts["int8"], ctx = phase_int8(dev, args.seed)
    gc.collect()  # phase 5's KV cache goes before the spec engines' come
    torch.cuda.empty_cache()

    header(f"[6/12] speculative decoding (spec_k={SPEC_K}) and sessions on the int8 model")
    counts["spec_int8"] = phase_spec(ctx, True, SPEC_REQUESTS)
    gc.collect()
    torch.cuda.empty_cache()
    counts["spec_bf16"] = phase_spec(ctx, False, SPEC_REQUESTS // 2)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7/12] the pre-quantized artifact: radvlm_7b int4, save_quantized -> worker_cli")
    counts["int4"] = phase_artifact(dev, args.seed, ctx)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7b/12] fused W8A8 (K13) on the int8 model")
    counts["fused"] = phase_fused(ctx)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7c/12] evaluation: build_task_dataset + run_task on the int8 model")
    counts["eval"] = phase_eval(ctx, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[7d/12] text-LM serving: the GREEN judge (Llama-2-7B) and the local LLM client")
    counts.update(phase_text_lm(ctx, args.seed))
    gc.collect()
    torch.cuda.empty_cache()

    header("[7e/12] the serving front: web UI -> controller -> BatchWorker on the int8 model")
    counts["front"] = phase_front(ctx, args.seed)
    del ctx  # the int8 model goes before the trainers' come
    gc.collect()
    torch.cuda.empty_cache()

    header("[8/12] SFT: radvlm_0_5b, f32 master weights, every part tunable, training.loop.train")
    counts["sft"] = phase_sft(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[9/12] QLoRA: radvlm_7b, int8 base, rank-128 adapters, training.loop.train")
    counts["qlora"] = phase_qlora(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[10/12] DPO: radvlm_0_5b, f32 master weights, the tower frozen, dpo.train_dpo")
    counts["dpo"] = phase_dpo(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[10b/12] GRPO: radvlm_0_5b, rollouts through ContinuousBatcher, grpo.train_grpo")
    counts["grpo"] = phase_grpo(dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    header("[11/12] the decoder families: MoE, MPT and the LLaVA presets, weights born int8")
    counts.update(phase_families(dev, args.seed, header))

    header("[12/12] M10's towers and resamplers, weights born int8; a tunable CLIP tower")
    counts.update(phase_towers(dev, args.seed, header))
    gc.collect()
    torch.cuda.empty_cache()

    header("[13/14] M12's serving layouts on the card: TP engine, SP generation, a fleet")
    t13 = time.perf_counter()
    counts.update(phase_layouts(dev, args.seed, header))
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s; {nvidia_smi_line()}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    header("[14/14] M12's training half: ZeRO-3, TP = 2, pipelines, LoRA under TP and the "
           "zigzag ring, radvlm_0_5b")
    counts.update(phase_train_mesh(dev, args.seed, header))

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
