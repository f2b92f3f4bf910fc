#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`radvlm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one Hopper card (sm_90a) and nvcc

Phases, each raising on failure (the last line is printed only on success):

1. device: a CUDA card; its name and power limit as nvidia-smi reports them;
2. build: the hand-written kernels from `radvlm_tpu_torch/csrc` (one nvcc
   per source, in parallel), timed;
3. kernels: K1 (tower attention), K2 (prefill attention), K9 (decode
   attention), K3 (W8A8 matmul), K4 (int8-cache decode attention) and K5/K6
   (int8-weight decode matmul) against their plain PyTorch versions on the
   card at the main paths' shapes: error (K3 bit for bit) and both times
   (CUDA events, median of several runs);
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
   is timed and one is profiled.

Ends with a JSON line of per-kernel results and then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import gc
import io
import itertools
import json
import os
import statistics
import subprocess
import time
import urllib.request

import numpy as np
import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.config import radvlm_7b
from radvlm_tpu_torch.eval.harness import VLMRunner, batch_to_device
from radvlm_tpu_torch.generation import engine
from radvlm_tpu_torch.models import convert, multimodal, radvlm
from radvlm_tpu_torch.ops import decode_attention as da
from radvlm_tpu_torch.ops import flash_attention as fa
from radvlm_tpu_torch.ops import int8_matmul as i8
from radvlm_tpu_torch.ops import kv_quant
from radvlm_tpu_torch.ops import w8a8_matmul as w8
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from radvlm_tpu_torch.serve.worker import ModelWorker

REQUESTS = 3
NEW_TOKENS = 32
INT8_REQUESTS = 12  # concurrent, in the int8 continuous phase
INT8_BUCKETS = (3072, 3456, 3840, 4096)
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
}
# The kernels each path must launch in its measured run.
PATH_KERNELS = {
    "bf16": ("tower_attention", "prefill_attention", "decode_attention"),
    "int8": ("tower_attention", "prefill_attention", "w8a8_matmul", "decode_attention_q8",
             "int8_matmul"),
}


class ByteTokenizer:
    """Bytes map to ids 2..257; any other id decodes as "<id>", so equal
    text means equal tokens. No tokenizer files are needed."""

    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        out, buf = [], bytearray()
        for i in ids:
            if 2 <= i < 258:
                buf.append(i - 2)
            else:
                out.append(buf.decode(errors="replace") + f"<{i}>")
                buf = bytearray()
        return "".join(out) + buf.decode(errors="replace")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of fn() in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
        ms=cuda_ms(lambda: fa.tower_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, None, None, False, scale)),
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
    results["prefill_attention"] = dict(max_abs_err=err, ms=cuda_ms(run), plain_ms=cuda_ms(plain))
    del q, k, v, ref, out
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
    results["decode_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: run(next(layers))),
        plain_ms=cuda_ms(lambda: plain(next(layers))),
    )
    del ck, cv
    results.update(phase_int8_kernels(dev, g))
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return results


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
        ms = cuda_ms(run)
        print(f"    K3 {label}: {ms:.4f} ms, {2 * m * k * n / ms / 1e9:.1f} TOP/s", flush=True)
        if label == "text gateup":
            results["w8a8_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=cuda_ms(plain, reps=5))
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
    results["decode_attention_q8"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: run_q8(next(layers))),
        plain_ms=cuda_ms(lambda: plain_q8(next(layers))))
    print(f"    K4: {ck[0].numel() * 2 / results['decode_attention_q8']['ms'] / 1e6:.1f} GB/s "
          "of int8 K/V per layer", flush=True)
    del ck, cv, ks, vs
    # K5/K6: the decode projections of a fused Qwen2-7B layer and the lm_head
    # at 8 and 32 rows (decode slots). Three copies of each weight, used in
    # turn, so that a small one does not stay in the 50 MB L2.
    step_ms = {}
    for label, k, n in [("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 37888),
                        ("down", 18944, 3584), ("lm_head", 3584, 152064)]:
        ws = [randint8(n, k) for _ in range(3)]
        sc = torch.full((n,), 0.02 / 127, device=dev)
        for rows in (8, 32):
            x = randn(rows, k)
            out = i8.int8_matmul(x, ws[0], sc)
            torch.cuda.synchronize()
            err = check_close("int8_matmul", f"K5/K6 int8_matmul {label} [{rows},{k}]x[{k},{n}]",
                              out, i8.int8_matmul_plain(x, ws[0], sc))
            turn = itertools.cycle(ws)
            ms = cuda_ms(lambda: i8.int8_matmul(x, next(turn), sc))
            step_ms[(label, rows)] = ms
            print(f"    K5/K6 {label} {rows} rows: {ms:.4f} ms, {n * k / ms / 1e6:.1f} GB/s",
                  flush=True)
            if (label, rows) == ("gateup", 8):
                results["int8_matmul"] = dict(
                    max_abs_err=err, ms=ms,
                    plain_ms=cuda_ms(lambda: i8.int8_matmul_plain(x, next(turn), sc)))
        del ws
    for rows in (8, 32):
        per_step = 28 * sum(step_ms[(p, rows)] for p in ("qkv", "o", "gateup", "down"))
        per_step += step_ms[("lm_head", rows)]
        print(f"    K5/K6 per decode step, {rows} rows (28 layers + lm_head): {per_step:.3f} ms",
              flush=True)
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
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=ByteTokenizer(),
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
    busy = sum(e.self_device_time_total for e in events) / 1e6
    profiled = "" if profiled_wall is None else f", profiled wall {profiled_wall:.4f} s"
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
    tok = ByteTokenizer()
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
    engine_chunks(b, cfg, tok, reqs[0], images[0])
    return counts


@torch.inference_mode()
def engine_chunks(b, cfg, tok, req, image) -> None:
    """Every slot filled (the engine thread is stopped), then three greedy
    decode chunks: one under torch.cuda.set_sync_debug_mode("error"), which
    raises on any host sync inside it; one timed by the host's clock; one
    under torch.profiler (device time by kernel, busy share)."""
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
    print(f"  a greedy {b.steps_per_sync}-step chunk of {b.num_slots} slots ran under "
          "set_sync_debug_mode('error'): no host sync", flush=True)

    def chunk():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b._dispatch_chunk(inflight, force_sampling=False)
        b._process_chunk(inflight, [])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = chunk()
    print(f"  decode chunk: {wall:.4f} s for {b.steps_per_sync} steps of {b.num_slots} slots "
          f"({1e3 * wall / b.steps_per_sync:.2f} ms/step, "
          f"{b.num_slots * b.steps_per_sync / wall:.1f} tokens/s)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
    device_breakdown(prof, wall, f"int8 decode chunk ({b.steps_per_sync} steps)")


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
    print(f"[1/5] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"[2/5] build: {time.perf_counter() - t0:.2f} s ({kernels.BUILD_DIR})", flush=True)

    print("[3/5] kernels against their plain versions", flush=True)
    results = phase_kernels(dev, 1234 + args.seed)

    print("[4/5] bf16 slice: radvlm_7b, random bf16 weights", flush=True)
    counts = {"bf16": phase_slice(dev, args.seed)}
    gc.collect()  # the bf16 model (15 GiB) goes before the int8 one comes
    torch.cuda.empty_cache()

    print("[5/5] int8 continuous path: radvlm_7b, weights born int8, BatchWorker", flush=True)
    counts["int8"] = phase_int8(dev, args.seed)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[path][name], **results[name]}
        for name, (src, replaces, path) in KERNELS.items()
    ]}
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
