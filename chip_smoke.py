#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`radvlm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one Hopper card (sm_90a) and nvcc

Phases, each raising on failure (the last line is printed only on success):

1. device: a CUDA card; its name and power limit as nvidia-smi reports them;
2. build: the hand-written kernels from `radvlm_tpu_torch/csrc`, timed;
3. kernels: K1 (tower attention), K2 (prefill attention) and K9 (decode
   attention) against their plain PyTorch versions on the card, in bf16, at
   the main path's shapes: max error on non-padding rows and both times
   (CUDA events, median of several runs);
4. slice: radvlm_7b at full width with random bf16 weights made on the card
   from --seed. A reference check first (on one small input, the kernel
   path and plain attention in bf16 against plain attention on an f32 copy
   of the weights), then the measured run with the launch counts reset:
   the port's ModelWorker serves 3 chatml requests with one synthetic
   CXR-sized image each over localhost HTTP (greedy, 32 new tokens) plus a
   repeat of the first, and VLMRunner.generate_batch runs one left-padded
   batch of 2. Every kernel must have launched in that run. Then prefill
   alone is timed, and one prefill and the 32 decode steps of a batch of 2
   are timed unprofiled and then under torch.profiler, which breaks the
   device time down by kernel.

Ends with a JSON line of per-kernel results and then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
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
from radvlm_tpu_torch.serve.worker import ModelWorker

REQUESTS = 3
NEW_TOKENS = 32

KERNELS = {
    "tower_attention": ("radvlm_tpu_torch/csrc/flash_attention.cu",
                        "radvlm_tpu/ops/flash_attention.py:525"),
    "prefill_attention": ("radvlm_tpu_torch/csrc/flash_attention.cu",
                          "radvlm_tpu/ops/flash_attention.py:71"),
    "decode_attention": ("radvlm_tpu_torch/csrc/decode_attention.cu",
                         "radvlm_tpu/ops/decode_attention.py:37"),
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
    """Per row |out - plain| <= 2^-7 max_row|plain| + ATOL (`kernels.error_ratio`)."""
    err, ratio = kernels.error_ratio(name, out, ref, rows)
    print(f"  {label}: max_abs_err {err:.3e}; per row |err| <= 2^-7 max_row|plain| + "
          f"{kernels.ATOL[name]:.0e}, worst element at {ratio:.3f} of its bound", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def phase_kernels(dev, seed: int):
    """K1, K2, K9 at the main path's shapes against their plain versions."""
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
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
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
    questions = ["Write the findings section of the report.", "Is there a pleural effusion?",
                 "Describe the cardiac silhouette.", "Is there a pneumothorax?"]
    reqs = [{"prompt": prompt(runner, questions[i % len(questions)]), "images": [png_b64(im)],
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
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

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


def profile_stages(model, cfg, batch, new_tokens: int, top: int = 12):
    """One prefill and `new_tokens` decode steps of the batch, timed by the
    host's clock unprofiled and then again under torch.profiler: device
    time by kernel, and the device-busy share of the unprofiled wall time
    (the profiler's own overhead inflates its wall time)."""
    from torch.autograd import DeviceType
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
        # Device-side events only (kernels, copies); the aten ops that
        # launched them would count the same time twice.
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e6
        print(f"  profile {stage}: unprofiled wall {walls[stage]:.4f} s, profiled wall "
              f"{wall:.4f} s, device busy {busy:.4f} s ({100 * busy / walls[stage]:.1f}% of "
              f"the unprofiled wall)", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
            print(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:90]}",
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    print(f"[1/4] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.lib()
    print(f"[2/4] build: {time.perf_counter() - t0:.2f} s ({kernels.BUILD_DIR})", flush=True)

    print("[3/4] kernels against their plain versions (bf16)", flush=True)
    results = phase_kernels(dev, 1234 + args.seed)

    print("[4/4] slice: radvlm_7b, random bf16 weights", flush=True)
    counts = phase_slice(dev, args.seed)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **results[name]}
        for name, (src, replaces) in KERNELS.items()
    ]}
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
