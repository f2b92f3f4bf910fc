"""Time the port's kernels on the card at the shapes the main paths give
them, optionally against other versions of their sources in turns:

- `--only fwd`: the attention forwards (K1, K2, K2 with the lse) against
  SDPA, at Qwen2-7B's and the towers' shapes and at Gemma-2B's (D = 256);
- `--only bwd`: the backward (K7 dk / dv, K8 dq) against SDPA's backward,
  at the 0.5B's, the 7B's and the tower's training shapes and at Gemma-2B's
  (D = 256; no baseline there);
- `--only decode`: K9 (bf16 decode attention) and K10 (its window) at W = 5
  and W = 16 against SDPA, then K4 (decode attention over the int8 cache;
  beside it K9 on a bf16 copy of the same cache) and K11 (its window) at W
  = 5 and 16 (no library call), at Qwen2-7B's heads and then at Gemma-2B's
  (8 query heads over one kv head of 256, 18 layers; no baseline there);
- `--only w8a8`: K3 (W8A8 matmul) alone against `torch._int_mm` + the scale
  products and `torch._int_mm` alone (the cuBLAS floor for the same
  products), then K13 (fused W8A8 matmul) beside `quantize_rows` + K3 and
  `quantize_rows` + `torch._int_mm` + the scale products;
- `--only int8mm`: K5/K6 (the weight-only int8 decode matmul) at the five
  decode shapes of Qwen2-7B (a fused layer's qkv, o, gateup, down and the
  lm_head) at 8 rows (a decode step of 8 slots) and 40 (a verify step of 8
  slots x 5) against `torch._weight_int8pack_mm`, each shape also under
  the other K splits the kernel takes, and the sums of a decode step (28
  layers + the lm_head) against their bound;
- `--only int4`: K12 (the W4A16 decode matmul) at the four int4 decode
  shapes of Qwen2-7B (qkv, o, gateup, down; the lm_head stays int8) at 8
  and 40 rows, enough weight copies in turn that none stays in L2, each
  shape also under the other K splits the kernel takes, the sums of a
  decode step (28 layers), and K5/K6 at gateup with 8 rows beside it (no
  PyTorch call computes K12's function: the byte bound is its yardstick);
- no `--only`: all six.

    python -m radvlm_tpu_torch.bench_kernels [--only fwd|bwd|decode|w8a8|int8mm|int4]
        [--baseline DIR] [--ptxas] [--reps N] [--batch N]

- Each shape is first held to the plain version (`kernels.error_ratio`; K3
  bit for bit against its plain version, K13 against `quantize_rows` + K3).
- Times are medians of `--reps` samples, each sample CUDA events around
  `--batch` calls in a row (the host's launches run ahead of the card, so
  this is device time); the forward kernels and SDPA are also timed one call
  a sample, their wrappers' host time included, and the backward, decode
  and W8A8 sets also by torch.profiler device time (`device_ms`).
- The decode kernels cycle through the layers of a stacked cache (28, or
  Gemma-2B's 18), so that one layer's K / V does not stay in the 50 MB L2
  between calls.
- `--baseline DIR` (repeatable): DIR holds other versions of the sources
  (`flash_attention.cu`, `flash_attention_bwd.cu`, `decode_attention.cu`
  and `decode_attention_q8.cu` (an older tree has the one file),
  `w8a8_matmul.cu`, `int8_matmul.cu`, `int4_matmul.cu`, and the headers they include), e.g. the parent
  commit's `radvlm_tpu_torch/csrc/` unpacked by `git archive` into the
  gitignored `build/`. The sources the `--only` set needs are built into a
  library of their own (same C entry points, loaded apart), held to the
  same rule (reported, not asserted) and timed against this checkout's
  kernels in the order this, each baseline, this. One that does not build
  is reported and left out. K5/K6 baselines run under their own split
  plan: an earlier kernel that sums its K splits through f32 partials in
  device memory takes a `part` buffer and its plan of ~2 CTAs an SM over
  128-column blocks (`partials_plan`); one that refuses a buffer, this
  checkout's plan; K12 baselines likewise.
- `--ptxas`: compile this checkout's sources of the set (and each
  baseline's) with `-Xptxas -v` and print registers, shared memory, spills
  and ptxas's warnings per instantiation.

Prints one line per shape and kernel: the kernel's median ms, the library
call's, the bound (the larger of the bytes over 3.35 TB/s and the
operations over the tensor cores' peak: the pairs the masks leave x 4 x D
flops over 989 TFLOP/s for attention, 2 M K N over 1979 TOP/s for W8A8;
the decode windows also print their f32 FMA floor, the same pairs x 4 x D
over 67 TFLOP/s, which their FMA dot products cannot beat),
the kernel's share of the bound and its ratio to the library call. Needs a
Hopper card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import statistics
import subprocess

import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as da
from radvlm_tpu_torch.ops import flash_attention as fa
from radvlm_tpu_torch.ops import kv_quant
from radvlm_tpu_torch.ops import w8a8_matmul as w8

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12  # FMA outside the tensor cores

# (label, entry, B, S, H, Hkv, D, causal, segment layout)
SHAPES = [
    ("K1 tower [10,729,16,72]", "tower", 10, 729, 16, 16, 72, False, None),
    ("K2 7B prefill [2,4096,28|4,128]", "prefill", 2, 4096, 28, 4, 128, True, "left_pad2"),
    ("K2-lse 0.5B [1,4096,14|2,64]", "lse", 1, 4096, 14, 2, 64, True, "packed"),
    ("K2-lse 7B [1,4096,28|4,128]", "lse", 1, 4096, 28, 4, 128, True, "left_pad"),
    ("K2-lse tower [5,729,16,72]", "lse", 5, 729, 16, 16, 72, False, None),
    # Gemma-2B (the D = 256 instance): one left-padded prompt of the 4096 bucket.
    ("K2 Gemma-2B prefill [1,4096,8|1,256]", "prefill", 1, 4096, 8, 1, 256, True, "left_pad"),
    ("K2-lse Gemma-2B [1,4096,8|1,256]", "lse", 1, 4096, 8, 1, 256, True, "left_pad"),
]
# The backward's shapes: (label, B, S, H, Hkv, D, causal, segment layout).
BWD_SHAPES = [
    ("0.5B decoder [1,4096,14|2,64]", 1, 4096, 14, 2, 64, True, "packed"),
    ("7B decoder [1,4096,28|4,128]", 1, 4096, 28, 4, 128, True, "left_pad"),
    ("tower [5,729,16,72]", 5, 729, 16, 16, 72, False, None),
    # Gemma-2B (the D = 256 instances): its packed 4096-token training rows.
    ("Gemma-2B [1,4096,8|1,256]", 1, 4096, 8, 1, 256, True, "packed"),
]
# The sources each --only set times.
SET_SOURCES = {"fwd": ("flash_attention.cu",), "bwd": ("flash_attention_bwd.cu",),
               "decode": ("decode_attention.cu", "decode_attention_q8.cu"),
               "w8a8": ("w8a8_matmul.cu",),
               "int8mm": ("int8_matmul.cu",), "int4": ("int4_matmul.cu",)}
SOURCES = tuple(src for srcs in SET_SOURCES.values() for src in srcs)
# K9 at phase 3's shape: 4 rows of a 4096-slot cache, Qwen2-7B heads; each
# row's written span (left padding before it, the unwritten tail after).
DECODE_SPANS = [(300, 3600), (0, 3950), (1200, 4000), (40, 2100)]
# K10 / K11 at W = 5 (spec_k = 4) and 16: 8 slots of a 4224-slot cache, each
# window's first cache index (slot 1's ends at the last) and the start of its
# row's written span; slot 7 empty.
WINDOW_IDX = [3500, 4224, 4000, 3100, 3890, 3200, 1000, 2000]
WINDOW_LO = [300, 0, 1000, 40, 700, 0, 123]
# K13 at phase 3's shapes: (label, M, K, N).
W8A8_SHAPES = [("text gateup", 3456, 3584, 37888), ("text down", 3456, 18944, 3584),
               ("tower fc1", 3645, 1152, 4304)]
# K5/K6 at the decode projections of a fused Qwen2-7B layer and the lm_head:
# (label, K, N); a decode step runs the first four 28 times.
INT8MM_SHAPES = [("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 37888),
                 ("down", 18944, 3584), ("lm_head", 3584, 152064)]
INT8MM_ROWS = (8, 40)
N_LAYERS = 28
# The decode set's heads: (query heads, kv heads, head dim, layers) of
# Qwen2-7B, then of Gemma-2B (the D = 256 instances).
QWEN2_7B_HEADS = (28, 4, 128, N_LAYERS)
GEMMA_2B_HEADS = (8, 1, 256, 18)
# K12 at the decode projections of a fused Qwen2-7B layer (the lm_head stays
# int8 in an int4 model): (label, K, N).
INT4_SHAPES = INT8MM_SHAPES[:4]
INT4_GATEUP_N = 37888


def segments(layout, b, s, dev):
    if layout is None:
        return None
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    if layout == "packed":  # an image sample, a text sample, right padding
        seg[:, 3300:] = 2
        seg[:, 3900:] = 0
    elif layout == "left_pad2":  # chip_smoke.py's bf16 prefill batch
        seg[0, :517] = 0
        seg[1, :90] = 0
    else:
        seg[:, :517] = 0
    return seg


def median_ms(fn, reps: int, batch: int = 1, warmup: int = 3) -> float:
    """Median over `reps` samples of the time of one call, each sample taken
    by CUDA events around `batch` calls in a row. With batch = 1 a sample
    includes the wrapper's host time before the launch; with more, the
    host's launches run ahead of the card and the sample is device time."""
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


def device_ms(fn, reps: int, by_kernel: bool = False):
    """The summed duration of the kernels one fn() launches, by
    torch.profiler over `reps` calls: the card's time without the host's,
    which a sample of calls in a row still holds where the host issues
    slower than the card runs (autograd.grad's backward). 0 where the
    profiler traces no device. With `by_kernel`, also {kernel name: ms a
    call}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    each = {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    total = sum(each.values())
    return (total, each) if by_kernel else total


def by_kernel_text(each: dict) -> str:
    return ", ".join(f"{name.split('(')[0].split('<')[0].split(' ')[-1]} {ms:.4f}"
                     for name, ms in sorted(each.items(), key=lambda kv: -kv[1]))


def nvcc_cmd(src_dir: str, out: str, *flags: str, sources=SOURCES):
    srcs = [os.path.join(src_dir, f) for f in sources
            if os.path.exists(os.path.join(src_dir, f))]
    return [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            *flags, "-I", src_dir, *srcs, "-o", out]


def load_baseline(lib_path: str) -> ctypes.CDLL:
    """Another version's sources, built as a library of their own; entry
    points it lacks stay unset (`has`)."""
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "radvlm_tower_attention": [p, p, p, p, i, i, i, i, f, p],
        "radvlm_prefill_attention": [p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_prefill_attention_lse": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_flash_attention_bwd_dkv": [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_flash_attention_bwd_dq": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_decode_attention": [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_decode_attention_window": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p],
        "radvlm_decode_attention_window_q8": [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p],
        "radvlm_w8a8_matmul": [p, p, p, p, p, i, i, i, p],
        "radvlm_int8_matmul": [p, p, p, p, p, i, i, i, i, i, p],
        "radvlm_int4_matmul": [p, p, p, p, p, i, i, i, i, i, p],
        "radvlm_decode_attention_q8": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p],
        "radvlm_w8a8_matmul_fused": [p, p, p, p, p, i, i, i, p],
    }
    for name, argtypes in sigs.items():
        if has(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def has(lib, name: str) -> bool:
    try:
        getattr(lib, name)
    except AttributeError:
        return False
    return True


def call_lib(lib, entry, q, k, v, seg, causal, o, lse):
    """One launch of `lib`'s entry point into preallocated o / lse."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    stream = kernels.stream_ptr(q.device)
    sp = None if seg is None else seg.data_ptr()
    if entry == "tower":
        err = lib.radvlm_tower_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         b, s, h, d, d ** -0.5, stream)
    elif entry == "prefill":
        err = lib.radvlm_prefill_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), sp, sp,
                                           o.data_ptr(), b, s, s, h, hkv, d, int(causal),
                                           d ** -0.5, stream)
    else:
        err = lib.radvlm_prefill_attention_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), sp, sp,
                                               o.data_ptr(), lse.data_ptr(), b, s, s, h, hkv, d,
                                               int(causal), d ** -0.5, stream)
    kernels.check(err, entry)


def call_bwd(lib, which, q, k, v, do, lse, delta, seg, causal, out):
    """One launch of `lib`'s K7 (which = "dkv", out = (dk, dv)) or K8 ("dq",
    out = (dq,)) into preallocated outputs."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    sp = None if seg is None else seg.data_ptr()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sp, sp, do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in out))
    fn = lib.radvlm_flash_attention_bwd_dkv if which == "dkv" else lib.radvlm_flash_attention_bwd_dq
    err = fn(*ptrs, b, s, s, h, hkv, d, int(causal), d ** -0.5, kernels.stream_ptr(q.device))
    kernels.check(err, which)


def ptxas_report(src: str, stderr: str) -> None:
    print(f"  ptxas, {src}:", flush=True)
    for line in stderr.splitlines():
        if "Function properties" in line or "bytes gmem" in line or "cmem" in line:
            continue
        print("   ", line.strip()[:240], flush=True)


def attention_mask(seg, causal, b, s, dev):
    if seg is None and not causal:
        return None
    ids = seg if seg is not None else torch.ones((b, s), dtype=torch.int32, device=dev)
    return tatt.make_attention_mask(ids, ids, causal)


def in_turns(run, bases, args, measure=None):
    """This checkout's kernel, each baseline's ((library, name) pairs), this
    one again: the median of this one's two times, and text with each
    baseline's time. `measure(fn)` times one fn (default: CUDA events
    around samples of --batch calls)."""
    if measure is None:
        measure = lambda fn: median_ms(fn, args.reps, args.batch)  # noqa: E731
    a1 = measure(run)
    times = [measure(lambda base=base: run(base)) for base, _ in bases]
    a2 = measure(run) if bases else a1
    extra = "".join(f"; {name}: {t:.4f} ms ({t / statistics.median([a1, a2]):.2f}x)"
                    for (_, name), t in zip(bases, times))
    if bases:
        extra += f"; this {a1:.4f} / {a2:.4f} ms before / after them"
    return statistics.median([a1, a2]), extra


def forward(args, this, bases, dev, g) -> None:
    all_bases = bases
    for label, entry, b, s, h, hkv, d, causal, layout in SHAPES:
        bases = all_bases if d <= 128 else []  # older sources refuse D = 256
        q = torch.randn(b, s, h, d, generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=torch.bfloat16)
        seg = segments(layout, b, s, dev)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), device=dev, dtype=torch.float32)
        name = {"tower": "tower_attention", "prefill": "prefill_attention",
                "lse": "prefill_attention_lse"}[entry]
        rows = None if seg is None else seg.bool()
        call_lib(this, entry, q, k, v, seg, causal, o, lse)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v, seg, seg, causal, d ** -0.5)
        err, ratio = kernels.error_ratio(name, o, ref, rows)
        mask = attention_mask(seg, causal, b, s, dev)
        pairs = b * s * s if mask is None else int(mask.sum())
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
        if entry == "lse":
            n_bytes += lse.numel() * 4
        if seg is not None:
            n_bytes += 2 * seg.numel() * 4
        bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 4 * h * d * pairs / PEAK_BF16)
        run = lambda lib=this: call_lib(lib, entry, q, k, v, seg, causal, o, lse)  # noqa: E731
        for base, bname in bases:
            run(base)  # held to the same rule, reported, not asserted
            torch.cuda.synchronize()
            print(f"    {bname}: {base_rule(name, o, ref, rows)}", flush=True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=h != hkv)
        sdpa_ms = median_ms(sdpa, args.reps, args.batch)
        sdpa_call_ms, call_ms = median_ms(sdpa, args.reps), median_ms(run, args.reps)
        ms, extra = in_turns(run, bases, args)
        print(f"  {label}: kernel {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x SDPA), "
              f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of it); worst element at "
              f"{ratio:.3f} of its bound (max_abs_err {err:.3e}); one call at a time (host "
              f"time included): kernel {call_ms:.4f} ms, SDPA {sdpa_call_ms:.4f} ms{extra}",
              flush=True)
        del q, k, v, o, lse, ref, mask
        torch.cuda.empty_cache()


def base_rule(name, out, ref, rows=None) -> str:
    try:
        return f"worst element at {kernels.error_ratio(name, out, ref, rows)[1]:.3f} of its bound"
    except AssertionError:
        return "non-finite output"


def backward(args, this, bases, dev, g) -> None:
    """K7, K8 and K7 + K8 + delta against SDPA's backward."""
    all_bases = bases
    for label, b, s, h, hkv, d, causal, layout in BWD_SHAPES:
        bases = all_bases if d <= 128 else []  # older sources refuse D = 256
        q, do = (torch.randn(b, s, h, d, generator=g, device=dev, dtype=torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        seg = segments(layout, b, s, dev)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal)
        o, lse = fa.prefill_attention_lse(q, k, v, **kw)
        delta = fa.attention_delta(o, do, None)
        dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
        rq, rk, rv = fa.attention_backward_plain(q, k, v, seg, seg, o, lse, do, None, causal,
                                                 d ** -0.5)
        mask = attention_mask(seg, causal, b, s, dev)
        pairs = b * s * s if mask is None else int(mask.sum())
        common = sum(t.numel() * t.element_size() for t in (q, k, v, do, lse, delta))
        common += 0 if seg is None else 2 * seg.numel() * 4

        def dkv(lib=this):
            call_bwd(lib, "dkv", q, k, v, do, lse, delta, seg, causal, (dk, dv))

        def dqk(lib=this):
            call_bwd(lib, "dq", q, k, v, do, lse, delta, seg, causal, (dq,))

        def rule():
            return "; ".join(f"{n} {base_rule(kn, x, r)}" for n, kn, x, r in (
                ("dk", "flash_attention_bwd_dkv", dk, rk),
                ("dv", "flash_attention_bwd_dkv", dv, rv),
                ("dq", "flash_attention_bwd_dq", dq, rq)))

        dkv(), dqk()
        torch.cuda.synchronize()
        print(f"  {label}: {rule()}", flush=True)
        for base, bname in bases:  # held to the same rule, reported, not asserted
            dkv(base), dqk(base)
            torch.cuda.synchronize()
            print(f"    {bname}: {rule()}", flush=True)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2), attn_mask=mask,
            enable_gqa=h != hkv).transpose(1, 2)
        def sdpa_grad():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        def backward_pass():
            fa.attention_delta(o, do, None)
            dkv()
            dqk()

        sdpa_ms = median_ms(sdpa_grad, args.reps, args.batch)
        pair_ms = median_ms(backward_pass, args.reps, args.batch)
        k7, k7_extra = in_turns(dkv, bases, args)
        k8, k8_extra = in_turns(dqk, bases, args)
        for name, ms, ops, out, extra in (("K7", k7, 8, (dk, dv), k7_extra),
                                         ("K8", k8, 6, (dq,), k8_extra)):
            n_bytes = common + sum(t.numel() * t.element_size() for t in out)
            bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * ops * h * d * pairs / PEAK_BF16)
            print(f"    {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% "
                  f"of it){extra}", flush=True)
        print(f"    K7 + K8 + attention_delta {pair_ms:.4f} ms (K7 + K8 alone {k7 + k8:.4f}), "
              f"SDPA backward {sdpa_ms:.4f} ms: {pair_ms / sdpa_ms:.2f}x", flush=True)
        pair_dev = device_ms(backward_pass, args.reps)
        sdpa_dev = device_ms(sdpa_grad, args.reps)
        print(f"    device time by torch.profiler: K7 + K8 + attention_delta {pair_dev:.4f} ms, "
              f"SDPA backward {sdpa_dev:.4f} ms: "
              f"{pair_dev / sdpa_dev if sdpa_dev else float('nan'):.2f}x", flush=True)
        del q, k, v, do, o, lse, delta, dk, dv, dq, rq, rk, rv, mask, lib_out, ql, kl, vl
        torch.cuda.empty_cache()


def decode(args, this, bases, dev, g, heads=QWEN2_7B_HEADS) -> None:
    """K9 at phase 3's shape and K10 at W = 5 and 16 against SDPA, K4 and
    K11 at W = 5 and 16 (no library call), layers cycled; each with its
    share of the byte bound and of the f32 FMA floor. `heads`: (query heads,
    kv heads, head dim, layers) of the model whose shapes these are."""
    h, hkv, d, n_layers = heads
    last, scale, row = n_layers - 1, d ** -0.5, f"{hkv * d}"

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)

    # K9: [4, h, d] over [4, 4096, hkv * d].
    b, s = 4, 4096
    ck, cv = randn(n_layers, b, s, hkv * d), randn(n_layers, b, s, hkv * d)
    q = randn(b, h, d)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, (lo, hi) in enumerate(DECODE_SPANS):
        seg[i, lo:hi] = 1
    nsplit, chunk = da._split_plan(b, hkv, s, kernels.sm_count(dev))
    part_o = torch.empty((b, h, nsplit, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)

    def k9(layer, lib=this):
        err = lib.radvlm_decode_attention(
            q.data_ptr(), ck[layer].data_ptr(), cv[layer].data_ptr(), seg.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b, s, h, hkv, d, nsplit,
            chunk, scale, kernels.stream_ptr(dev))
        kernels.check(err, "decode_attention")

    mask = (seg != 0)[:, None, None, :]

    def sdpa(layer):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck[layer].view(b, s, hkv, d).transpose(1, 2),
            cv[layer].view(b, s, hkv, d).transpose(1, 2), attn_mask=mask, enable_gqa=True)

    visible = int((seg != 0).sum())
    n_bytes = 2 * visible * hkv * d * 2 + 2 * q.numel() * 2 + seg.numel() * 4
    bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 4 * h * d * visible / PEAK_BF16)
    ref = da.decode_attention_plain(q, ck[last], cv[last], seg, num_kv_heads=hkv, scale=scale)
    timed(f"K9 decode [4,{h},{d}] x [4,4096,{row}]", "decode_attention", k9, sdpa, ref, out,
          bound_ms, n_layers, args, this, bases, 1e3 * 4 * h * d * visible / PEAK_FP32)
    del ck, cv, part_o, part_ml

    # K4: [8, h, d] over [8, 4224, hkv * d] int8, each slot's written span
    # from WINDOW_LO to its window index, slot 7 empty; then K10 at W = 5 and
    # 16 and K11 at W = 5 and 16: [8, W, h, d] over the same caches.
    b, s = 8, 4224
    ck, cv = randn(n_layers, b, s, hkv * d), randn(n_layers, b, s, hkv * d)
    ckq, cvq = (kv_quant.quantize_kv(c, hkv) for c in (ck, cv))
    nsplit, chunk = da._split_plan(b, hkv, s, kernels.sm_count(dev))
    q = randn(b, h, d)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i, lo in enumerate(WINDOW_LO):
        seg[i, lo:min(WINDOW_IDX[i], s - 1) + 1] = 1
    part_o = torch.empty((b, h, nsplit, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)

    def k4(layer, lib=this):
        (kq, ks), (vq, vs) = ckq, cvq
        err = lib.radvlm_decode_attention_q8(
            q.data_ptr(), kq[layer].data_ptr(), vq[layer].data_ptr(), ks[layer].data_ptr(),
            vs[layer].data_ptr(), seg.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), b, s, h, hkv, d, nsplit, chunk, scale, kernels.stream_ptr(dev))
        kernels.check(err, "decode_attention_q8")

    visible = int((seg != 0).sum())
    n_bytes = visible * (2 * hkv * d + 2 * hkv * 4) + 2 * q.numel() * 2 + seg.numel() * 4
    bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 4 * h * d * visible / PEAK_BF16)
    (kq, ks), (vq, vs) = ckq, cvq
    ref = da.decode_attention_q8_plain(q, kq[last], vq[last], ks[last], vs[last], seg,
                                       num_kv_heads=hkv, scale=scale)
    timed(f"K4 decode [8,{h},{d}] x [8,4224,{row}] int8", "decode_attention_q8", k4, None, ref,
          out, bound_ms, n_layers, args, this,
          [(base, n) for base, n in bases if has(base, "radvlm_decode_attention_q8")],
          1e3 * 4 * h * d * visible / PEAK_FP32)

    def k9_same(layer, lib=this):  # K9 on the bf16 copy of K4's cache
        err = lib.radvlm_decode_attention(
            q.data_ptr(), ck[layer].data_ptr(), cv[layer].data_ptr(), seg.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b, s, h, hkv, d, nsplit,
            chunk, scale, kernels.stream_ptr(dev))
        kernels.check(err, "decode_attention")

    n_bytes = visible * 2 * hkv * d * 2 + 2 * q.numel() * 2 + seg.numel() * 4
    timed(f"K9 decode at K4's shape [8,{h},{d}] x [8,4224,{row}] bf16", "decode_attention",
          k9_same, None,
          da.decode_attention_plain(q, ck[last], cv[last], seg, num_kv_heads=hkv, scale=scale),
          out, 1e3 * n_bytes / HBM_BYTES_PER_S, n_layers, args, this, bases,
          1e3 * 4 * h * d * visible / PEAK_FP32)
    del q, part_o, part_ml, out, ref
    ar = torch.arange(s, device=dev)[None]
    for w, quantized in ((5, False), (16, False), (5, True), (16, True)):
        q = randn(b, w, h, d)
        widx = torch.tensor([min(i, s - w) for i in WINDOW_IDX], dtype=torch.int32, device=dev)
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for i, lo in enumerate(WINDOW_LO):
            seg[i, lo:int(widx[i]) + w] = 1
        part_o = torch.empty((b, w, h, nsplit, d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((b, w, h, nsplit, 2), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)

        def window(layer, lib=this):
            ptrs = (q.data_ptr(), ck[layer].data_ptr(), cv[layer].data_ptr())
            rest = (seg.data_ptr(), widx.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
                    out.data_ptr(), b, s, h, hkv, d, w, nsplit, chunk, scale,
                    kernels.stream_ptr(dev))
            err = lib.radvlm_decode_attention_window(*ptrs, *rest)
            kernels.check(err, "decode_attention_window")

        def window_q8(layer, lib=this):
            (kq, ks), (vq, vs) = ckq, cvq
            err = lib.radvlm_decode_attention_window_q8(
                q.data_ptr(), kq[layer].data_ptr(), vq[layer].data_ptr(), ks[layer].data_ptr(),
                vs[layer].data_ptr(), seg.data_ptr(), widx.data_ptr(), part_o.data_ptr(),
                part_ml.data_ptr(), out.data_ptr(), b, s, h, hkv, d, w, nsplit, chunk, scale,
                kernels.stream_ptr(dev))
            kernels.check(err, "decode_attention_window_q8")

        wmask = ((seg != 0)[:, None, :]
                 & (ar[:, None, :] <= (widx[:, None] + torch.arange(w, device=dev))[:, :, None])
                 )[:, None]

        def sdpa_window(layer):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), ck[layer].view(b, s, hkv, d).transpose(1, 2),
                cv[layer].view(b, s, hkv, d).transpose(1, 2), attn_mask=wmask, enable_gqa=True)

        any_row = int(((seg != 0) & (ar <= widx[:, None] + w - 1)).sum())
        pairs = sum(int(((seg != 0) & (ar <= widx[:, None] + j)).sum()) for j in range(w))
        per_key = 2 * hkv * d + 2 * hkv * 4 if quantized else 2 * hkv * d * 2
        n_bytes = any_row * per_key + 2 * q.numel() * 2 + seg.numel() * 4 + widx.numel() * 4
        bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 4 * h * d * pairs / PEAK_BF16)
        fma_ms = 1e3 * 4 * h * d * pairs / PEAK_FP32
        if quantized:
            (kq, ks), (vq, vs) = ckq, cvq
            ref = da.decode_attention_window_q8_plain(q, kq[last], vq[last], ks[last], vs[last],
                                                      seg, widx, num_kv_heads=hkv, scale=scale)
            label, name, kernel, library = "K11", "decode_attention_window_q8", window_q8, None
        else:
            ref = da.decode_attention_window_plain(q, ck[last], cv[last], seg, widx,
                                                   num_kv_heads=hkv, scale=scale)
            label, name, kernel, library = "K10", "decode_attention_window", window, sdpa_window
        timed(f"{label} window W={w} [8,{w},{h},{d}] x [8,4224,{row}]", name, kernel, library, ref,
              out, bound_ms, n_layers, args, this,
              [(base, n) for base, n in bases if has(base, "radvlm_" + name)], fma_ms)
        del q, part_o, part_ml, out, ref, wmask
    del ck, cv, ckq, cvq
    torch.cuda.empty_cache()


def timed(label, name, kernel, library, ref, out, bound_ms, n_layers, args, this, bases,
          fma_ms=None):
    """Hold `kernel(layer, lib)` (writing `out`) at the last layer to `ref`,
    then time it, each baseline's and `library(layer)` (if any) with the
    layers cycled; `fma_ms`: the f32 FMA floor of its dot products (pairs x
    4 D over 67 TFLOP/s), printed with the kernel's share of it."""
    kernel(n_layers - 1)
    torch.cuda.synchronize()
    err, ratio = kernels.error_ratio(name, out, ref)
    for base, bname in bases:
        kernel(n_layers - 1, base)
        torch.cuda.synchronize()
        print(f"    {bname}: {base_rule(name, out, ref)}", flush=True)
    layers = itertools.cycle(range(n_layers))
    run = lambda lib=this: kernel(next(layers), lib)  # noqa: E731
    ms = median_ms(run, args.reps, args.batch)
    # A call's host time (~20 us of Python and ctypes) is near the kernel's
    # time, so the turns are taken by torch.profiler device time.
    _, extra = in_turns(run, bases, args, lambda fn: device_ms(fn, args.reps))
    dev_ms, each = device_ms(run, args.reps, True)
    print(f"    {label}, device time by kernel: {by_kernel_text(each)}", flush=True)
    if library is None:
        versus = "no library call"
    else:
        lib_call = lambda: library(next(layers))  # noqa: E731
        lib_ms = median_ms(lib_call, args.reps, args.batch)
        lib_dev = device_ms(lib_call, args.reps)
        versus = (f"SDPA {lib_ms:.4f} ms ({lib_dev:.4f}): {ms / lib_ms:.2f}x SDPA "
                  f"({dev_ms / lib_dev if lib_dev else float('nan'):.2f}x by device time)")
    fma = "" if fma_ms is None else (
        f", FMA floor {fma_ms:.4f} ms ({100 * fma_ms / dev_ms if dev_ms else float('nan'):.1f}% "
        "of it)")
    print(f"  {label}: kernel {ms:.4f} ms ({dev_ms:.4f} by torch.profiler), {versus}, bound "
          f"{bound_ms:.4f} ms ({100 * bound_ms / dev_ms if dev_ms else float('nan'):.1f}% of it "
          f"by device time){fma}; worst element at {ratio:.3f} of its bound (max_abs_err "
          f"{err:.3e}){extra}", flush=True)


def w8a8(args, this, bases, dev, g) -> None:
    """K3 at the three phase-3 shapes, bit for bit against its plain version,
    timed against torch._int_mm + the scale products and torch._int_mm
    alone; then K13 at the same shapes, bit for bit against quantize_rows +
    K3, timed beside that pair and beside quantize_rows + torch._int_mm +
    the scale products."""
    for label, m, k, n in W8A8_SHAPES:
        xq, xs = w8.quantize_rows(torch.randn(m, k, generator=g, device=dev,
                                              dtype=torch.bfloat16))
        xs = xs[:, 0].contiguous()
        wq = torch.randint(-128, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((n,), 0.02 / 127, device=dev)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

        def k3(lib=this):
            err = lib.radvlm_w8a8_matmul(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
                                         ws.data_ptr(), out.data_ptr(), m, n, k,
                                         kernels.stream_ptr(dev))
            kernels.check(err, "w8a8_matmul")

        def int_mm():
            return torch._int_mm(xq, wq.t())

        def library():
            return ((int_mm().float() * xs[:, None]) * ws).to(torch.bfloat16)

        ref = w8.w8a8_matmul_plain(xq, xs, wq, ws, torch.bfloat16)
        k3()
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        k3_bases = [(base, name) for base, name in bases if has(base, "radvlm_w8a8_matmul")]
        for base, bname in k3_bases:
            k3(base)
            torch.cuda.synchronize()
            print(f"    {bname}: {'equal' if torch.equal(out, ref) else 'NOT equal'} to the plain "
                  "version", flush=True)
        ms, extra = in_turns(k3, k3_bases, args)
        lib_ms = median_ms(library, args.reps, args.batch)
        mm_ms = median_ms(int_mm, args.reps, args.batch)
        dev_ms, lib_dev, mm_dev = (device_ms(k3, args.reps), device_ms(library, args.reps),
                                   device_ms(int_mm, args.reps))
        n_bytes = xq.numel() + xs.numel() * 4 + wq.numel() + ws.numel() * 4 + out.numel() * 2
        bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 2 * m * k * n / PEAK_INT8)
        print(f"  K3 {label} [{m},{k}]x[{k},{n}]: {'equal' if same else 'NOT equal'} to its plain "
              f"version; kernel {ms:.4f} ms ({dev_ms:.4f} by torch.profiler; "
              f"{2 * m * k * n / ms / 1e9:.1f} TOP/s), _int_mm + scales {lib_ms:.4f} "
              f"({lib_dev:.4f}), "
              f"_int_mm alone {mm_ms:.4f} ({mm_dev:.4f}): {ms / lib_ms:.2f}x the library call, "
              f"{ms / mm_ms:.2f}x _int_mm alone; bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of it){extra}", flush=True)
        del xq, xs, wq, out, ref
        torch.cuda.empty_cache()
    for label, m, k, n in W8A8_SHAPES:
        x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        x[m // 2] = 0
        wq = torch.randint(-128, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        ws = torch.full((n,), 0.02 / 127, device=dev)
        xs = torch.empty((m,), dtype=torch.float32, device=dev)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

        def k13(lib=this):
            err = lib.radvlm_w8a8_matmul_fused(x.data_ptr(), xs.data_ptr(), wq.data_ptr(),
                                               ws.data_ptr(), out.data_ptr(), m, n, k,
                                               kernels.stream_ptr(dev))
            kernels.check(err, "w8a8_matmul_fused")

        def unfused():
            xq, xsr = w8.quantize_rows(x)
            return w8.w8a8_matmul(xq, xsr, wq, ws)

        def library():
            xq, xsr = w8.quantize_rows(x)
            return ((torch._int_mm(xq, wq.t()).float() * xsr) * ws).to(torch.bfloat16)

        ref = unfused()
        k13()
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        k13_bases = [(base, name) for base, name in bases if has(base, "radvlm_w8a8_matmul_fused")]
        for base, bname in k13_bases:
            k13(base)
            torch.cuda.synchronize()
            print(f"    {bname}: {'equal' if torch.equal(out, ref) else 'NOT equal'} to "
                  "quantize_rows + K3", flush=True)
        ms, extra = in_turns(k13, k13_bases, args)
        pair_ms = median_ms(unfused, args.reps, args.batch)
        lib_ms = median_ms(library, args.reps, args.batch)
        (dev_ms, each), pair_dev, lib_dev = (device_ms(k13, args.reps, True),
                                             device_ms(unfused, args.reps),
                                             device_ms(library, args.reps))
        print(f"    K13 {label}, device time by kernel: {by_kernel_text(each)}", flush=True)
        n_bytes = x.numel() * 2 + wq.numel() + ws.numel() * 4 + out.numel() * 2
        bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 2 * m * k * n / PEAK_INT8)
        print(f"  K13 {label} [{m},{k}]x[{k},{n}]: {'equal' if same else 'NOT equal'} to "
              f"quantize_rows + K3; kernel {ms:.4f} ms ({dev_ms:.4f} by torch.profiler; "
              f"{2 * m * k * n / ms / 1e9:.1f} TOP/s), quantize_rows + K3 {pair_ms:.4f} "
              f"({pair_dev:.4f}), quantize_rows + _int_mm + scales {lib_ms:.4f} ({lib_dev:.4f}): "
              f"{ms / pair_ms:.2f}x the pair, {ms / lib_ms:.2f}x the library call; bound "
              f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of it){extra}", flush=True)
        del x, wq, out, ref
        torch.cuda.empty_cache()


def partials_plan(n: int, k: int, sms: int, step: int):
    """(nsplit, k_per_split) of the earlier skinny-matmul design that sums K
    splits through f32 partials in device memory and a second launch (a
    baseline that takes a `part` buffer): ~2 CTAs an SM over 128-column
    blocks, whole `step`s of K."""
    cols, steps = -(-n // 128), -(-k // step)
    nsplit = max(1, min(-(-2 * sms // cols), steps))
    per = -(-steps // nsplit)
    return -(-steps // per), per * step


def skinny(args, this, bases, dev, g, *, tag, entry, name, shapes, weights, scale, plain,
           plan_of, old_step, grain, library=None, beside=None) -> None:
    """A skinny decode matmul (K5/K6 or K12) at `shapes` [(label, K, N)] and
    8 / 40 rows, held to its plain version; the weight copies `weights(n,
    k)` makes, used in turn (a small one would stay in the 50 MB L2); device
    time by torch.profiler in turns against each baseline; the kernel also
    under each other K split it takes (whole `grain`s of K); beside it
    `library(x, w, sc)` where one PyTorch call computes the same function,
    and `beside(label, m, x, ms)` for a comparison line; then the sums of a
    decode step (28 layers, and the lm_head once)."""
    sms = kernels.sm_count(dev)
    step = {}  # (label, rows) -> {version: ms}
    bounds = {}  # (label, rows) -> ms
    measure = lambda fn: device_ms(fn, args.reps)  # noqa: E731
    for label, k, n in shapes:
        ws, sc = weights(n, k), scale(n, k)
        for m in INT8MM_ROWS:
            x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            turn = itertools.cycle(ws)

            def call(lib, plan, w, part=None):
                return getattr(lib, entry)(
                    x.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), m, n, k, *plan,
                    kernels.stream_ptr(dev))

            plan = plan_of(n, k, sms)
            ref = plain(x, ws[0], sc)
            kernels.check(call(this, plan, ws[0]), name)
            torch.cuda.synchronize()
            err, ratio = kernels.error_ratio(name, out, ref)
            runs = []
            for base, bname in bases:
                old = partials_plan(n, k, sms, old_step)
                part = (torch.empty((old[0], m, n), dtype=torch.float32, device=dev)
                        if old[0] > 1 else None)
                if call(base, old, ws[0], part) != 0:  # a baseline of this design
                    old, part = plan, None
                    kernels.check(call(base, old, ws[0]), bname)
                torch.cuda.synchronize()
                print(f"    {bname} (plan {old}): {base_rule(name, out, ref)}", flush=True)
                runs.append((lambda base=base, old=old, part=part:
                             call(base, old, next(turn), part), bname))
            run = lambda: kernels.check(call(this, plan, next(turn)), name)  # noqa: E731
            a1 = measure(run)
            times = [measure(fn) for fn, _ in runs]
            a2 = measure(run) if runs else a1
            ms = statistics.median([a1, a2])
            step[(label, m)] = {"this": ms, **{bname: t for (_, bname), t in zip(runs, times)}}
            w_bytes = ws[0].numel() * ws[0].element_size() + sc.numel() * 4
            n_bytes = w_bytes + m * k * 2 + m * n * 2
            bound_ms = bounds[(label, m)] = max(1e3 * n_bytes / HBM_BYTES_PER_S,
                                                1e3 * 2 * m * k * n / PEAK_BF16)
            extra = "".join(f"; {bname}: {t:.4f} ms ({t / ms:.2f}x)"
                            for (_, bname), t in zip(runs, times))
            lib_text = ""
            if library is not None:
                lib_ms = measure(lambda: library(x, next(turn), sc))
                lib_text = f", {library.__name__} {lib_ms:.4f} ms ({ms / lib_ms:.3f}x)"
            others = []
            for c in (1, 2, 4, 8):
                steps = -(-k // grain)
                per = -(-steps // c)
                alt = (-(-steps // per), per * grain)
                if alt[0] != c or alt == plan:
                    continue
                alt_ms = measure(lambda alt=alt: kernels.check(call(this, alt, next(turn)), "alt"))
                others.append(f"{c} splits {alt_ms:.4f}")
            print(f"  {tag} {label} [{m},{k}]x[{k},{n}]: kernel {ms:.4f} ms ({a1:.4f} / {a2:.4f} "
                  f"before / after the baselines; plan {plan}, {-(-n // 64) * plan[0]} units), "
                  f"{w_bytes / ms / 1e6:.1f} GB/s of weights, bound {bound_ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}% of it){lib_text}; worst element at {ratio:.3f} "
                  f"of its bound (max_abs_err {err:.3e}); other splits: "
                  f"{', '.join(others) or 'none'}{extra}", flush=True)
            if beside is not None:
                beside(label, m, x, ms)
            del x, out, ref
        del ws
        torch.cuda.empty_cache()
    for m in INT8MM_ROWS:
        times = {label: (1 if label == "lm_head" else N_LAYERS) for label, _, _ in shapes}
        bound = sum(c * bounds[(label, m)] for label, c in times.items())
        for version in step[(shapes[0][0], m)]:
            total = sum(c * step[(label, m)][version] for label, c in times.items())
            print(f"  {tag} per decode step, {m} rows ({N_LAYERS} layers"
                  f"{' + lm_head' if 'lm_head' in times else ''}), {version}: {total:.3f} ms on "
                  f"the device, bound {bound:.3f} ms ({100 * bound / total:.1f}% of it)",
                  flush=True)


def int8mm(args, this, bases, dev, g) -> None:
    """K5/K6 at the five decode shapes against torch._weight_int8pack_mm,
    three copies of each weight."""
    from radvlm_tpu_torch.ops import int8_matmul as i8

    def _weight_int8pack_mm(x, w, sc):
        return torch._weight_int8pack_mm(x, w, sc)

    skinny(args, this, bases, dev, g, tag="K5/K6", entry="radvlm_int8_matmul",
           name="int8_matmul", shapes=INT8MM_SHAPES,
           weights=lambda n, k: [torch.randint(-128, 128, (n, k), generator=g, device=dev,
                                               dtype=torch.int8) for _ in range(3)],
           scale=lambda n, k: torch.rand(n, generator=g, device=dev) * 2e-4 + 1e-5,
           plain=i8.int8_matmul_plain, plan_of=i8._splits, old_step=64, grain=64,
           library=_weight_int8pack_mm)


def int4mm(args, this, bases, dev, g) -> None:
    """K12 at the four int4 decode shapes (no PyTorch call computes its
    function: the byte bound is its yardstick), enough weight copies to miss
    L2, and K5/K6 at gateup with 8 rows beside it."""
    from radvlm_tpu_torch.ops import int4_matmul as i4
    from radvlm_tpu_torch.ops import int8_matmul as i8

    def k56_gateup(label, m, x, ms):
        if (label, m) != ("gateup", 8):
            return
        n, k = INT4_GATEUP_N, x.shape[1]
        w8 = [torch.randint(-128, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
              for _ in range(3)]
        s8 = torch.rand(n, generator=g, device=dev) * 2e-4 + 1e-5
        turn8 = itertools.cycle(w8)
        k56 = device_ms(lambda: i8.int8_matmul(x, next(turn8), s8), args.reps)
        print(f"  K5/K6 gateup [8,{k}]x[{k},{n}] int8, same run: {k56:.4f} ms; K12 "
              f"{ms / k56:.2f}x of it", flush=True)

    skinny(args, this, bases, dev, g, tag="K12", entry="radvlm_int4_matmul",
           name="int4_matmul", shapes=INT4_SHAPES,
           weights=lambda n, k: [
               torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
               for _ in range(max(3, -(-100_000_000 // (n * k // 2))))],
           scale=lambda n, k: (torch.rand(k // i4.GROUP, n, generator=g, device=dev)
                               * (0.03 / 7) + 0.005 / 7),
           plain=i4.int4_matmul_plain, plan_of=i4._splits, old_step=i4.GROUP,
           grain=i4._STAGE_K, beside=k56_gateup)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=tuple(SET_SOURCES))
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10, help="calls in a row a sample")
    args = ap.parse_args(argv)
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    sets = [args.only] if args.only else list(SET_SOURCES)
    sources = tuple(src for name in sets for src in SET_SOURCES[name])
    # Every build at once: the library of this checkout, each baseline's,
    # and the -Xptxas -v compiles (one a source).
    out = os.path.join(kernels.BUILD_DIR, "bench_kernels")
    os.makedirs(out, exist_ok=True)
    libs = [os.path.join(out, f"libbaseline{i}.so") for i in range(len(args.baseline))]
    cmds = [nvcc_cmd(d, path, "-shared", "-Xcompiler", "-fPIC", sources=sources)
            for d, path in zip(args.baseline, libs)]
    dirs = [kernels.CSRC] + args.baseline if args.ptxas else []
    ptx = [(d, src) for d in dirs for src in sources if os.path.exists(os.path.join(d, src))]
    cmds += [nvcc_cmd(d, os.devnull, "-Xptxas", "-v", "-c", sources=(src,)) for d, src in ptx]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    this = kernels.lib()
    results = [proc.communicate() for proc in procs]
    failed = set()
    for i, (cmd, proc, (_, err)) in enumerate(zip(cmds, procs, results)):
        if proc.returncode != 0:  # a baseline that does not build is reported and left out
            print(f"  build failed ({' '.join(cmd)}):\n{err[-4000:]}", flush=True)
            failed.add(i)
    for (d, src), (_, err) in zip(ptx, results[len(libs):]):
        ptxas_report(os.path.join(d, src), err)
    bases = [(load_baseline(path), d) for i, (path, d) in enumerate(zip(libs, args.baseline))
             if i not in failed]
    g = torch.Generator(device=dev).manual_seed(0)
    runs = {"fwd": (forward, "radvlm_prefill_attention"),
            "bwd": (backward, "radvlm_flash_attention_bwd_dkv"),
            "decode": (decode, "radvlm_decode_attention"),
            "w8a8": (w8a8, "radvlm_w8a8_matmul"),
            "int8mm": (int8mm, "radvlm_int8_matmul"),
            "int4": (int4mm, "radvlm_int4_matmul")}
    for name in sets:
        fn, entry = runs[name]
        fn(args, this, [(b, n) for b, n in bases if has(b, entry)], dev, g)
        if name == "decode":  # Gemma-2B's heads; older sources refuse D = 256
            decode(args, this, [], dev, g, heads=GEMMA_2B_HEADS)


if __name__ == "__main__":
    main()
