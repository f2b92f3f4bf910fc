"""Time the attention kernels on the card at the shapes the main paths give
them: the forwards (K1, K2, K2 with the lse) against SDPA, and the backward
(K7 dk / dv, K8 dq) against SDPA's backward, optionally against other
versions of `csrc/flash_attention.cu` / `csrc/flash_attention_bwd.cu` in
turns.

    python -m radvlm_tpu_torch.bench_attention [--only fwd|bwd] [--baseline DIR] [--ptxas]
        [--reps N] [--batch N]

- Each shape is first held to the plain version (`kernels.error_ratio`).
- Times are medians of `--reps` samples, each sample CUDA events around
  `--batch` calls in a row (the host's launches run ahead of the card, so
  this is device time); the forward kernels and SDPA are also timed one call
  a sample, their wrappers' host time included.
- The backward at the three training shapes (0.5B and 7B decoders, the
  tower): K7, K8, and K7 + K8 + `attention_delta` (what the autograd
  Function runs) against one `torch.autograd.grad` through SDPA, which gives
  dq, dk and dv together.
- `--baseline DIR` (repeatable): DIR holds another `flash_attention.cu`
  and / or `flash_attention_bwd.cu` (and the headers they include); the
  sources there are built into a library of their own (same C entry points,
  loaded apart), held to the same rule (reported, not asserted) and timed
  against this checkout's kernels in the order this, each baseline, this.
  One that does not build is reported and left out.
- `--ptxas`: compile this checkout's two sources (and each baseline's) with
  `-Xptxas -v` and print registers, shared memory, spills and ptxas's
  warnings per instantiation.

Prints one line per shape and kernel: the kernel's median ms, the library
call's, the bound (the larger of bytes over 3.35 TB/s and the pairs the
masks leave x 4 x D flops a product over 989 TFLOP/s), the kernel's share
of the bound and its ratio to the library call. Needs a Hopper card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import flash_attention as fa

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12

# (label, entry, B, S, H, Hkv, D, causal, segment layout)
SHAPES = [
    ("K1 tower [10,729,16,72]", "tower", 10, 729, 16, 16, 72, False, None),
    ("K2 7B prefill [2,4096,28|4,128]", "prefill", 2, 4096, 28, 4, 128, True, "left_pad2"),
    ("K2-lse 0.5B [1,4096,14|2,64]", "lse", 1, 4096, 14, 2, 64, True, "packed"),
    ("K2-lse 7B [1,4096,28|4,128]", "lse", 1, 4096, 28, 4, 128, True, "left_pad"),
    ("K2-lse tower [5,729,16,72]", "lse", 5, 729, 16, 16, 72, False, None),
]
# The backward's shapes: (label, B, S, H, Hkv, D, causal, segment layout).
BWD_SHAPES = [
    ("0.5B decoder [1,4096,14|2,64]", 1, 4096, 14, 2, 64, True, "packed"),
    ("7B decoder [1,4096,28|4,128]", 1, 4096, 28, 4, 128, True, "left_pad"),
    ("tower [5,729,16,72]", 5, 729, 16, 16, 72, False, None),
]
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")


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


def device_ms(fn, reps: int) -> float:
    """The summed duration of the kernels one fn() launches, by
    torch.profiler over `reps` calls: the card's time without the host's,
    which a sample of calls in a row still holds where the host issues
    slower than the card runs (autograd.grad's backward). 0 where the
    profiler traces no device."""
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
    return busy / 1e3 / reps


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


def in_turns(run, bases, args):
    """This checkout's kernel, each baseline's ((library, name) pairs), this
    one again: the median of this one's two times, and text with each
    baseline's time."""
    a1 = median_ms(run, args.reps, args.batch)
    times = [median_ms(lambda base=base: run(base), args.reps, args.batch) for base, _ in bases]
    a2 = median_ms(run, args.reps, args.batch) if bases else a1
    extra = "".join(f"; {name}: {t:.4f} ms ({t / statistics.median([a1, a2]):.2f}x)"
                    for (_, name), t in zip(bases, times))
    if bases:
        extra += f"; this {a1:.4f} / {a2:.4f} ms before / after them"
    return statistics.median([a1, a2]), extra


def forward(args, this, bases, dev, g) -> None:
    for label, entry, b, s, h, hkv, d, causal, layout in SHAPES:
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
    bases = [(base, n) for base, n in bases if has(base, "radvlm_flash_attention_bwd_dkv")]
    for label, b, s, h, hkv, d, causal, layout in BWD_SHAPES:
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10, help="calls in a row a sample")
    args = ap.parse_args(argv)
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    # Every build at once: the library of this checkout, each baseline's,
    # and the -Xptxas -v compiles (one a source).
    out = os.path.join(kernels.BUILD_DIR, "bench_attention")
    os.makedirs(out, exist_ok=True)
    libs = [os.path.join(out, f"libbaseline{i}.so") for i in range(len(args.baseline))]
    cmds = [nvcc_cmd(d, path, "-shared", "-Xcompiler", "-fPIC")
            for d, path in zip(args.baseline, libs)]
    dirs = [kernels.CSRC] + args.baseline if args.ptxas else []
    ptx = [(d, src) for d in dirs for src in SOURCES if os.path.exists(os.path.join(d, src))]
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
    if args.only != "bwd":
        forward(args, this, [(b, n) for b, n in bases if has(b, "radvlm_prefill_attention")],
                dev, g)
    if args.only != "fwd":
        backward(args, this, bases, dev, g)


if __name__ == "__main__":
    main()
