"""Time the forward attention kernels (K1, K2, K2 with the lse) on the card
at the five shapes the main paths give them, against SDPA and, optionally,
against another version of `csrc/flash_attention.cu` in turns.

    python -m radvlm_tpu_torch.bench_attention [--baseline DIR] [--ptxas] [--reps N] [--batch N]

- Each shape is first held to the plain version (`kernels.error_ratio`).
- Times are medians of `--reps` samples, each sample CUDA events around
  `--batch` calls in a row (the host's launches run ahead of the card, so
  this is device time); the kernel and SDPA are also timed one call a
  sample, their wrappers' host time included.
- `--baseline DIR` (repeatable): DIR holds another `flash_attention.cu`
  (and the headers it includes); each is built into a library of its own
  (same C entry points, loaded apart), held to the same rule (reported, not
  asserted) and timed against this checkout's kernel in the order this,
  each baseline, this. One that does not build is reported and left out.
- `--ptxas`: compile this checkout's `flash_attention.cu` (and each
  baseline's) with `-Xptxas -v` and print registers, shared memory, spills
  and ptxas's warnings per instantiation.

Prints one line per shape: the kernel's median ms, SDPA's, the bound (the
larger of bytes over 3.35 TB/s and the pairs the masks leave x 4 x D flops
over 989 TFLOP/s), the kernel's share of the bound and its ratio to SDPA.
Needs a Hopper card and nvcc.
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


def nvcc_cmd(src_dir: str, out: str, *flags: str):
    return [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            *flags, "-I", src_dir, os.path.join(src_dir, "flash_attention.cu"), "-o", out]


def load_baseline(lib_path: str) -> ctypes.CDLL:
    """Another version's flash_attention.cu, built as a library of its own."""
    lib = ctypes.CDLL(lib_path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.radvlm_tower_attention.argtypes = [p, p, p, p, i, i, i, i, f, p]
    lib.radvlm_prefill_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.radvlm_prefill_attention_lse.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    return lib


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


def ptxas_report(src_dir: str, stderr: str) -> None:
    print(f"  ptxas, {src_dir}/flash_attention.cu:", flush=True)
    for line in stderr.splitlines():
        if "Function properties" in line or "bytes gmem" in line or "cmem" in line:
            continue
        print("   ", line.strip()[:240], flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    # and the -Xptxas -v compiles.
    out = os.path.join(kernels.BUILD_DIR, "bench_attention")
    os.makedirs(out, exist_ok=True)
    libs = [os.path.join(out, f"libbaseline{i}.so") for i in range(len(args.baseline))]
    cmds = [nvcc_cmd(d, path, "-shared", "-Xcompiler", "-fPIC")
            for d, path in zip(args.baseline, libs)]
    dirs = [kernels.CSRC] + args.baseline if args.ptxas else []
    cmds += [nvcc_cmd(d, os.devnull, "-Xptxas", "-v", "-c") for d in dirs]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    this = kernels.lib()
    results = [proc.communicate() for proc in procs]
    failed = set()
    for i, (cmd, proc, (_, err)) in enumerate(zip(cmds, procs, results)):
        if proc.returncode != 0:  # a baseline that does not build is reported and left out
            print(f"  build failed ({' '.join(cmd)}):\n{err[-4000:]}", flush=True)
            failed.add(i)
    for d, (_, err) in zip(dirs, results[len(libs):]):
        ptxas_report(d, err)
    names = [d for i, d in enumerate(args.baseline) if i not in failed]
    bases = [load_baseline(path) for i, path in enumerate(libs) if i not in failed]
    g = torch.Generator(device=dev).manual_seed(0)
    for label, entry, b, s, h, hkv, d, causal, layout in SHAPES:
        q = torch.randn(b, s, h, d, generator=g, device=dev, dtype=torch.bfloat16)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=torch.bfloat16)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev, dtype=torch.bfloat16)
        seg = segments(layout, b, s, dev)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), device=dev, dtype=torch.float32)
        name = {"tower": "tower_attention", "prefill": "prefill_attention",
                "lse": "prefill_attention_lse"}[entry]
        call_lib(this, entry, q, k, v, seg, causal, o, lse)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v, seg, seg, causal, d ** -0.5)
        err, ratio = kernels.error_ratio(name, o, ref, None if seg is None else seg.bool())
        mask = None if seg is None and not causal else tatt.make_attention_mask(
            seg if seg is not None else torch.ones((b, s), dtype=torch.int32, device=dev),
            seg if seg is not None else torch.ones((b, s), dtype=torch.int32, device=dev), causal)
        pairs = b * s * s if mask is None else int(mask.sum())
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
        if entry == "lse":
            n_bytes += lse.numel() * 4
        if seg is not None:
            n_bytes += 2 * seg.numel() * 4
        bound_ms = max(1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * 4 * h * d * pairs / PEAK_BF16)
        run = lambda lib=this: call_lib(lib, entry, q, k, v, seg, causal, o, lse)  # noqa: E731
        base_ratios = []
        for base in bases:  # each baseline held to the same rule, reported, not asserted
            run(base)
            torch.cuda.synchronize()
            try:
                base_ratios.append(kernels.error_ratio(name, o, ref,
                                                       None if seg is None else seg.bool())[1])
            except AssertionError:  # non-finite output
                base_ratios.append(float("inf"))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=h != hkv)
        sdpa_ms = median_ms(sdpa, args.reps, args.batch)
        sdpa_call_ms, call_ms = median_ms(sdpa, args.reps), median_ms(run, args.reps)
        a1 = median_ms(run, args.reps, args.batch)
        times = [median_ms(lambda: run(base), args.reps, args.batch) for base in bases]
        a2 = median_ms(run, args.reps, args.batch) if bases else a1
        ms = statistics.median([a1, a2])
        extra = "".join(f"; {d}: {t:.4f} ms ({t / ms:.2f}x, worst element at {r:.3f})"
                        for d, t, r in zip(names, times, base_ratios))
        if bases:
            extra += f"; this {a1:.4f} / {a2:.4f} ms before / after them"
        print(f"  {label}: kernel {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x SDPA), "
              f"bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of it); worst element at "
              f"{ratio:.3f} of its bound (max_abs_err {err:.3e}); one call at a time (host "
              f"time included): kernel {call_ms:.4f} ms, SDPA {sdpa_call_ms:.4f} ms{extra}",
              flush=True)
        del q, k, v, o, lse, ref, mask
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
