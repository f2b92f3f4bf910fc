"""Build, load and count the port's hand-written Hopper kernels.

The CUDA sources in `csrc/` compile with `nvcc`, one process per source, all
started together, and link into one shared library with a plain C
interface, loaded through `ctypes` (no PyTorch headers, so a build takes
seconds). The library is built at first use, under a lock, into
`build/radvlm_tpu_torch/` at the repository root (listed in `.gitignore`),
and rebuilt when a source is newer than it; `RADVLM_TORCH_BUILD_DIR`
overrides the directory.

Every wrapper calls `count_launch` where it launches its kernel, and
nowhere else: the counts show that a run went through the kernels. A CUDA
graph's capture runs the wrappers without launching anything: it counts
under `recording()`, and each replay adds what it recorded
(`add_launches`). Importing this module needs no CUDA toolkit and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterator, Optional

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.environ.get(
    "RADVLM_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(_PKG), "build", "radvlm_tpu_torch"),
)
LIB_NAME = "libradvlm_kernels.so"

# Kernel name -> launches since the last reset (serving threads share it).
_launches: Dict[str, int] = {
    "tower_attention": 0,  # K1
    "prefill_attention": 0,  # K2
    "decode_attention": 0,  # K9
    "w8a8_matmul": 0,  # K3
    "decode_attention_q8": 0,  # K4
    "int8_matmul": 0,  # K5/K6
    "decode_attention_window": 0,  # K10
    "decode_attention_window_q8": 0,  # K11
    "int4_matmul": 0,  # K12
    "w8a8_matmul_fused": 0,  # K13
    "prefill_attention_lse": 0,  # K2 writing the lse (the training forward)
    "flash_attention_bwd_dkv": 0,  # K7
    "flash_attention_bwd_dq": 0,  # K8
}
_count_lock = threading.Lock()
_recording = threading.local()  # .counts: this thread's capture, or None
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def count_launch(name: str) -> None:
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _count_lock:
        _launches[name] += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """This thread's launches go into the yielded dict, not the counts: a
    CUDA graph's capture, whose kernels run only when it is replayed.
    Other threads count as before."""
    outer = getattr(_recording, "counts", None)
    _recording.counts = rec = {}
    try:
        yield rec
    finally:
        _recording.counts = outer


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches made elsewhere than in a wrapper: a graph's replay."""
    with _count_lock:
        for name, n in counts.items():
            _launches[name] += n


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_launches)


# Absolute part of the bound a kernel's bf16 output is held to against its
# plain version on the same inputs (see `error_ratio`).
ATOL = {
    # K1/K2 round p to bf16 against the running max of the keys seen so
    # far (exp2), the plain version against the row's max (exp).
    "tower_attention": 1e-3,
    "prefill_attention": 1e-3,
    # K9 and K4 keep p (K4: p * vs) in f32, as their plain versions do:
    # f32 sums in another order and exp2 for exp.
    "decode_attention": 1e-4,
    "decode_attention_q8": 1e-4,
    # K10 and K11 repeat K9's and K4's arithmetic for each row of the window.
    "decode_attention_window": 1e-4,
    "decode_attention_window_q8": 1e-4,
    # K3 sums exactly in int32, as its plain version does (in f64), and
    # applies the same two f32 products: equal bit for bit.
    "w8a8_matmul": 0.0,
    # K5/K6: bf16 x (int8 -> bf16) products are exact; f32 sums in another
    # order (and over K splits) than the plain f32 matmul.
    "int8_matmul": 1e-4,
    # K12: both sides round each weight to bf16 after its group scale, so the
    # bf16 x bf16 products are exact; f32 sums in another order (and over K
    # splits) than the plain f32 matmul.
    "int4_matmul": 1e-4,
    # K13 repeats `quantize_rows` (IEEE division, round half to even) and K3's
    # exact int32 sum and f32 epilogue: equal to quantize_rows + K3 bit for bit.
    "w8a8_matmul_fused": 0.0,
    # K2 with the lse is K2.
    "prefill_attention_lse": 1e-3,
    # K7/K8 recompute p by exp2 where the plain version takes exp, and both
    # round p and ds to bf16 before the products: a value at a rounding
    # boundary falls on either side, and f32 sums run in another order.
    "flash_attention_bwd_dkv": 1e-3,
    "flash_attention_bwd_dq": 1e-3,
}


def error_ratio(name: str, out: torch.Tensor, ref: torch.Tensor, rows=None):
    """How far a kernel's output is from its plain version's.

    Each output row (the last dim: one query and head) is held to
    |out - ref| <= 2^-7 max_row|ref| + ATOL[name], one bf16 ulp of the
    row's largest value. Each side rounds its f32 result to bf16 once, and
    in K1/K2 the two round p to bf16 after exp2 and exp, which can fall on
    either side of a bf16 rounding boundary: that moves every element of
    the row by an amount set by the row's values, not the element's own.
    Returns (max |out - ref|, the largest |out - ref| / bound) over `rows`
    (a boolean index) if given; a ratio above 1 is a disagreement. A kernel
    whose ATOL is 0 must equal its plain version bit for bit: its ratio is 0
    when it does and inf otherwise. Raises if `out` is not finite."""
    o, r = out.float(), ref.float()
    if rows is not None:
        o, r = o[rows], r[rows]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (o - r).abs()
    if ATOL[name] == 0:
        err = float(diff.max())
        return err, (0.0 if err == 0 else float("inf"))
    bound = 2.0 ** -7 * r.abs().amax(-1, keepdim=True) + ATOL[name]
    return float(diff.max()), float((diff / bound).max())


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(s) > built for s in _sources())


def _run_all(cmds):
    """Run the commands at once; raise with the first failure's stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, err)
    if failed is not None:
        raise RuntimeError(f"kernel build failed ({' '.join(failed[0])}):\n{failed[1]}")


def build(force: bool = False) -> str:
    """Compile `csrc/*.cu` for sm_90a into the build directory if stale:
    one nvcc per source, in parallel, then one link.

    Returns the library's path. Safe across threads and processes (a file
    lock in the build directory). Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not force and not _stale(lib_path):
            return lib_path
        nvcc, pid = _nvcc(), os.getpid()
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{pid}.o") for s in srcs]
        _run_all([
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-I", CSRC, "-c", src, "-o", obj]
            for src, obj in zip(srcs, objs)
        ])
        tmp = lib_path + f".tmp{pid}"
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            handle.radvlm_tower_attention.argtypes = [p, p, p, p, i, i, i, i, f, p]
            handle.radvlm_prefill_attention.argtypes = [
                p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_prefill_attention_lse.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_flash_attention_bwd_dkv.argtypes = [
                p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_flash_attention_bwd_dq.argtypes = [
                p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_decode_attention.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_decode_attention_q8.argtypes = [
                p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_decode_attention_window.argtypes = [
                p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_decode_attention_window_q8.argtypes = [
                p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
            ]
            handle.radvlm_w8a8_matmul.argtypes = [p, p, p, p, p, i, i, i, p]
            handle.radvlm_int8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            handle.radvlm_int4_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            handle.radvlm_w8a8_matmul_fused.argtypes = [p, p, p, p, p, i, i, i, p]
            for fn in ("radvlm_tower_attention", "radvlm_prefill_attention",
                       "radvlm_decode_attention", "radvlm_decode_attention_q8",
                       "radvlm_decode_attention_window",
                       "radvlm_decode_attention_window_q8",
                       "radvlm_w8a8_matmul", "radvlm_int8_matmul",
                       "radvlm_int4_matmul", "radvlm_w8a8_matmul_fused",
                       "radvlm_prefill_attention_lse", "radvlm_flash_attention_bwd_dkv",
                       "radvlm_flash_attention_bwd_dq"):
                getattr(handle, fn).restype = ctypes.c_int
            handle.radvlm_error_string.argtypes = [i]
            handle.radvlm_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().radvlm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors: what the split plans size their
    grids by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensors(name: str, *tensors: torch.Tensor, align: int = 4) -> None:
    """The kernels take contiguous CUDA tensors whose data is `align`-byte
    aligned (16 where they use 16-byte loads); anything else is a caller
    error, not a fallback."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: tensor data is not {align}-byte aligned")


def require_dtype(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: the kernel takes {dtype} {arg}, got {t.dtype}")
