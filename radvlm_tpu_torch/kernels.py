"""Build, load and count the port's hand-written Hopper kernels.

The CUDA sources in `csrc/` compile with `nvcc` into one shared library with
a plain C interface, loaded through `ctypes` (no PyTorch headers, so a build
takes seconds). The library is built at first use, under a lock, into
`build/radvlm_tpu_torch/` at the repository root (listed in `.gitignore`),
and rebuilt when a source is newer than it; `RADVLM_TORCH_BUILD_DIR`
overrides the directory.

Every wrapper calls `count_launch` where it launches its kernel, and
nowhere else: the counts show that a run went through the kernels.
Importing this module needs no CUDA toolkit and no card.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

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
}
_count_lock = threading.Lock()
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] += 1


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
    # K9 keeps p in f32, as its plain version does: f32 sums in another
    # order and exp2 for exp.
    "decode_attention": 1e-4,
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
    (a boolean index) if given; a ratio above 1 is a disagreement. Raises
    if `out` is not finite."""
    o, r = out.float(), ref.float()
    if rows is not None:
        o, r = o[rows], r[rows]
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (o - r).abs()
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


def build(force: bool = False) -> str:
    """Compile `csrc/*.cu` for sm_90a into the build directory if stale.

    Returns the library's path. Safe across threads and processes (a file
    lock in the build directory). Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if not force and not _stale(lib_path):
            return lib_path
        tmp = lib_path + f".tmp{os.getpid()}"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC,
            "-o", tmp, *[s for s in _sources() if s.endswith(".cu")],
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr}"
            )
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
            handle.radvlm_decode_attention.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
            ]
            for fn in ("radvlm_tower_attention", "radvlm_prefill_attention",
                       "radvlm_decode_attention"):
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


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensors(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous bf16/int32 CUDA tensors with 4-byte
    aligned data; anything else is a caller error, not a fallback."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: tensor data is not 4-byte aligned")
