"""Native (C++) host prep: the fused anyres tiler and the JPEG decoder (the
port's counterpart of `radvlm_tpu/native/`, with the same API).

ctypes bindings over `anyres.cc` (PIL-style bicubic resize + pad + tile in
one pass, OpenMP over output rows) and `jpeg.cc` (libjpeg decode to RGB,
outside the GIL). Each library builds at first use with `c++` into the
build directory of the port's kernels (`kernels.BUILD_DIR`, gitignored;
RADVLM_TORCH_BUILD_DIR moves it), never into the source tree, under a file
lock there (several processes may build at once), and again when its
source is newer than it.

The routes are opt-in, as in the JAX package: RADVLM_NATIVE_ANYRES=1 sends
`ops/image_ops.preprocess_anyres_host` through the tiler (within a few
grey levels of PIL), RADVLM_NATIVE_JPEG=1 sends `.jpg` / `.jpeg` in
`data/loader.load_image` through the decoder, and PIL serves where a
library is missing. A failed build is logged at WARNING with the
compiler's message; `build()` raises it instead.

The decoder declares the libjpeg 6.2 ABI itself (`jpeg62.h`) and links
against the libjpeg that PIL loads (Pillow's wheels carry libjpeg-turbo at
that ABI), so it needs no libjpeg headers on the host, and its pixels are
PIL's. The JAX package compiles against the host's jpeglib.h and -ljpeg.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import re
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}  # name -> library, or None after a failure


def libjpeg_path() -> str:
    """The libjpeg that PIL has loaded into this process (its path in the
    process's memory map). Raises where PIL's libjpeg is not at the 6.2 ABI
    that `jpeg62.h` declares."""
    from PIL import Image  # noqa: F401  (loads PIL's C core and its libjpeg)

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if re.search(r"/libjpeg[^/]*\.so", line)}
    for path in sorted(paths):
        if re.search(r"\.so\.62(\.|$)", path):
            return path
    raise RuntimeError(f"PIL's libjpeg is not at the 6.2 ABI jpeg.cc declares: {sorted(paths)}")


def _commands(name: str, out: str):
    if name == "anyres":
        return [["c++", "-O3", "-fopenmp", "-shared", "-fPIC",
                 os.path.join(_DIR, "anyres.cc"), "-o", out]]
    jpeg = libjpeg_path()
    return [["c++", "-O3", "-shared", "-fPIC", os.path.join(_DIR, "jpeg.cc"), "-o", out, jpeg,
             "-Wl,-rpath," + os.path.dirname(jpeg)]]


_SOURCES = {"anyres": ("anyres.cc",), "jpeg": ("jpeg.cc", "jpeg62.h")}


def _build_dir() -> str:
    from radvlm_tpu_torch import kernels

    return kernels.BUILD_DIR


def _library(name: str, force: bool = False) -> str:
    """Build `lib<name>.so` into the build directory if stale (or `force`);
    returns its path. Raises with the compiler's message on a failure."""
    build_dir = _build_dir()
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"libradvlm_{name}.so")
    srcs = [os.path.join(_DIR, s) for s in _SOURCES[name]]
    with open(os.path.join(build_dir, "native.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if (not force and os.path.exists(path)
                and all(os.path.getmtime(s) <= os.path.getmtime(path) for s in srcs)):
            return path
        tmp = f"{path}.tmp{os.getpid()}"
        for cmd in _commands(name, tmp):
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"native {name} build failed ({' '.join(cmd)}):\n"
                                   f"{proc.stderr}")
        os.replace(tmp, path)
    return path


def build(force: bool = False) -> Dict[str, str]:
    """Build both libraries (again with `force`) and load them; returns
    their paths. Raises on a failed build or load."""
    paths = {name: _library(name, force) for name in _SOURCES}
    with _lock:
        for name in _SOURCES:
            _libs.pop(name, None)
    for name in _SOURCES:
        if _load(name) is None:
            raise RuntimeError(f"native {name}: the library was built but did not load")
    return paths


def _bind(name: str, lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    if name == "anyres":
        lib.anyres_tiles.argtypes = [u8p] + [ctypes.c_int] * 2 + [u8p] + [ctypes.c_int] * 5
        lib.anyres_tiles.restype = ctypes.c_int
        lib.resize_rgb.argtypes = [u8p] + [ctypes.c_int] * 2 + [u8p] + [ctypes.c_int] * 2
        lib.resize_rgb.restype = None
    else:
        ip = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_info.argtypes = [u8p, ctypes.c_int, ip, ip]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int]
        lib.jpeg_decode_rgb.restype = ctypes.c_int


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None (logged once at WARNING)
    where it does not build or load."""
    with _lock:  # two prefetch threads must not race the build
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(_library(name))
            _bind(name, lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.warning("native %s unavailable (PIL serves instead): %s", name, e)
            lib = None
        _libs[name] = lib
        return lib


def available() -> bool:
    """Whether the anyres tiler builds and loads."""
    return _load("anyres") is not None


def jpeg_available() -> bool:
    """Whether the JPEG decoder builds and loads."""
    return _load("jpeg") is not None


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB (grayscale expanded). Raises
    ValueError on malformed input; runs outside the GIL."""
    lib = _load("jpeg")
    if lib is None:
        raise RuntimeError("native jpeg library unavailable")
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(buf, len(buf), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError("invalid JPEG header")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode_rgb(buf, len(buf), out, out.size)
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out


def anyres_tiles(img: np.ndarray, tile_size: int, best_wh: Tuple[int, int],
                 new_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 tiles [1 + grid, ts, ts, 3] (base first).
    `best_wh` is the pinpoint the image goes to, `new_wh` its aspect-kept
    resize inside it (`ops/image_ops.resize_plan`)."""
    lib = _load("anyres")
    if lib is None:
        raise RuntimeError("native anyres library unavailable")
    img = np.ascontiguousarray(img, np.uint8)
    best_w, best_h = best_wh
    new_w, new_h = new_wh
    n_tiles = 1 + (best_h // tile_size) * (best_w // tile_size)
    out = np.empty((n_tiles, tile_size, tile_size, 3), np.uint8)
    h, w = img.shape[:2]
    written = lib.anyres_tiles(img, h, w, out, tile_size, best_w, best_h, new_w, new_h)
    if written != n_tiles:
        raise RuntimeError(f"native anyres wrote {written} tiles, expected {n_tiles}")
    return out


def resize_rgb(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [out_h, out_w, 3], PIL-style bicubic."""
    lib = _load("anyres")
    if lib is None:
        raise RuntimeError("native anyres library unavailable")
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.resize_rgb(img, img.shape[0], img.shape[1], out, out_h, out_w)
    return out
