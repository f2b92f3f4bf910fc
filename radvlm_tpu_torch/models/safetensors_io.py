"""Read and write the safetensors container without the `safetensors`
package (the JAX package calls it; a machine that serves the port need not
have it).

The format: 8 bytes, the little-endian length N of the header; N bytes of
JSON, one entry a tensor, {"dtype": "F32", "shape": [..], "data_offsets":
[begin, end]} with offsets into the byte buffer that follows the header
(an optional "__metadata__" entry holds strings); then the raw little-endian
buffers, back to back. `read_file` maps the file into memory (copy on write,
so nothing is read until a tensor is used and nothing is ever written back)
and returns CPU tensors that view it; `read_dir` merges the shards of a
directory; `write_file` writes one file sequentially.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> (numpy dtype the bytes are viewed as, torch dtype
# of the result). numpy has no bf16: its bytes are viewed as int16 and then
# re-viewed by torch.
_DTYPES = {
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "U16": (np.uint16, torch.uint16),
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "I32": (np.int32, torch.int32),
    "F32": (np.float32, torch.float32),
    "I64": (np.int64, torch.int64),
}
_NAMES = {torch_dtype: name for name, (_, torch_dtype) in _DTYPES.items()}


def read_header(path: str) -> tuple:
    """(header dict, offset of the byte buffer) of one file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n).decode("utf-8"))
    return header, 8 + n


def read_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, as CPU tensors over a copy-on-write memory
    map (little-endian hosts)."""
    header, base = read_header(path)
    buf = np.memmap(path, dtype=np.uint8, mode="c")
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {entry['dtype']}")
        np_dtype, torch_dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np.dtype(np_dtype).itemsize or base + end > buf.shape[0]:
            raise ValueError(f"{path}: tensor {name!r} has inconsistent offsets")
        if count == 0:
            out[name] = torch.empty(shape, dtype=torch_dtype)
            continue
        if (base + begin) % np.dtype(np_dtype).itemsize:  # a foreign, unaligned file
            arr = np.array(buf[base + begin:base + end]).view(np_dtype)
        else:
            arr = np.frombuffer(buf, dtype=np_dtype, count=count, offset=base + begin)
        t = torch.from_numpy(arr)
        if t.dtype != torch_dtype:
            t = t.view(torch_dtype)
        out[name] = t.reshape(shape)
    return out


def read_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every `*.safetensors` shard under `path`."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(read_file(f))
    return state


def write_file(tensors: Mapping[str, torch.Tensor], path: str,
               metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device; moved to the host one at a time) as one
    safetensors file: wider element types first, then by name, the header
    padded with spaces to a multiple of 8 bytes, so every buffer starts at a
    multiple of its element size."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().cpu().contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
