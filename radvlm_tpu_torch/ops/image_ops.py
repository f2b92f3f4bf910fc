"""Image preprocessing: anyres tiling (host, numpy + PIL) and SigLIP
normalization (device, torch).

Counterpart of the host half of `radvlm_tpu/ops/image_ops.py`: PIL bicubic,
bit for bit the JAX package's tiles. Tile layout: tiles[0] is the base resize
of the whole image, tiles[1:] the grid tiles of the aspect-preserving
resize-and-pad, row major. RADVLM_NATIVE_ANYRES=1 sends the tiling through
the C++ tiler (`radvlm_tpu_torch/native`, within a few grey levels of PIL)
where it builds, as in the JAX package; the JAX package's XLA device path
is not ported.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import AnyResConfig
from radvlm_tpu_torch.models.anyres import select_best_resolution

SIGLIP_MEAN = 0.5
SIGLIP_STD = 0.5


def _resize_pil(img_np: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize (uint8 in, uint8 out). size = (width, height)."""
    from PIL import Image

    img = Image.fromarray(img_np)
    return np.asarray(img.resize(size_wh, Image.BICUBIC))


def normalize_pixels(x: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 normalized ((x/255 - mean) / std)."""
    return (x.astype(np.float32) / 255.0 - SIGLIP_MEAN) / SIGLIP_STD


def resize_and_pad_host(img_np: np.ndarray, target_wh: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize then centre-pad with black to target (w, h)."""
    oh, ow = img_np.shape[:2]
    tw, th = target_wh
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = _resize_pil(img_np, (nw, nh))
    canvas = np.zeros((th, tw, 3), np.uint8)
    y0, x0 = (th - nh) // 2, (tw - nw) // 2
    canvas[y0 : y0 + nh, x0 : x0 + nw] = resized
    return canvas


def resize_plan(image_size_wh: Tuple[int, int], cfg: AnyResConfig) -> Dict[str, int]:
    """The anyres geometry of an image of (w, h): the pinpoint it goes to
    (`best_w`, `best_h`) and its aspect-kept resize inside it (`new_w`,
    `new_h`), as `resize_and_pad_host` computes them (the JAX package's
    `device_plan`, on the host)."""
    ow, oh = image_size_wh
    best_w, best_h = select_best_resolution((ow, oh), cfg.pinpoints)
    scale_w, scale_h = best_w / ow, best_h / oh
    if scale_w < scale_h:
        nw, nh = best_w, min(math.ceil(oh * scale_w), best_h)
    else:
        nh, nw = best_h, min(math.ceil(ow * scale_h), best_w)
    return dict(tile_size=cfg.tile_size, best_w=best_w, best_h=best_h, new_w=nw, new_h=nh)


def preprocess_anyres_host(
    img_np: np.ndarray, cfg: AnyResConfig, *, normalize: bool = False
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """img_np uint8 [H, W, 3] -> (tiles [T, ts, ts, 3], image_size (w, h)).

    Tiles stay uint8 unless normalize=True (`normalize_tiles_device` does the
    same arithmetic on the card). RADVLM_NATIVE_ANYRES=1: the C++ tiler, where
    it builds."""
    if img_np.ndim == 2:
        img_np = np.stack([img_np] * 3, axis=-1)
    oh, ow = img_np.shape[:2]
    ts = cfg.tile_size
    best_w, best_h = select_best_resolution((ow, oh), cfg.pinpoints)

    if os.environ.get("RADVLM_NATIVE_ANYRES") == "1":
        from radvlm_tpu_torch import native

        if native.available():
            plan = resize_plan((ow, oh), cfg)
            tiles = native.anyres_tiles(img_np, ts, (best_w, best_h),
                                        (plan["new_w"], plan["new_h"]))
            return (normalize_pixels(tiles) if normalize else tiles), (ow, oh)

    padded = resize_and_pad_host(img_np, (best_w, best_h))
    post = normalize_pixels if normalize else (lambda x: x)
    tiles = [post(_resize_pil(img_np, (ts, ts)))]  # base tile first
    for r in range(0, best_h, ts):
        for c in range(0, best_w, ts):
            tiles.append(post(padded[r : r + ts, c : c + ts]))
    return np.stack(tiles), (ow, oh)


def preprocess_single_host(
    img_np: np.ndarray, cfg: AnyResConfig, *, normalize: bool = False
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Base-resolution-only path (square resize, 1 tile)."""
    if img_np.ndim == 2:
        img_np = np.stack([img_np] * 3, axis=-1)
    oh, ow = img_np.shape[:2]
    ts = cfg.tile_size
    post = normalize_pixels if normalize else (lambda x: x)
    return post(_resize_pil(img_np, (ts, ts)))[None], (ow, oh)


def normalize_tiles_device(
    tiles: torch.Tensor, dtype=torch.float32, *, mean=SIGLIP_MEAN, std=SIGLIP_STD
) -> torch.Tensor:
    """(x/255 - mean)/std for integer tiles on their device; float tiles pass
    through (already normalized). mean/std: scalars or per-channel 3-tuples."""
    if tiles.dtype.is_floating_point:
        return tiles
    x = tiles.to(dtype) / 255.0
    mean_t = torch.as_tensor(mean, dtype=dtype, device=tiles.device)
    std_t = torch.as_tensor(std, dtype=dtype, device=tiles.device)
    return (x - mean_t) / std_t
