"""AnyRes geometry (numpy) and the feature merge (torch).

Counterpart of `radvlm_tpu/models/anyres.py`. The per-image merge (tiles ->
unpad -> optional bilinear downscale -> newline column -> base tile first)
depends only on the image size and the tile grid, so the host computes a
sparse plan - for every output token up to 4 (source row, weight) pairs into
the flattened [T*tpt + 1] tile features (+1 = the image_newline row) - and
the device applies it as one weighted gather. Bilinear weights follow torch
`F.interpolate(mode="bilinear", align_corners=False)`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from radvlm_tpu_torch.config import AnyResConfig


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """The candidate (width, height) with the most effective resolution,
    ties broken by least wasted area."""
    ow, oh = original_size
    best = None
    best_eff = -1
    best_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best_eff, best_waste, best = eff, waste, (w, h)
    return best


def grid_shape_for_image(image_size: Tuple[int, int], cfg: AnyResConfig) -> Tuple[int, int]:
    """(grid_cols, grid_rows) of tiles for an image of (width, height)."""
    w, h = select_best_resolution(image_size, cfg.pinpoints)
    return w // cfg.tile_size, h // cfg.tile_size


def _unpad_shape(
    orig_w: int, orig_h: int, grid_w_cells: int, grid_h_cells: int
) -> Tuple[int, int, int, int]:
    """(rows, cols, row_offset, col_offset) kept after unpadding the merged
    [grid_h_cells, grid_w_cells] feature grid."""
    original_ar = orig_w / orig_h
    current_ar = grid_w_cells / grid_h_cells
    if original_ar > current_ar:
        scale = grid_w_cells / orig_w
        new_h = int(orig_h * scale)
        pad = (grid_h_cells - new_h) // 2
        return grid_h_cells - 2 * pad, grid_w_cells, pad, 0
    scale = grid_h_cells / orig_h
    new_w = int(orig_w * scale)
    pad = (grid_w_cells - new_w) // 2
    return grid_h_cells, grid_w_cells - 2 * pad, 0, pad


@dataclasses.dataclass
class MergePlan:
    """Sparse per-image merge: out[i] = sum_k weights[i,k] * src[indices[i,k]].

    src is the [num_tiles*tpt + 1] feature matrix whose LAST row is the
    image_newline; rows past `length` point at it with weight 0."""

    indices: np.ndarray  # [max_tokens, 4] int32
    weights: np.ndarray  # [max_tokens, 4] float32
    length: int
    num_tiles: int  # includes the base tile
    grid: Tuple[int, int]  # (cols, rows) of grid tiles (base excluded)


def max_merged_tokens(cfg: AnyResConfig, tokens_per_side: int) -> int:
    """Static output budget of the merge gather over all realizable grids."""
    tpt = tokens_per_side ** 2
    best = 0
    lo, hi = cfg.grid_range
    for gw in range(lo, hi + 1):
        for gh in range(lo, hi + 1):
            rows = gh * tokens_per_side
            cols = gw * tokens_per_side
            times = math.sqrt(rows * cols / (cfg.anyres_max * tpt))
            if times > 1.1:
                rows, cols = int(rows // times), int(cols // times)
            best = max(best, rows * (cols + 1))
    return tpt + best


def compute_merge_plan(
    image_size: Tuple[int, int],
    cfg: AnyResConfig,
    tokens_per_side: int,
    max_tokens: int | None = None,
) -> MergePlan:
    """Host-side plan for one image. image_size = (width, height)."""
    tpt = tokens_per_side ** 2
    gw, gh = grid_shape_for_image(image_size, cfg)
    num_tiles = 1 + gw * gh
    if max_tokens is None:
        max_tokens = max_merged_tokens(cfg, tokens_per_side)
    newline_row = num_tiles * tpt

    def cell_index(r: int, c: int) -> int:
        tile_r, in_r = divmod(r, tokens_per_side)
        tile_c, in_c = divmod(c, tokens_per_side)
        tile = 1 + tile_r * gw + tile_c
        return tile * tpt + in_r * tokens_per_side + in_c

    rows_cells, cols_cells = gh * tokens_per_side, gw * tokens_per_side
    kept_rows, kept_cols, row_off, col_off = _unpad_shape(
        image_size[0], image_size[1], cols_cells, rows_cells
    )
    # anyres_max token cap via bilinear downscale.
    times = math.sqrt(kept_rows * kept_cols / (cfg.anyres_max * tpt))
    resized = times > 1.1
    if resized:
        out_rows, out_cols = int(kept_rows // times), int(kept_cols // times)
    else:
        out_rows, out_cols = kept_rows, kept_cols

    indices = np.full((max_tokens, 4), newline_row, np.int32)
    weights = np.zeros((max_tokens, 4), np.float32)
    indices[:tpt, 0] = np.arange(tpt, dtype=np.int32)  # base tile, identity
    weights[:tpt, 0] = 1.0

    out_i = tpt
    for r in range(out_rows):
        if resized:
            src_r = (r + 0.5) * (kept_rows / out_rows) - 0.5
            r0 = int(math.floor(src_r))
            fr = src_r - r0
            r0c = min(max(r0, 0), kept_rows - 1)
            r1c = min(max(r0 + 1, 0), kept_rows - 1)
        for c in range(out_cols):
            if resized:
                src_c = (c + 0.5) * (kept_cols / out_cols) - 0.5
                c0 = int(math.floor(src_c))
                fc = src_c - c0
                c0c = min(max(c0, 0), kept_cols - 1)
                c1c = min(max(c0 + 1, 0), kept_cols - 1)
                pairs = [
                    (r0c, c0c, (1 - fr) * (1 - fc)),
                    (r0c, c1c, (1 - fr) * fc),
                    (r1c, c0c, fr * (1 - fc)),
                    (r1c, c1c, fr * fc),
                ]
                for k, (rr, cc, w) in enumerate(pairs):
                    indices[out_i, k] = cell_index(rr + row_off, cc + col_off)
                    weights[out_i, k] = w
            else:
                indices[out_i, 0] = cell_index(r + row_off, c + col_off)
                weights[out_i, 0] = 1.0
            out_i += 1
        indices[out_i, 0] = newline_row  # newline column ends each row
        weights[out_i, 0] = 1.0
        out_i += 1

    return MergePlan(
        indices=indices, weights=weights, length=out_i, num_tiles=num_tiles, grid=(gw, gh)
    )


def flat_tile_plan(tokens_per_tile: int, max_tokens: int, newline: bool = True) -> MergePlan:
    """Identity plan over one tile's features (+ a trailing newline)."""
    tpt = tokens_per_tile
    indices = np.full((max_tokens, 4), tpt, np.int32)
    weights = np.zeros((max_tokens, 4), np.float32)
    indices[:tpt, 0] = np.arange(tpt, dtype=np.int32)
    weights[:tpt, 0] = 1.0
    length = tpt
    if newline:
        indices[tpt, 0] = tpt
        weights[tpt, 0] = 1.0
        length = tpt + 1
    return MergePlan(indices=indices, weights=weights, length=length, num_tiles=1, grid=(0, 0))


def apply_merge(
    tile_features: torch.Tensor,
    image_newline: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """tile_features [T, tpt, D], image_newline [D], indices/weights
    [N, 4] -> [N, D]: gather then weighted sum (f32 sums, cast back)."""
    t, tpt, d = tile_features.shape
    src = torch.cat([tile_features.reshape(t * tpt, d), image_newline[None, :]], dim=0)
    gathered = src[indices.long()]  # [N, 4, D]
    w = weights.to(gathered.dtype).float()
    return torch.einsum("nk,nkd->nd", w, gathered.float()).to(tile_features.dtype)


def batch_plans(plans: List[MergePlan]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-image plans -> (indices [B,N,4], weights [B,N,4], lengths [B])."""
    indices = np.stack([p.indices for p in plans])
    weights = np.stack([p.weights for p in plans])
    lengths = np.array([p.length for p in plans], np.int32)
    return indices, weights, lengths
