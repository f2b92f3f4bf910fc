"""Host-side multimodal batch assembly (numpy), the counterpart of
`radvlm_tpu/models/multimodal.py` for generation.

Per sample: text with <image> markers -> token ids with IMAGE_TOKEN_INDEX
sentinels; images -> anyres tiles + merge plans; sentinel expansion ->
tokens[L], img_src[L] (row into the sample's merged image tokens, -1 for
text), labels[L]. `collate` pads to static bucket shapes. `pack_samples`
(training) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from radvlm_tpu_torch.config import (
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    RadVLMConfig,
    feature_grid_side,
    tokens_per_tile,
)
from radvlm_tpu_torch.models.anyres import (
    MergePlan,
    compute_merge_plan,
    flat_tile_plan,
    max_merged_tokens,
)
from radvlm_tpu_torch.ops.image_ops import preprocess_anyres_host, preprocess_single_host


def tokenize_with_images(tokenize_fn, text: str) -> List[int]:
    """Split on <image> and splice IMAGE_TOKEN_INDEX between the chunks' ids."""
    chunks = text.split(DEFAULT_IMAGE_TOKEN)
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(IMAGE_TOKEN_INDEX)
        if chunk:
            ids.extend(tokenize_fn(chunk))
    return ids


@dataclasses.dataclass
class MMSample:
    """One preprocessed multimodal sample (numpy, unpadded except plan rows)."""

    tokens: np.ndarray  # [L] int32, image positions -> 0
    img_src: np.ndarray  # [L] int32, -1 for text
    labels: np.ndarray  # [L] int32
    tiles: np.ndarray  # [T, ts, ts, 3] uint8
    merge_indices: np.ndarray  # [N, 4] int32
    merge_weights: np.ndarray  # [N, 4] float32
    num_image_tokens: int
    tokens_per_tile: int = 729  # newline row sits at num_tiles * tokens_per_tile

    @property
    def length(self) -> int:
        return len(self.tokens)


def build_sample(
    token_ids: Sequence[int],
    images: Sequence[np.ndarray],
    cfg: RadVLMConfig,
    *,
    labels: Optional[Sequence[int]] = None,
    max_image_tokens: Optional[int] = None,
) -> MMSample:
    """Expand sentinels into image spans and build the sample-level merge plan."""
    anyres = cfg.anyres
    tps = feature_grid_side(cfg)
    tpt = tokens_per_tile(cfg)
    use_anyres = cfg.image_aspect_ratio.startswith("anyres")

    tiles_list: List[np.ndarray] = []
    plans: List[MergePlan] = []
    for img in images:
        if use_anyres:
            tiles, size = preprocess_anyres_host(img, anyres)
            plan = compute_merge_plan(size, anyres, tps)
        else:
            tiles, size = preprocess_single_host(img, anyres)
            plan = flat_tile_plan(tpt, tpt + 1, newline=anyres.newline)
        tiles_list.append(tiles)
        plans.append(plan)

    # Per-image plans shifted by tile offsets; one shared newline row at the
    # very end (row T_total * tpt).
    t_total = sum(t.shape[0] for t in tiles_list) if tiles_list else 0
    newline_row = t_total * tpt
    if max_image_tokens is None:
        per_img = max_merged_tokens(anyres, tps) if use_anyres else tpt + 1
        max_image_tokens = per_img * max(len(images), 1)
    merge_indices = np.full((max_image_tokens, 4), newline_row, np.int32)
    merge_weights = np.zeros((max_image_tokens, 4), np.float32)

    img_offsets: List[Tuple[int, int]] = []  # (merged row offset, length)
    tile_offset = 0
    row = 0
    for tiles, plan in zip(tiles_list, plans):
        n = plan.length
        idx = plan.indices[:n].copy()
        is_newline = idx == plan.num_tiles * tpt
        idx = idx + tile_offset * tpt
        idx[is_newline] = newline_row
        merge_indices[row : row + n] = idx
        merge_weights[row : row + n] = plan.weights[:n]
        img_offsets.append((row, n))
        row += n
        tile_offset += tiles.shape[0]

    out_tokens: List[int] = []
    out_src: List[int] = []
    out_labels: List[int] = []
    img_i = 0
    for pos, tok in enumerate(token_ids):
        if tok == IMAGE_TOKEN_INDEX:
            off, n = img_offsets[img_i]
            img_i += 1
            out_tokens.extend([0] * n)
            out_src.extend(range(off, off + n))
            out_labels.extend([IGNORE_INDEX] * n)
        else:
            out_tokens.append(int(tok))
            out_src.append(-1)
            out_labels.append(int(labels[pos]) if labels is not None else IGNORE_INDEX)
    if img_i != len(images):
        raise ValueError(
            f"prompt has {img_i} image sentinels but {len(images)} images given"
        )

    tiles_arr = (
        np.concatenate(tiles_list, axis=0)
        if tiles_list
        else np.zeros((1, anyres.tile_size, anyres.tile_size, 3), np.uint8)
    )
    return MMSample(
        tokens=np.asarray(out_tokens, np.int32),
        img_src=np.asarray(out_src, np.int32),
        labels=np.asarray(out_labels, np.int32),
        tiles=tiles_arr,
        merge_indices=merge_indices,
        merge_weights=merge_weights,
        num_image_tokens=row,
        tokens_per_tile=tpt,
    )


def collate(
    samples: Sequence[MMSample],
    *,
    pad_len: Optional[int] = None,
    pad_tiles: Optional[int] = None,
    pad_to_multiple: int = 128,
    left_pad: bool = False,
) -> Dict[str, np.ndarray]:
    """Pad and stack samples into a static-shape batch; left_pad=True aligns
    sequence ends for batched generation prefill. Packed samples (training)
    are not supported."""
    b = len(samples)
    L = max(s.length for s in samples)
    if pad_len is not None:
        L = max(L, pad_len)
    L = ((L + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    T = max(s.tiles.shape[0] for s in samples)
    if pad_tiles is not None:
        T = max(T, pad_tiles)
    N = max(s.merge_indices.shape[0] for s in samples)
    ts = samples[0].tiles.shape[1]

    tokens = np.zeros((b, L), np.int32)
    img_src = np.full((b, L), -1, np.int32)
    labels = np.full((b, L), IGNORE_INDEX, np.int32)
    segment_ids = np.zeros((b, L), np.int32)
    positions = np.zeros((b, L), np.int32)
    tiles = np.zeros((b, T, ts, ts, 3), samples[0].tiles.dtype)
    merge_indices = np.zeros((b, N, 4), np.int32)
    merge_weights = np.zeros((b, N, 4), np.float32)
    lengths = np.zeros((b,), np.int32)

    for i, s in enumerate(samples):
        n = s.length
        sl = slice(L - n, L) if left_pad else slice(0, n)
        tokens[i, sl] = s.tokens
        img_src[i, sl] = s.img_src
        labels[i, sl] = s.labels
        segment_ids[i, sl] = 1
        positions[i, sl] = np.arange(n)
        tiles[i, : s.tiles.shape[0]] = s.tiles
        # The sample's newline row (its own T * tpt) moves to the batch's
        # T * tpt, where apply_merge puts the newline after T tiles.
        nr = s.merge_indices.shape[0]
        idx = s.merge_indices.copy()
        idx[idx == s.tiles.shape[0] * s.tokens_per_tile] = T * s.tokens_per_tile
        merge_indices[i, :nr] = idx
        merge_weights[i, :nr] = s.merge_weights
        lengths[i] = n

    return {
        "tokens": tokens,
        "img_src": img_src,
        "labels": labels,
        "segment_ids": segment_ids,
        "positions": positions,
        "tiles": tiles,
        "merge_indices": merge_indices,
        "merge_weights": merge_weights,
        "lengths": lengths,
    }
