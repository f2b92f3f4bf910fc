"""Grounding visualizations: bbox overlays on CXR images (counterpart of
`radvlm_tpu/eval/plots.py`; `matplotlib` is imported where a plot is drawn).

Rebuild of `radvlm/evaluation/utils.py:56` plot_images_with_Bbox: renders
ground-truth (green) vs predicted (red) normalized boxes over the image and
saves a PNG per sample — the qualitative check used alongside mAP/IoU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def plot_boxes(
    image: np.ndarray,
    gt_boxes: Sequence[Sequence[float]],
    pred_boxes: Sequence[Sequence[float]],
    *,
    title: str = "",
    save_path: Optional[str] = None,
):
    """image: uint8 [H, W, 3]; boxes normalized [x1, y1, x2, y2]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    h, w = image.shape[:2]
    fig, ax = plt.subplots(figsize=(6, 6 * h / max(w, 1)))
    ax.imshow(image)
    for boxes, color, label in (
        (gt_boxes, "lime", "ground truth"),
        (pred_boxes, "red", "prediction"),
    ):
        for i, b in enumerate(boxes):
            x1, y1, x2, y2 = b[0] * w, b[1] * h, b[2] * w, b[3] * h
            ax.add_patch(patches.Rectangle(
                (x1, y1), x2 - x1, y2 - y1,
                linewidth=2, edgecolor=color, facecolor="none",
                label=label if i == 0 else None,
            ))
    if title:
        ax.set_title(title, fontsize=9)
    ax.legend(loc="lower right", fontsize=8)
    ax.axis("off")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_grounding_results(
    results: Sequence[Dict],
    dataset,
    output_dir: str,
    *,
    max_plots: int = 20,
) -> int:
    """Overlay plots for the first `max_plots` grounding results
    (eval-harness result cells + their dataset samples)."""
    from radvlm_tpu_torch.eval.metrics.boxes import extract_boxes

    n = 0
    for i, r in enumerate(results[:max_plots]):
        sample = dataset[i]
        img = sample.get("img")
        if img is None:
            continue
        plot_boxes(
            img,
            r.get("boxes") or [],
            extract_boxes(r["output"]),
            title=r.get("instr", {}).get("question", "")[:80],
            save_path=os.path.join(output_dir, f"grounding_{i}.png"),
        )
        n += 1
    return n
