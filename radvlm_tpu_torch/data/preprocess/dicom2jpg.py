"""VinDr-CXR DICOM -> JPEG conversion + resolution sidecar (the port's copy
of `radvlm_tpu/data/preprocess/dicom2jpg.py`).

Rebuild of `radvlm/data/preprocess_scripts/dicom2jpg_vindrcxr.py`: decode each
DICOM (pydicom, optional dependency — gated with a clear error), window to
uint8, resize so the short side is 512, save JPEG, and record the ORIGINAL
(width, height) per image_id into image_resolutions_{split}.json (the VinDr
adapters normalize the annotation boxes with these).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np


def dicom_to_uint8(path: str) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode one DICOM to a uint8 grayscale array; returns (img, (w, h))."""
    try:
        import pydicom
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "pydicom is required for DICOM conversion: pip install pydicom "
            "pylibjpeg pylibjpeg-libjpeg (not bundled in this image)"
        ) from e

    ds = pydicom.dcmread(path)
    arr = ds.pixel_array.astype(np.float32)
    # Photometric MONOCHROME1 is inverted.
    if getattr(ds, "PhotometricInterpretation", "") == "MONOCHROME1":
        arr = arr.max() - arr
    lo, hi = np.percentile(arr, 0.5), np.percentile(arr, 99.5)
    arr = np.clip((arr - lo) / max(hi - lo, 1e-6), 0, 1)
    img = (arr * 255).astype(np.uint8)
    h, w = img.shape[:2]
    return img, (w, h)


def convert_one(src: str, dst: str, *, short_side: int = 512) -> Tuple[int, int]:
    from PIL import Image

    img, (w, h) = dicom_to_uint8(src)
    pil = Image.fromarray(img).convert("RGB")
    scale = short_side / min(w, h)
    pil = pil.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    pil.save(dst, quality=95)
    return (w, h)


def _work_one(args, *, short_side: int):
    src, dst, image_id = args
    return image_id, convert_one(src, dst, short_side=short_side)


def convert_split(
    dicom_dir: str,
    out_dir: str,
    resolutions_path: str,
    *,
    short_side: int = 512,
    num_workers: int = 8,
    limit: Optional[int] = None,
) -> Dict[str, list]:
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(
        f for f in os.listdir(dicom_dir)
        if f.lower().endswith((".dicom", ".dcm"))
    )
    if limit:
        files = files[:limit]
    resolutions: Dict[str, list] = {}
    if os.path.exists(resolutions_path):
        with open(resolutions_path) as f:
            resolutions = json.load(f)

    todo = []
    for f in files:
        image_id = os.path.splitext(f)[0]
        dst = os.path.join(out_dir, image_id + ".jpg")
        if image_id in resolutions and os.path.exists(dst):
            continue
        todo.append((os.path.join(dicom_dir, f), dst, image_id))

    work = functools.partial(_work_one, short_side=short_side)
    if num_workers <= 1:
        # Serial path (also what tests with a mocked pydicom exercise —
        # subprocess workers would re-import the real module).
        for image_id, (w, h) in map(work, todo):
            resolutions[image_id] = [w, h]
    else:
        # NB: the worker must be a module-level function (+ partial) — a
        # nested closure is not picklable across the process pool.
        with ProcessPoolExecutor(max_workers=num_workers) as ex:
            for image_id, (w, h) in ex.map(work, todo):
                resolutions[image_id] = [w, h]

    with open(resolutions_path, "w") as f:
        json.dump(resolutions, f)
    return resolutions


def main():
    parser = argparse.ArgumentParser()
    data_dir = os.environ.get("DATA_DIR", "")
    parser.add_argument("--vindr-dir", default=os.path.join(data_dir, "VinDr-CXR"))
    parser.add_argument("--split", default="train", choices=["train", "test"])
    parser.add_argument("--short-side", type=int, default=512)
    parser.add_argument("--num-workers", type=int, default=8)
    args = parser.parse_args()
    res = convert_split(
        os.path.join(args.vindr_dir, args.split),
        os.path.join(args.vindr_dir, f"{args.split}_jpg"),
        os.path.join(
            args.vindr_dir, "annotations", f"image_resolutions_{args.split}.json"
        ),
        short_side=args.short_side,
        num_workers=args.num_workers,
    )
    print(f"{len(res)} images converted")


if __name__ == "__main__":
    main()
