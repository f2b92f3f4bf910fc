"""MS-CXR phrase-grounding CSV -> per-dicom sentence-BBox JSONs (the port's copy
of `radvlm_tpu/data/preprocess/normalize_mscxr.py`).

Rebuild of `radvlm/data/preprocess_scripts/normalize_mscxr.py`: the
MS_CXR_Local_Alignment CSV rows (x, y, w, h in pixels + image dims) become one
JSON per dicom_id of {"observation", "box": [xmin, ymin, xmax, ymax]} entries
with [0,1]-normalized corner coordinates — the format the MS-CXR dataset adapter
and the conversation synthesizer consume.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict
from typing import Dict, List


def normalize_rows(rows) -> Dict[str, List[dict]]:
    """CSV dict-rows -> {dicom_id: [{"observation", "box"}]}. (x,y,w,h) pixel
    boxes become normalized (xmin, ymin, xmax, ymax)."""
    out: Dict[str, List[dict]] = defaultdict(list)
    for row in rows:
        w_img = float(row["image_width"])
        h_img = float(row["image_height"])
        x, y = float(row["x"]), float(row["y"])
        w, h = float(row["w"]), float(row["h"])
        out[row["dicom_id"]].append({
            "observation": row["label_text"],
            "box": [x / w_img, y / h_img, (x + w) / w_img, (y + h) / h_img],
        })
    return dict(out)


def convert(csv_path: str, output_dir: str) -> int:
    os.makedirs(output_dir, exist_ok=True)
    with open(csv_path, newline="", encoding="utf-8") as f:
        grouped = normalize_rows(csv.DictReader(f))
    for dicom_id, entries in grouped.items():
        with open(os.path.join(output_dir, f"{dicom_id}.json"), "w") as f:
            json.dump(entries, f, indent=2)
    return len(grouped)


def main():
    parser = argparse.ArgumentParser()
    data_dir = os.environ.get("DATA_DIR", "")
    parser.add_argument(
        "--csv",
        default=os.path.join(data_dir, "MS-CXR", "MS_CXR_Local_Alignment_v1.0.0.csv"),
    )
    parser.add_argument(
        "--output-dir",
        default=os.path.join(data_dir, "MS-CXR", "sentences_BBox_mscxr"),
    )
    args = parser.parse_args()
    n = convert(args.csv, args.output_dir)
    print(f"wrote {n} dicom JSONs to {args.output_dir}")


if __name__ == "__main__":
    main()
