"""Export the RadVLM mixture to alternative training formats (the port's
copy of `radvlm_tpu/data/create_exports.py`; the files are byte for byte the
JAX module's).

Covers the reference's exporter family in one CLI (`create_vlmr1_*.py`,
`create_qwen_dataset.py`, `create_verl_dataset_llava.py`,
`make_grpo_rec_jsonl.py`):

    DATA_DIR=/data python -m radvlm_tpu_torch.data.create_exports \
        --format vlmr1 --output vlmr1_train.jsonl
    --format {llava, vlmr1, qwen, verl, grpo-rec}
    --tasks grounding   # restrict to grounding-style entries (GRPO REC)
"""

from __future__ import annotations

import argparse
import os

from radvlm_tpu_torch.data import datasets as ds
from radvlm_tpu_torch.data.create_llava_dataset import build_mixture
from radvlm_tpu_torch.data.export import (
    MixtureEntry,
    export_dataset,
    grpo_rec_cell,
    llava_cell,
    qwen_cell,
    verl_cell,
    vlmr1_cell,
    write_json,
    write_jsonl,
)

CELL_FNS = {
    "llava": llava_cell,
    "vlmr1": vlmr1_cell,
    "qwen": qwen_cell,
    "verl": verl_cell,
    "grpo-rec": grpo_rec_cell,
}


def grounding_mixture(data_dir: str):
    """Grounding-only mixture (the GRPO-REC / task-specific exporters)."""
    kw = dict(flag_img=False)
    entries = [
        MixtureEntry(
            ds.VinDrCXRSingleLabelDataset(
                os.path.join(data_dir, "VinDr-CXR"), split="train", **kw
            ),
            "vindr-mono",
        ),
        MixtureEntry(
            ds.MSCXRDataset(
                root=os.path.join(data_dir, "MIMIC-CXR-JPG"), split="train",
                sentences_bbox_dir=os.path.join(
                    data_dir, "MS-CXR", "sentences_BBox_mscxr"
                ),
                **kw,
            ),
            "mscxr",
        ),
        MixtureEntry(
            ds.PadChestGroundingDataset(
                os.path.join(data_dir, "PadChest"), split="train", **kw
            ),
            "padchest",
        ),
    ]
    return entries


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=os.environ.get("DATA_DIR"))
    p.add_argument("--format", required=True, choices=sorted(CELL_FNS))
    p.add_argument("--tasks", default="all", choices=["all", "grounding"])
    p.add_argument("--output", required=True)
    p.add_argument("--num-workers", type=int, default=32)
    args = p.parse_args(argv)
    if not args.data_dir:
        raise SystemExit("set --data-dir or $DATA_DIR")

    entries = (
        grounding_mixture(args.data_dir)
        if args.tasks == "grounding" or args.format == "grpo-rec"
        else build_mixture(args.data_dir)
    )
    cells = export_dataset(
        entries, CELL_FNS[args.format],
        data_root=args.data_dir, num_workers=args.num_workers,
    )
    if args.output.endswith(".jsonl"):
        write_jsonl(cells, args.output)
    else:
        write_json(cells, args.output)
    print(f"{args.format}: {len(cells)} cells -> {args.output}")


if __name__ == "__main__":
    main()
