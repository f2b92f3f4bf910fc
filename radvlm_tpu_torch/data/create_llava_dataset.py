"""Build the full RadVLM training mixture -> all_train.json (the port's copy
of `radvlm_tpu/data/create_llava_dataset.py`, over the port's dataset
adapters; the file is byte for byte the JAX module's).

Rebuild of `radvlm/data/create_llava_dataset.py`: constructs the 11 dataset
objects over $DATA_DIR and exports the 24-entry mixture (repeat factors for
balance: VinDr x2, VinDr-single x3, MS-CXR x3, PadChest x2, grounded
conversations x4, ChestImaGenome capped at 80k — `create_llava_dataset.py:213-318`)
as LLaVA-json cells. ~1.02M pairs on the full corpora (`README.md` dataset table).

Usage:
    DATA_DIR=/path/to/data python -m radvlm_tpu_torch.data.create_llava_dataset \
        --output llava_datasets/all_train.json
"""

from __future__ import annotations

import argparse
import os

from radvlm_tpu_torch.data import datasets as ds
from radvlm_tpu_torch.data.export import MixtureEntry, export_dataset, llava_cell, write_json


def build_mixture(data_dir: str):
    """The RadVLM training mixture (flags: no images loaded — export only needs
    instructions + paths)."""
    kw = dict(flag_img=False)
    mimic_root = os.path.join(data_dir, "MIMIC-CXR-JPG")
    entries = []

    # Abnormality grounding / detection (VinDr).
    vindr = ds.VinDrCXRDataset(os.path.join(data_dir, "VinDr-CXR"), split="train", **kw)
    vindr_mono = ds.VinDrCXRSingleLabelDataset(
        os.path.join(data_dir, "VinDr-CXR"), split="train", **kw
    )
    entries.append(MixtureEntry(vindr, "vindr-cxr-train", repeats=2))
    entries.append(MixtureEntry(vindr_mono, "vindr-cxr-mono-train", repeats=3))

    # Phrase grounding (MS-CXR x3, PadChest-GR x2).
    mscxr = ds.MSCXRDataset(
        root=mimic_root, split="train",
        sentences_bbox_dir=os.path.join(data_dir, "MS-CXR", "sentences_BBox_mscxr"),
        **kw,
    )
    entries.append(MixtureEntry(mscxr, "mscxr-train", repeats=3))
    padchest = ds.PadChestGroundingDataset(
        os.path.join(data_dir, "PadChest"), split="train", **kw
    )
    entries.append(MixtureEntry(padchest, "padchest-train", repeats=2))

    # Report generation (MIMIC filtered + CheXpert-Plus).
    mimic_reports = ds.MIMICCXRDataset(
        mimic_root, split="train", only_frontal=True,
        filtered_reports_dir=os.path.join(data_dir, "MIMIC-CXR-JPG", "filtered_reports"),
        flag_lab=False, **kw,
    )
    entries.append(MixtureEntry(mimic_reports, "mimic-train"))
    chexpertplus = ds.CheXpertPlusDataset(
        os.path.join(data_dir, "CheXpert-Plus"), split="train",
        filtered_reports_dir=os.path.join(
            data_dir, "CheXpert-Plus", "filtered_reports"
        ),
        **kw,
    )
    entries.append(MixtureEntry(chexpertplus, "chexpertplus-train"))

    # Anatomical grounding (ChestImaGenome, capped 80k).
    chestima = ds.ChestImaGenomeDataset(
        root=mimic_root, chestima_root=os.path.join(data_dir, "CHEST_IMA"),
        split="train", pick_one_region=True, **kw,
    )
    entries.append(MixtureEntry(chestima, "chestima-train", max_samples=80_000))

    # Abnormality classification (MIMIC labels + CheXpert).
    mimic_labels = ds.MIMICCXRDataset(
        mimic_root, split="train", only_frontal=True, classif=True, **kw
    )
    entries.append(MixtureEntry(mimic_labels, "mimic-labels-train"))
    chexpert = ds.CheXpertDataset(
        os.path.join(data_dir, "CheXpert"), split="train", **kw
    )
    entries.append(MixtureEntry(chexpert, "chexpert-train"))

    # Conversations (standard x1, grounded x4, PadChest grounded x4).
    conv_standard = ds.MIMICCXRDataset(
        mimic_root, split="train", only_frontal=True,
        conversation_dir=os.path.join(data_dir, "MIMIC-CXR-JPG", "conversations", "standard"),
        flag_lab=False, **kw,
    )
    entries.append(MixtureEntry(conv_standard, "conv-train"))
    conv_grounded = ds.MIMICCXRDataset(
        mimic_root, split="train", only_frontal=True,
        conversation_dir=os.path.join(data_dir, "MIMIC-CXR-JPG", "conversations", "grounded"),
        sentences_bbox_dir=os.path.join(data_dir, "MS-CXR", "sentences_BBox_mscxr"),
        flag_lab=False, **kw,
    )
    entries.append(MixtureEntry(conv_grounded, "conv-grounded-train", repeats=4))
    conv_padchest = ds.PadChestGroundingPerImageDataset(
        os.path.join(data_dir, "PadChest"), split="train",
        conversation_dir=os.path.join(data_dir, "PadChest", "conversations"),
        **kw,
    )
    entries.append(
        MixtureEntry(conv_padchest, "conv-grounded-padchest-train", repeats=4)
    )
    return entries


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=os.environ.get("DATA_DIR"))
    parser.add_argument(
        "--output",
        default=os.path.join(
            os.path.dirname(__file__), "llava_datasets", "all_train.json"
        ),
    )
    parser.add_argument("--num-workers", type=int, default=32)
    args = parser.parse_args(argv)
    if not args.data_dir:
        raise SystemExit("set --data-dir or $DATA_DIR")
    entries = build_mixture(args.data_dir)
    cells = export_dataset(
        entries, llava_cell, data_root=args.data_dir, num_workers=args.num_workers
    )
    write_json(cells, args.output)
    print(f"LLaVA dataset saved: {len(cells)} cells -> {args.output}")


if __name__ == "__main__":
    main()
