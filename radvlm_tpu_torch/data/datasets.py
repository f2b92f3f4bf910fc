"""Dataset adapters for the public CXR corpora (the port's own copy of
`radvlm_tpu/data/datasets.py`).

The same adapters and the same sample-dict contract (`img_path`, `img`, `txt`,
`labels`, `boxes`, `label`, `instr`, `conversation`, `sentencesBBox`, `view`,
`gender`): for the same files and seed a sample here equals the JAX
package's key for key, images included.

The CSVs are read with the stdlib `csv` module, not pandas, so evaluation
runs where pandas is not installed. `read_csv` and `merge` keep what the
JAX package's pandas calls give a sample:

- a field that pandas reads as missing (empty, `NA`, `nan`, ...) is NaN;
- a column of integers is `int`, one of numbers (or integers with a gap) is
  `float`, any other is `str`;
- an inner merge keeps the left rows' order, each followed by its right
  matches in their order; a left merge keeps unmatched left rows with NaN;
  a column both sides have (not a key) becomes `<name>_x` / `<name>_y`;
- `groupby` runs over sorted keys and drops rows whose key is NaN.

Images load as uint8 HWC RGB through `data/loader.load_image`: PIL, or with
RADVLM_NATIVE_JPEG=1 the C++ libjpeg decoder (`radvlm_tpu_torch/native`), as
the JAX package's `load_image` does.

File-layout contracts (path names, CSV columns) follow the public datasets:
MIMIC-CXR (physionet), CheXpert(-Plus), Chest ImaGenome silver, VinDr-CXR,
MS-CXR sentence-bbox JSONs, PadChest-GR.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import random
import re
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from radvlm_tpu_torch.data import instructions as instr_lib
from radvlm_tpu_torch.data.loader import load_image
from radvlm_tpu_torch.data.wbf import fuse_annotator_boxes

DATA_DIR = os.environ.get("DATA_DIR")

CHEXPERT_PATHOLOGIES = sorted([
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity", "Lung Lesion",
    "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other",
    "Fracture", "Support Devices",
])

Sample = Dict[str, Any]
Row = Dict[str, Any]

# ---------------------------------------------------------------------------
# CSV tables (what the JAX package asks of pandas)
# ---------------------------------------------------------------------------

# pandas' default missing-value strings (`read_csv(na_values=None)`).
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT_RE = re.compile(r"[+-]?\d+\Z")
_FLOAT_RE = re.compile(
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z", re.I)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_NAN_KEY = object()  # pandas joins and groups NaN keys with each other


def isna(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _typed_column(cells: List[str]) -> List[Any]:
    present = [c for c in cells if c not in _NA_STRINGS]
    full = len(present) == len(cells)
    if present and all(_INT_RE.match(c) for c in present):
        conv: Callable[[str], Any] = int if full else float
    elif all(_FLOAT_RE.match(c) for c in present):  # all missing: float NaN
        conv = float
    elif present and all(c in _BOOLS for c in present):
        conv = _BOOLS.__getitem__
    else:
        conv = str
    return [math.nan if c in _NA_STRINGS else conv(c) for c in cells]


@dataclasses.dataclass
class Table:
    """A CSV as rows of {column: value}, in file order."""

    columns: List[str]
    rows: List[Row]

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        return [r[name] for r in self.rows]

    def filter(self, keep: Callable[[Row], bool]) -> "Table":
        return Table(self.columns, [r for r in self.rows if keep(r)])


def read_csv(path: str) -> Table:
    """A CSV with a header line, typed per column as pandas' `read_csv`
    types it (blank lines skipped, short rows padded with NaN)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        raw = [r for r in reader if r]
    cols = [_typed_column([r[j] if j < len(r) else "" for r in raw])
            for j in range(len(header))]
    return Table(list(header), [{name: col[i] for name, col in zip(header, cols)}
                                for i in range(len(raw))])


def _key(row: Row, cols: List[str]) -> tuple:
    return tuple(_NAN_KEY if isna(row[c]) else row[c] for c in cols)


def merge(left: Table, right: Table, *, on: Optional[List[str]] = None,
          left_on: Optional[str] = None, right_on: Optional[str] = None,
          how: str = "inner") -> Table:
    """`left.merge(right, ...)` with pandas' row order and column names."""
    lk = list(on) if on else [left_on]
    rk = list(on) if on else [right_on]
    shared = set(on or ())
    rcols = [c for c in right.columns if c not in shared]
    clash = (set(left.columns) - shared) & set(rcols)
    lname = {c: f"{c}_x" if c in clash else c for c in left.columns}
    rname = {c: f"{c}_y" if c in clash else c for c in rcols}
    by_key: Dict[tuple, List[Row]] = defaultdict(list)
    for r in right.rows:
        by_key[_key(r, rk)].append(r)
    rows, unmatched = [], False
    for l in left.rows:
        matches = by_key.get(_key(l, lk), [])
        if not matches and how == "left":
            matches, unmatched = [None], True
        for r in matches:
            row = {lname[c]: l[c] for c in left.columns}
            for c in rcols:
                row[rname[c]] = math.nan if r is None else r[c]
            rows.append(row)
    if unmatched:  # pandas turns an int column that gained a NaN into floats
        for c in rcols:
            if right.rows and all(type(r[c]) is int for r in right.rows):
                for row in rows:
                    row[rname[c]] = float(row[rname[c]])
    return Table([lname[c] for c in left.columns] + [rname[c] for c in rcols], rows)


def groupby(rows: List[Row], cols: List[str]) -> List[Tuple[tuple, List[Row]]]:
    """(key, rows) per group, keys sorted, NaN keys dropped (pandas'
    `groupby(cols)` defaults)."""
    groups: Dict[tuple, List[Row]] = defaultdict(list)
    for r in rows:
        key = tuple(r[c] for c in cols)
        if not any(isna(v) for v in key):
            groups[key].append(r)
    return sorted(groups.items(), key=lambda kv: kv[0])


def label_matrix(rows: List[Row], zero=None) -> np.ndarray:
    """`df.reindex(columns=CHEXPERT_PATHOLOGIES).fillna(0).replace(-1, 1)`
    as float32; `zero(row, pathology)` says where a value is first set to 0."""
    lab = np.zeros((len(rows), len(CHEXPERT_PATHOLOGIES)), np.float32)
    for i, r in enumerate(rows):
        for j, p in enumerate(CHEXPERT_PATHOLOGIES):
            v = 0 if zero is not None and zero(r, p) else r.get(p)
            v = 0 if isna(v) else v
            lab[i, j] = 1 if v == -1 else v
    return lab


def _rng_for(seed: int, idx: int) -> random.Random:
    return random.Random((seed << 20) ^ idx)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _listdir_stems(d: str, suffix: str) -> set:
    return {f[: -len(suffix)] for f in os.listdir(d) if f.endswith(suffix)}


class CXRDataset:
    """Base: len/getitem + shared flags."""

    flag_img: bool = True
    flag_instr: bool = True
    seed: int = 0

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Sample:
        raise NotImplementedError

    def _maybe_img(self, sample: Sample) -> None:
        if self.flag_img:
            sample["img"] = load_image(sample["img_path"])


# ---------------------------------------------------------------------------
# MIMIC-CXR family
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MIMICCXRDataset(CXRDataset):
    """MIMIC-CXR: reports + CheXpert labels.

    Expects under `root`: files/ (JPEGs p<xx>/p<subject>/s<study>/<dicom>.jpg),
    mimic-cxr-2.0.0-split.csv, mimic-cxr-2.0.0-chexpert.csv,
    mimic-cxr-2.0.0-metadata.csv, reports.csv (study, findings, impression,
    last_paragraph).
    """

    root: str
    split: str = "train"
    only_frontal: bool = False
    filtered_reports_dir: Optional[str] = None
    sentences_bbox_dir: Optional[str] = None
    conversation_dir: Optional[str] = None
    gender_json: Optional[str] = None
    classif: bool = False
    flag_img: bool = True
    flag_txt: bool = True
    flag_instr: bool = True
    flag_lab: bool = True
    seed: int = 0

    def __post_init__(self):
        split_name = {"train": "train", "valid": "validate", "test": "test"}
        if self.split not in split_name:
            raise ValueError(f"bad split {self.split!r}")

        meta = read_csv(os.path.join(self.root, "mimic-cxr-2.0.0-metadata.csv"))
        splitcsv = read_csv(os.path.join(self.root, "mimic-cxr-2.0.0-split.csv"))
        chexpert = read_csv(os.path.join(self.root, "mimic-cxr-2.0.0-chexpert.csv"))
        reports = read_csv(os.path.join(self.root, "reports.csv"))
        for r in reports.rows:
            r["study"] = int(str(r["study"]).lstrip("s"))

        df = merge(meta, splitcsv, on=["dicom_id", "subject_id", "study_id"])
        df = merge(df, chexpert, on=["subject_id", "study_id"], how="left")
        df = merge(df, reports, left_on="study_id", right_on="study")
        df = df.filter(lambda r: r["split"] == split_name[self.split])
        if self.only_frontal:
            df = df.filter(lambda r: r["ViewPosition"] in ("PA", "AP"))
        if self.filtered_reports_dir:
            have = _listdir_stems(self.filtered_reports_dir, ".txt")
            df = df.filter(lambda r: str(r["study_id"]) in have)
        if self.conversation_dir:
            have = _listdir_stems(self.conversation_dir, ".json")
            df = df.filter(lambda r: r["dicom_id"] in have)
        if self.sentences_bbox_dir:
            have = _listdir_stems(self.sentences_bbox_dir, ".json")
            df = df.filter(lambda r: r["dicom_id"] in have)

        # Label matrix: NaN->0, uncertain (-1)->1.
        self._labels = label_matrix(df.rows)
        self._df = df.rows
        self._genders = _read_json(self.gender_json) if self.gender_json else None

    def __len__(self) -> int:
        return len(self._df)

    def _img_path(self, row: Row) -> str:
        s = str(row["subject_id"])
        return os.path.join(
            self.root, "files", f"p{s[:2]}", f"p{s}",
            f"s{row['study_id']}", f"{row['dicom_id']}.jpg",
        )

    def _report_text(self, row: Row) -> str:
        if self.filtered_reports_dir:
            with open(
                os.path.join(self.filtered_reports_dir, f"{row['study_id']}.txt")
            ) as f:
                return f.read()
        # findings, else impression, else last paragraph.
        for col in ("findings", "impression", "last_paragraph"):
            v = row.get(col)
            if not isna(v) and v != 0:
                return str(v).replace("\n", "")
        return ""

    def __getitem__(self, idx: int) -> Sample:
        row = self._df[idx]
        rng = _rng_for(self.seed, idx)
        dicom_id = str(row["dicom_id"])
        sample: Sample = {
            "idx": idx,
            "study_id": str(row["study_id"]),
            "dicom_id": dicom_id,
            "img_path": self._img_path(row),
            "view": row.get("ViewPosition"),
            "gender": (self._genders or {}).get(dicom_id),
        }
        self._maybe_img(sample)
        if self.flag_txt or self.flag_instr:
            txt = self._report_text(row)
            if self.flag_txt:
                sample["txt"] = txt
            if self.flag_instr:
                sample["instr"] = instr_lib.report_generation(txt, rng)
        if self.flag_lab:
            lab = self._labels[idx]
            sample["labels"] = [
                p for p, v in zip(CHEXPERT_PATHOLOGIES, lab) if v == 1
            ]
            if self.flag_instr and self.classif:
                sample["instr"] = instr_lib.classification(sample["labels"], rng)
        if self.sentences_bbox_dir:
            p = os.path.join(self.sentences_bbox_dir, dicom_id + ".json")
            sample["sentencesBBox"] = _read_json(p) if os.path.exists(p) else None
        if self.conversation_dir:
            p = os.path.join(self.conversation_dir, dicom_id + ".json")
            if os.path.exists(p):
                sample["conversation"] = _read_json(p)
        return sample


@dataclasses.dataclass
class ChestImaGenomeDataset(MIMICCXRDataset):
    """Chest ImaGenome: MIMIC images + scene-graph anatomical region bboxes.
    `chestima_root` holds silver_dataset/{splits/*.csv, scene_graph/*_SceneGraph.json}."""

    chestima_root: str = ""
    pick_one_region: bool = True

    def __post_init__(self):
        super().__post_init__()
        splits = os.path.join(self.chestima_root, "silver_dataset", "splits")
        self._scene_dir = os.path.join(
            self.chestima_root, "silver_dataset", "scene_graph"
        )
        name = "valid" if self.split == "valid" else self.split
        ids = read_csv(os.path.join(splits, f"{name}.csv")).column("dicom_id")

        # Ids whose scene graph is missing, cached per split (a cache shared
        # by the splits would let one split's graph-less samples through).
        cache = os.path.join(
            self.chestima_root, "silver_dataset", f"missing_ids_{name}.json"
        )
        if os.path.exists(cache):
            missing = set(_read_json(cache))
        else:
            missing = {
                d for d in ids
                if not os.path.isfile(
                    os.path.join(self._scene_dir, f"{d}_SceneGraph.json")
                )
            }
            try:
                with open(cache, "w") as f:
                    json.dump(sorted(missing), f)
            except OSError:
                pass
        keep = set(ids) - missing
        mask = np.asarray([r["dicom_id"] in keep for r in self._df], bool)
        self._df = [r for r, k in zip(self._df, mask) if k]
        self._labels = self._labels[mask]

    def __getitem__(self, idx: int) -> Sample:
        sample = super().__getitem__(idx)
        rng = _rng_for(self.seed ^ 0x5EED, idx)
        row = self._df[idx]
        graph = _read_json(
            os.path.join(self._scene_dir, f"{row['dicom_id']}_SceneGraph.json")
        )
        w, h = float(row["Columns"]), float(row["Rows"])
        objs = graph.get("objects", [])

        def norm_box(o):
            return [
                float(o["original_x1"]) / w, float(o["original_y1"]) / h,
                float(o["original_x2"]) / w, float(o["original_y2"]) / h,
            ]

        if self.pick_one_region and objs:
            o = objs[rng.randrange(len(objs))]
            sample["boxes"] = [norm_box(o)]
            sample["label"] = o["bbox_name"]
            if self.flag_instr:
                sample["instr"] = instr_lib.region_location(
                    sample["label"], sample["boxes"], rng
                )
        else:
            sample["boxes"] = [norm_box(o) for o in objs]
            sample["region_names"] = [o["bbox_name"] for o in objs]
        sample["view"] = graph.get("viewpoint", sample.get("view"))
        sample["gender"] = graph.get("gender", sample.get("gender"))
        return sample


@dataclasses.dataclass
class MSCXRDataset(MIMICCXRDataset):
    """MS-CXR phrase grounding: one sample per (image, phrase), all boxes for the
    phrase grouped together."""

    def __post_init__(self):
        if not self.sentences_bbox_dir:
            raise ValueError("MSCXRDataset requires sentences_bbox_dir")
        super().__post_init__()
        self._flat: List[Dict[str, Any]] = []
        for row in self._df:
            dicom_id = str(row["dicom_id"])
            path = os.path.join(self.sentences_bbox_dir, dicom_id + ".json")
            if not os.path.exists(path):
                continue
            by_phrase: Dict[str, List] = defaultdict(list)
            for entry in _read_json(path):
                by_phrase[entry["observation"]].append(entry["box"])
            for phrase, boxes in by_phrase.items():
                self._flat.append({
                    "dicom_id": dicom_id,
                    "img_path": self._img_path(row),
                    "phrase": phrase,
                    "boxes": boxes,
                })

    def __len__(self) -> int:
        return len(self._flat)

    def __getitem__(self, idx: int) -> Sample:
        rec = self._flat[idx]
        rng = _rng_for(self.seed, idx)
        sample: Sample = {
            "img_path": rec["img_path"],
            "dicom_id": rec["dicom_id"],
            "boxes": rec["boxes"],
            "label": rec["phrase"],
            "sentencesBBox": [
                {"observation": rec["phrase"], "box": b} for b in rec["boxes"]
            ],
        }
        self._maybe_img(sample)
        if self.flag_instr:
            sample["instr"] = instr_lib.phrase_grounding(
                rec["phrase"], rec["boxes"], rng
            )
        return sample


# ---------------------------------------------------------------------------
# CheXpert family
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CheXpertDataset(CXRDataset):
    """CheXpert classification."""

    root: str
    split: str = "train"
    only_frontal: bool = True
    unique_patients: bool = False
    flag_img: bool = True
    flag_instr: bool = True
    flag_lab: bool = True
    seed: int = 0

    def __post_init__(self):
        csv_name = {"train": "train.csv", "valid": "valid.csv", "test": "test.csv"}
        if self.split not in csv_name:
            raise ValueError(f"bad split {self.split!r}")
        df = read_csv(os.path.join(self.root, csv_name[self.split]))
        if self.only_frontal:
            df = df.filter(lambda r: not isna(r["Path"])
                           and re.search(r"frontal\.jpg$", r["Path"]) is not None)
        rows = df.rows
        if self.unique_patients:
            # `groupby("PatientID").first()`: per column the group's first
            # non-NaN value, the key column first.
            for r in rows:
                m = None if isna(r["Path"]) else re.search(r"(patient\d+)", r["Path"])
                r["PatientID"] = m.group(1) if m else math.nan
            cols = ["PatientID"] + [c for c in df.columns if c != "PatientID"]
            rows = [
                {c: next((r[c] for r in grp if not isna(r[c])), math.nan) for c in cols}
                for _, grp in groupby(rows, ["PatientID"])
            ]
        # "No Finding"==1 rows: zero all pathologies except Support Devices,
        # then uncertain -1 -> positive.
        zero = None
        if "No Finding" in df.columns:
            def zero(r, p):
                return r["No Finding"] == 1 and p != "Support Devices"
        self._labels = label_matrix(rows, zero)
        self._df = rows

    def __len__(self) -> int:
        return len(self._df)

    def _img_path(self, row: Row) -> str:
        rel = str(row["Path"])
        for prefix in ("CheXpert-v1.0-small/", "CheXpert-v1.0/"):
            rel = rel.replace(prefix, "")
        return os.path.join(self.root, rel)

    def __getitem__(self, idx: int) -> Sample:
        row = self._df[idx]
        rng = _rng_for(self.seed, idx)
        sample: Sample = {"idx": idx, "img_path": self._img_path(row)}
        self._maybe_img(sample)
        labels = [
            p for p, v in zip(CHEXPERT_PATHOLOGIES, self._labels[idx]) if v == 1
        ]
        if self.flag_lab:
            sample["labels"] = labels
        if self.flag_instr:
            sample["instr"] = instr_lib.classification(labels, rng)
        return sample


@dataclasses.dataclass
class CheXpertPlusDataset(CXRDataset):
    """CheXpert-Plus report generation.

    Expects df_chexpert_plus_240401.csv + chexbert_labels/report_fixed.json
    (jsonl) under `root`.
    """

    root: str
    split: str = "train"
    only_frontal: bool = True
    filtered_reports_dir: Optional[str] = None
    flag_img: bool = True
    flag_txt: bool = True
    flag_instr: bool = True
    flag_lab: bool = True
    seed: int = 0

    def __post_init__(self):
        df = read_csv(os.path.join(self.root, "df_chexpert_plus_240401.csv"))
        if self.split == "train":
            df = df.filter(lambda r: r["split"] == "train")
        elif self.split == "test":
            df = df.filter(lambda r: r["split"] == "valid")  # test maps to the valid rows
        else:
            raise ValueError("CheXpertPlus supports splits 'train' and 'test'")
        if self.only_frontal and "frontal_lateral" in df.columns:
            df = df.filter(lambda r: r["frontal_lateral"] == "Frontal")
        if self.filtered_reports_dir:
            have = set(os.listdir(self.filtered_reports_dir))
            df = df.filter(
                lambda r: "_".join(str(r["path_to_image"]).split("/")[:3]) + ".txt" in have)
        self._df = df.rows
        self._labels: Dict[str, Dict] = {}
        labels_file = os.path.join(self.root, "chexbert_labels", "report_fixed.json")
        if os.path.exists(labels_file):
            with open(labels_file) as f:
                for line in f:
                    rec = json.loads(line)
                    self._labels[rec.pop("path_to_image")] = rec

    def __len__(self) -> int:
        return len(self._df)

    def __getitem__(self, idx: int) -> Sample:
        row = self._df[idx]
        rng = _rng_for(self.seed, idx)
        rel = str(row["path_to_image"])
        sample: Sample = {"idx": idx, "img_path": os.path.join(self.root, rel)}
        self._maybe_img(sample)
        if self.flag_txt or self.flag_instr:
            if self.filtered_reports_dir:
                name = "_".join(rel.split("/")[:3]) + ".txt"
                with open(os.path.join(self.filtered_reports_dir, name)) as f:
                    txt = f.read()
            else:
                parts = [
                    str(row[c]) for c in (
                        "section_findings", "section_impression",
                        "section_end_of_impression",
                    ) if c in row and not isna(row[c])
                ]
                txt = "".join(parts).capitalize().replace("\n", "")
            if self.flag_txt:
                sample["txt"] = txt
            if self.flag_instr:
                sample["instr"] = instr_lib.report_generation(txt, rng)
        if self.flag_lab:
            rec = self._labels.get(rel, {})
            sample["labels"] = [k for k, v in rec.items() if v == 1.0]
        return sample


# ---------------------------------------------------------------------------
# VinDr-CXR
# ---------------------------------------------------------------------------

_BOX_COLS = ["x_min", "y_min", "x_max", "y_max"]


def _vindr_load_fused(root: str, split: str):
    """Read annotations_{split}.csv + image_resolutions_{split}.json, WBF-fuse
    multi-radiologist boxes per (image, class) at iou 0.1 with normalized
    coords."""
    ann_dir = "annotations" if os.path.isdir(os.path.join(root, "annotations")) else ""
    res = _read_json(
        os.path.join(root, ann_dir, f"image_resolutions_{split}.json")
    )
    ann = read_csv(os.path.join(root, ann_dir, f"annotations_{split}.csv"))
    if "rad_ID" in ann.columns:
        for r in ann.rows:
            r["rad_id"] = r.pop("rad_ID")
        ann.columns = ["rad_id" if c == "rad_ID" else c for c in ann.columns]

    fused: Dict[str, List[Tuple[str, List[float]]]] = defaultdict(list)
    image_ids: List[str] = []
    seen: set = set()
    for (image_id, class_name), grp in groupby(ann.rows, ["image_id", "class_name"]):
        if image_id not in seen:  # `in fused` misses rows that never insert
            seen.add(image_id)
            image_ids.append(image_id)
        fused[image_id]  # touch: image exists even with no boxes
        if class_name == "No finding":
            continue
        w, h = res.get(image_id, [1024, 1024])
        sub = [r for r in grp if not any(isna(r[c]) for c in _BOX_COLS)]
        if not sub:
            continue
        raw = np.asarray([[r[c] for c in _BOX_COLS] for r in sub], float)
        norm = raw / np.asarray([w, h, w, h], float)
        # Per-annotator lists: WBF treats each outer list as one model.
        rads = [r["rad_id"] for r in sub] if "rad_id" in ann.columns else [0] * len(sub)
        boxes, _ = fuse_annotator_boxes(
            norm.tolist(), [0] * len(norm), rads, iou_thr=0.1
        )
        for b in np.asarray(boxes):
            fused[image_id].append((class_name, [round(float(c), 4) for c in b]))
    return fused, image_ids


@dataclasses.dataclass
class VinDrCXRDataset(CXRDataset):
    """VinDr-CXR multi-label abnormality detection: one sample per image, all
    fused (label, box) pairs."""

    root: str
    split: str = "train"
    flag_img: bool = True
    flag_instr: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.split not in ("train", "test"):
            raise ValueError("VinDr split must be train|test")
        self._fused, self._ids = _vindr_load_fused(self.root, self.split)

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, idx: int) -> Sample:
        image_id = self._ids[idx]
        rng = _rng_for(self.seed, idx)
        pairs = self._fused.get(image_id, [])
        boxes = [b for _, b in pairs]
        labels = [l for l, _ in pairs] or ["No finding"]
        sample: Sample = {
            "img_path": os.path.join(self.root, f"{self.split}_jpg", image_id + ".jpg"),
            "boxes": boxes,
            "labels": labels,
        }
        self._maybe_img(sample)
        if self.flag_instr:
            findings = [] if labels == ["No finding"] else list(zip(labels, boxes))
            sample["instr"] = instr_lib.abnormality_detection(findings, rng)
        return sample


@dataclasses.dataclass
class VinDrCXRSingleLabelDataset(CXRDataset):
    """VinDr-CXR per-(image,label) grounding samples."""

    root: str
    split: str = "train"
    flag_img: bool = True
    flag_instr: bool = True
    seed: int = 0

    def __post_init__(self):
        fused, ids = _vindr_load_fused(self.root, self.split)
        self._entries: List[Tuple[str, str, List[List[float]]]] = []
        for image_id in ids:
            by_label: Dict[str, List] = defaultdict(list)
            for label, box in fused.get(image_id, []):
                by_label[label].append(box)
            for label, boxes in by_label.items():
                self._entries.append((image_id, label, boxes))

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, idx: int) -> Sample:
        image_id, label, boxes = self._entries[idx]
        rng = _rng_for(self.seed, idx)
        sample: Sample = {
            "idx": idx,
            "img_path": os.path.join(self.root, f"{self.split}_jpg", image_id + ".jpg"),
            "label": label,
            "boxes": boxes,
        }
        self._maybe_img(sample)
        if self.flag_instr:
            sample["instr"] = instr_lib.abnormality_grounding(label, boxes, rng)
        return sample


# ---------------------------------------------------------------------------
# PadChest-GR
# ---------------------------------------------------------------------------


def _padchest_tables(root: str, split: str):
    if split == "valid":
        split = "validation"
    master = read_csv(os.path.join(root, "master_table.csv"))
    master = master.filter(lambda r: r["split"] == split)
    # `set_index(...)[col].to_dict()`: the last row of an id wins.
    gender = {r["ImageID"]: r["PatientSex_DICOM"] for r in master.rows}
    reports = read_csv(
        os.path.join(root, "PADCHEST_chest_x_ray_images_labels_160K_01.02.19.csv")
    )
    reports = reports.filter(lambda r: r["Projection"] in ("AP", "PA"))
    rep = {r["ImageID"]: r["Report"] for r in reports.rows}
    view = {r["ImageID"]: r["Projection"] for r in reports.rows}
    grounded = _read_json(os.path.join(root, "grounded_reports_20240819.json"))
    return gender, rep, view, grounded


@dataclasses.dataclass
class PadChestGroundingDataset(CXRDataset):
    """PadChest-GR per-finding phrase grounding."""

    root: str
    split: str = "train"
    flag_img: bool = True
    flag_instr: bool = True
    flag_txt: bool = True
    seed: int = 0

    def __post_init__(self):
        gender, rep, _, grounded = _padchest_tables(self.root, self.split)
        self._samples = []
        for entry in grounded:
            image_id = entry["ImageID"]
            if image_id not in gender or image_id not in rep:
                continue
            for finding in entry.get("findings", []):
                boxes = finding.get("boxes", [])
                if not boxes:
                    continue
                self._samples.append({
                    "img_path": os.path.join(self.root, "images_grounding", image_id),
                    "phrase": finding["sentence_en"],
                    "boxes": boxes,
                    "gender": gender[image_id],
                    "txt": rep.get(image_id, ""),
                })

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, idx: int) -> Sample:
        rec = self._samples[idx]
        rng = _rng_for(self.seed, idx)
        sample: Sample = {
            "img_path": rec["img_path"],
            "label": rec["phrase"],
            "boxes": rec["boxes"],
            "gender": rec["gender"],
        }
        if self.flag_txt:
            sample["txt"] = rec["txt"]
        self._maybe_img(sample)
        if self.flag_instr:
            sample["instr"] = instr_lib.phrase_grounding(
                rec["phrase"], rec["boxes"], rng
            )
        return sample


@dataclasses.dataclass
class PadChestGroundingPerImageDataset(CXRDataset):
    """PadChest-GR per-image samples with all (phrase, box) pairs + optional
    conversations."""

    root: str
    split: str = "train"
    conversation_dir: Optional[str] = None
    flag_img: bool = True
    flag_txt: bool = True
    flag_instr: bool = True
    seed: int = 0

    def __post_init__(self):
        gender, rep, view, grounded = _padchest_tables(self.root, self.split)
        per_image: Dict[str, List[Dict]] = defaultdict(list)
        for entry in grounded:
            image_id = entry["ImageID"]
            if image_id not in gender or image_id not in rep:
                continue
            for finding in entry.get("findings", []):
                for box in finding.get("boxes", []):
                    per_image[image_id].append(
                        {"observation": finding["sentence_en"], "box": box}
                    )
        self._samples = []
        for image_id, obs in per_image.items():
            conv_path = None
            if self.conversation_dir is not None:
                base, _ = os.path.splitext(image_id)
                conv_path = os.path.join(self.conversation_dir, base + ".json")
                if not os.path.exists(conv_path):
                    continue
            self._samples.append({
                "img_path": os.path.join(self.root, "images_grounding", image_id),
                "sentencesBBox": obs,
                "gender": gender[image_id],
                "view": view.get(image_id),
                "txt": rep.get(image_id, ""),
                "conversation_file": conv_path,
            })

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, idx: int) -> Sample:
        rec = self._samples[idx]
        sample: Sample = {
            "img_path": rec["img_path"],
            "sentencesBBox": rec["sentencesBBox"],
            "gender": rec["gender"],
            "view": rec["view"],
        }
        if self.flag_txt:
            sample["txt"] = rec["txt"]
        self._maybe_img(sample)
        if rec["conversation_file"]:
            sample["conversation"] = _read_json(rec["conversation_file"])
        return sample
