"""The port's dataset adapters, WBF and instruction banks against the JAX
package's, on the same on-disk fixture trees.

The trees are written here with the stdlib `csv` module and PIL: a MIMIC-CXR
tree (with Chest ImaGenome and MS-CXR beside it), CheXpert, CheXpert-Plus,
VinDr-CXR and PadChest-GR. Each holds the cases the pandas calls of the JAX
adapters decide: rows of one key several times on either side of a merge, a
study with no CheXpert row and one with no report, missing and uncertain
labels, a missing view, report fallbacks, a column both merge sides have,
unsorted VinDr ids, NaN boxes, a resolution that is missing, decimals. Every
adapter of both packages then gives equal samples, key for key: `instr`
strings, `labels`, `boxes`, `txt`, ids, paths and the images exactly.
"""

import csv
import json
import math
import os
import random

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from radvlm_tpu.data import datasets as jds
from radvlm_tpu.data import instructions as jinstr
from radvlm_tpu.data import wbf as jwbf
from radvlm_tpu_torch.data import datasets as tds
from radvlm_tpu_torch.data import instructions as tinstr
from radvlm_tpu_torch.data import wbf as twbf

NAN = ""  # an empty CSV field: NaN to pandas and to the port


def _csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _jpg(path, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = int(rng.integers(24, 40)), int(rng.integers(24, 40))
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)


def _json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def same(a, b, where="sample"):
    """Deep equality: NaN equals NaN, arrays by dtype, shape and value, and a
    string never equals a number."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{where}: keys {list(a)} != {list(b)}"
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), f"{where}: {a!r} != {b!r}"
    else:
        assert isinstance(a, str) == isinstance(b, str) and a == b, f"{where}: {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# Fixture trees
# ---------------------------------------------------------------------------

SUBJECTS = {"d1": 10001234, "d2": 10001234, "d3": 10005678, "d4": 10005678,
            "d5": 11000001, "d6": 11000002, "d7": 12000003, "d8": 12000004, "d9": 13000005}
STUDIES = {"d1": 50001, "d2": 50002, "d3": 50003, "d4": 50003, "d5": 50005,
           "d6": 50006, "d7": 50007, "d8": 50008, "d9": 50009}


def write_mimic(root, rng):
    """MIMIC-CXR-JPG: d3 and d4 share a study; d6's study has no CheXpert
    row (left merge: NaN labels) and d9's no report (inner merge: dropped);
    the split file lists its rows in another order than the metadata."""
    views = {"d1": "PA", "d2": "LATERAL", "d3": "AP", "d4": NAN, "d5": "PA", "d6": "AP",
             "d7": "PA", "d8": "AP", "d9": "PA"}
    split = {"d1": "train", "d2": "train", "d3": "test", "d4": "test", "d5": "test",
             "d6": "test", "d7": "validate", "d8": "test", "d9": "test"}
    ids = list(SUBJECTS)
    _csv(f"{root}/mimic-cxr-2.0.0-metadata.csv",
         ["dicom_id", "subject_id", "study_id", "ViewPosition", "Rows", "Columns", "note"],
         [[d, SUBJECTS[d], STUDIES[d], views[d], 2500 + 10 * i, 3000 - 10 * i, "meta"]
          for i, d in enumerate(ids)])
    _csv(f"{root}/mimic-cxr-2.0.0-split.csv", ["dicom_id", "subject_id", "study_id", "split"],
         [[d, SUBJECTS[d], STUDIES[d], split[d]] for d in reversed(ids)])
    pathologies = ["Cardiomegaly", "Edema", "Pleural Effusion", "Support Devices", "No Finding"]
    chex = {50001: [1.0, NAN, NAN, NAN, NAN], 50002: [NAN, 1.0, 0.0, NAN, NAN],
            50003: [-1.0, NAN, 1.0, 1.0, NAN], 50005: [NAN, NAN, NAN, NAN, 1.0],
            50007: [0.0, -1.0, NAN, NAN, NAN], 50008: [1.0, 1.0, -1.0, 0.0, NAN],
            50009: [1.0, NAN, NAN, NAN, NAN]}
    _csv(f"{root}/mimic-cxr-2.0.0-chexpert.csv", ["subject_id", "study_id", "note"] + pathologies,
         [[s, st, "chex"] + v for st, v in chex.items()
          for s in {SUBJECTS[d] for d in ids if STUDIES[d] == st}])
    reports = [["s50001", "Heart is enlarged.", NAN, NAN],
               ["s50002", NAN, "Mild edema.", NAN],
               ["s50003", NAN, NAN, "Uncertain\ncardiomegaly."],
               ["s50005", "No acute process.", "Normal.", NAN],
               ["s50006", NAN, NAN, NAN],
               ["s50007", "NA", "Stable lines.", NAN],
               ["s50008", "Effusion, small.\nLines in place.", NAN, "x"]]
    _csv(f"{root}/reports.csv", ["study", "findings", "impression", "last_paragraph"], reports)
    for d in ids:
        s = str(SUBJECTS[d])
        _jpg(f"{root}/files/p{s[:2]}/p{s}/s{STUDIES[d]}/{d}.jpg", rng)


def write_mimic_sidecars(base, rng):
    """Filtered reports, conversations, sentence boxes, genders, and the
    Chest ImaGenome silver tree (d8's scene graph is missing)."""
    os.makedirs(f"{base}/filtered")
    for st in (50003, 50005, 50001):
        with open(f"{base}/filtered/{st}.txt", "w") as f:
            f.write(f"Filtered report {st}.")
    for d in ("d3", "d5", "d1"):
        _json(f"{base}/convs/{d}.json", [{"from": "human", "value": f"hi {d}"},
                                          {"from": "gpt", "value": "hello"}])
    _json(f"{base}/mscxr/d3.json", [
        {"observation": "enlarged cardiac silhouette", "box": [0.2, 0.3, 0.6, 0.7]},
        {"observation": "right pleural effusion", "box": [0.5, 0.6, 0.9, 0.95]},
        {"observation": "enlarged cardiac silhouette", "box": [0.1, 0.2, 0.3, 0.4]}])
    _json(f"{base}/mscxr/d8.json", [{"observation": "line", "box": [0.4, 0.1, 0.5, 0.3]}])
    _json(f"{base}/mscxr/d1.json", [{"observation": "heart", "box": [0.3, 0.3, 0.7, 0.8]}])
    _json(f"{base}/genders.json", {"d3": "M", "d5": "F"})
    ima = f"{base}/chestima/silver_dataset"
    for split, ds in (("test", ["d5", "d3", "d8", "d4", "d6"]), ("train", ["d1"])):
        _csv(f"{ima}/splits/{split}.csv", ["dicom_id", "subject_id", "study_id"],
             [[d, SUBJECTS[d], STUDIES[d]] for d in ds])
    for d in ("d1", "d3", "d4", "d5", "d6"):
        r = np.random.default_rng(int(d[1:]))
        objs = [{"bbox_name": name, "original_x1": int(r.integers(0, 900)),
                 "original_y1": int(r.integers(0, 900)), "original_x2": int(r.integers(1000, 2400)),
                 "original_y2": int(r.integers(1000, 2400))}
                for name in ("right lung", "cardiac silhouette", "left lung")[: 1 + int(d[1:]) % 3]]
        graph = {"objects": objs, "viewpoint": "PA"}
        if d != "d4":
            graph["gender"] = "F"
        _json(f"{ima}/scene_graph/{d}_SceneGraph.json", graph)


def write_chexpert(root, rng):
    paths = ["CheXpert-v1.0-small/train/patient3/study1/view1_frontal.jpg",
             "CheXpert-v1.0-small/train/patient1/study1/view1_frontal.jpg",
             "CheXpert-v1.0-small/train/patient1/study2/view1_lateral.jpg",
             "CheXpert-v1.0-small/train/patient1/study3/view1_frontal.jpg",
             "CheXpert-v1.0-small/train/patient2/study1/view1_frontal.jpg",
             "CheXpert-v1.0-small/train/patient2/study2/view2_frontal.jpg"]
    header = ["Path", "Sex", "Age", "No Finding", "Cardiomegaly", "Edema", "Support Devices",
              "Lung Opacity"]
    rows = [[paths[0], "Male", 50, NAN, -1.0, NAN, NAN, 1.0],
            [paths[1], "Female", 61, 1.0, 1.0, NAN, 1.0, NAN],
            [paths[2], "Female", 61, NAN, 1.0, 1.0, NAN, NAN],
            [paths[3], NAN, 62, NAN, NAN, -1.0, 0.0, 1.0],
            [paths[4], "Male", NAN, NAN, 0.0, 1.0, NAN, NAN],
            [paths[5], "Male", 70, 1.0, NAN, NAN, NAN, -1.0]]
    _csv(f"{root}/train.csv", header, rows)
    _csv(f"{root}/valid.csv", header, rows[:3])
    for p in paths:
        _jpg(f"{root}/{p.replace('CheXpert-v1.0-small/', '')}", rng)


def write_chexpert_plus(root, rng):
    paths = [f"train/patient{i}/study1/view1_frontal.jpg" for i in range(5)] + [
        "valid/patient9/study1/view1_frontal.jpg", "valid/patient9/study1/view2_lateral.jpg"]
    rows = [[paths[0], "train", "Frontal", "findings one.", "impression\none.", NAN],
            [paths[1], "train", "Lateral", "lateral.", NAN, NAN],
            [paths[2], "train", "Frontal", NAN, "only impression.", "end."],
            [paths[3], "train", "Frontal", NAN, NAN, NAN],
            [paths[4], "train", "Frontal", "FINDINGS four.", NAN, NAN],
            [paths[5], "valid", "Frontal", "valid findings.", "valid impression.", NAN],
            [paths[6], "valid", "Lateral", "valid lateral.", NAN, NAN]]
    _csv(f"{root}/df_chexpert_plus_240401.csv",
         ["path_to_image", "split", "frontal_lateral", "section_findings", "section_impression",
          "section_end_of_impression"], rows)
    os.makedirs(f"{root}/chexbert_labels")
    with open(f"{root}/chexbert_labels/report_fixed.json", "w") as f:
        for i, p in enumerate(paths[:6]):
            f.write(json.dumps({"path_to_image": p, "Edema": float(i % 2), "Cardiomegaly": 1.0,
                                "Fracture": None if i == 2 else 0.0}) + "\n")
    os.makedirs(f"{root}/filtered")
    for p in paths[:3]:
        with open(f"{root}/filtered/{'_'.join(p.split('/')[:3])}.txt", "w") as f:
            f.write(f"filtered {p}")
    for p in paths:
        _jpg(f"{root}/{p}", rng)


def write_vindr(root, rng):
    """Annotations in an unsorted image order, three radiologists (`rad_ID`),
    overlapping boxes to fuse, a NaN box, "No finding" rows, an image missing
    from the resolutions file, and decimal coordinates."""
    ann = [["imgC", "Cardiomegaly", "R2", 100.5, 120.25, 400.75, 410.0],
           ["imgA", "Cardiomegaly", "R1", 100.0, 100.0, 400.0, 400.0],
           ["imgA", "Cardiomegaly", "R2", 110.0, 100.0, 410.0, 400.0],
           ["imgA", "Pleural effusion", "R1", 500.0, 600.0, 800.0, 900.0],
           ["imgA", "Pleural effusion", "R3", 20.0, 30.0, 90.0, 95.5],
           ["imgA", "Aortic enlargement", "R3", 300.0, 200.0, 420.0, 330.0],
           ["imgB", "No finding", "R1", NAN, NAN, NAN, NAN],
           ["imgB", "No finding", "R2", NAN, NAN, NAN, NAN],
           ["imgC", "Cardiomegaly", "R1", 101.0, 119.0, 399.0, 411.0],
           ["imgC", "Nodule/Mass", "R3", NAN, 50.0, 60.0, 70.0],
           ["imgD", "Nodule/Mass", "R1", 700.0, 700.0, 760.0, 740.0],
           ["imgC", "Lung Opacity", "R1", 612.3, 233.9, 801.1, 499.7]]
    _csv(f"{root}/annotations/annotations_test.csv",
         ["image_id", "class_name", "rad_ID", "x_min", "y_min", "x_max", "y_max"], ann)
    _json(f"{root}/annotations/image_resolutions_test.json",
          {"imgA": [1000, 1000], "imgB": [1000, 1200], "imgC": [2048, 1792]})
    for i in ("imgA", "imgB", "imgC", "imgD"):
        _jpg(f"{root}/test_jpg/{i}.jpg", rng)


def write_padchest(root, rng):
    _csv(f"{root}/master_table.csv", ["ImageID", "split", "PatientSex_DICOM"],
         [["im1.png", "train", "F"], ["im2.png", "train", "M"], ["im3.png", "train", NAN],
          ["im4.png", "validation", "M"], ["im1.png", "train", "F"]])
    _csv(f"{root}/PADCHEST_chest_x_ray_images_labels_160K_01.02.19.csv",
         ["ImageID", "Projection", "Report"],
         [["im1.png", "PA", "cardiomegalia leve."], ["im2.png", "L", "otro."],
          ["im3.png", "AP", NAN], ["im4.png", "PA", "normal."]])
    _json(f"{root}/grounded_reports_20240819.json", [
        {"ImageID": "im1.png", "findings": [
            {"sentence_en": "mild cardiomegaly", "boxes": [[0.3, 0.4, 0.7, 0.8]]},
            {"sentence_en": "no boxes finding", "boxes": []},
            {"sentence_en": "two boxes", "boxes": [[0.1, 0.1, 0.2, 0.2], [0.5, 0.5, 0.6, 0.7]]}]},
        {"ImageID": "im2.png", "findings": [
            {"sentence_en": "something", "boxes": [[0.1, 0.1, 0.2, 0.2]]}]},
        {"ImageID": "im3.png", "findings": [
            {"sentence_en": "nodule", "boxes": [[0.2, 0.2, 0.25, 0.3]]}]},
        {"ImageID": "im4.png", "findings": [
            {"sentence_en": "valid one", "boxes": [[0.2, 0.2, 0.25, 0.3]]}]}])
    _json(f"{root}/convs/im1.json", [{"from": "human", "value": "hi"}])
    for i in ("im1.png", "im2.png", "im3.png", "im4.png"):
        _jpg(f"{root}/images_grounding/{i}", rng)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cxr"))
    rng = np.random.default_rng(0)
    write_mimic(f"{base}/mimic", rng)
    write_mimic_sidecars(base, rng)
    write_chexpert(f"{base}/chexpert", rng)
    write_chexpert_plus(f"{base}/chexpert_plus", rng)
    write_vindr(f"{base}/vindr", rng)
    write_padchest(f"{base}/padchest", rng)
    return base


def _all_samples(ds):
    return [ds[i] for i in range(len(ds))]


def _both(name, **kw):
    mine, theirs = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
    assert len(mine) == len(theirs) > 0
    a, b = _all_samples(mine), _all_samples(theirs)
    same(a, b, name)
    return a


MIMIC_CASES = {
    "train": dict(split="train"),
    "test": dict(split="test"),
    "valid": dict(split="valid", seed=3),
    "test_frontal_classif": dict(split="test", only_frontal=True, classif=True),
    "test_no_img_no_lab": dict(split="test", flag_img=False, flag_lab=False, seed=7),
    "filtered_reports": dict(split="test", filtered_reports_dir="{base}/filtered"),
    "conversations_genders": dict(split="test", conversation_dir="{base}/convs",
                                  gender_json="{base}/genders.json"),
    "sentence_boxes": dict(split="test", sentences_bbox_dir="{base}/mscxr", flag_txt=False),
}


@pytest.mark.parametrize("case", list(MIMIC_CASES))
def test_mimic_samples_equal_jax(trees, case):
    kw = {k: v.format(base=trees) if isinstance(v, str) and "{base}" in v else v
          for k, v in MIMIC_CASES[case].items()}
    samples = _both("MIMICCXRDataset", root=f"{trees}/mimic", **kw)
    if case == "test":  # the cases the fixture was written for
        by_dicom = {s["dicom_id"]: s for s in samples}
        assert "d9" not in by_dicom and "d2" not in by_dicom  # no report / not test
        assert by_dicom["d3"]["txt"] == "Uncertaincardiomegaly."  # last paragraph, newline cut
        assert by_dicom["d3"]["labels"] == ["Cardiomegaly", "Pleural Effusion", "Support Devices"]
        assert by_dicom["d6"]["labels"] == [] and by_dicom["d6"]["txt"] == ""
        assert isinstance(by_dicom["d4"]["view"], float)  # NaN view
        assert by_dicom["d3"]["img"].dtype == np.uint8


@pytest.mark.parametrize("pick_one", [True, False])
def test_chest_imagenome_samples_equal_jax(trees, pick_one):
    cache = f"{trees}/chestima/silver_dataset/missing_ids_test.json"
    kw = dict(root=f"{trees}/mimic", chestima_root=f"{trees}/chestima", split="test",
              pick_one_region=pick_one)
    caches = []
    for pkg in (jds, tds):  # each computes the missing-graph cache itself
        if os.path.exists(cache):
            os.remove(cache)
        pkg.ChestImaGenomeDataset(**kw)
        with open(cache) as f:
            caches.append(json.load(f))
    assert caches[0] == caches[1] == ["d8"]
    samples = _both("ChestImaGenomeDataset", **kw)
    assert {s["dicom_id"] for s in samples} == {"d3", "d4", "d5", "d6"}


def test_mscxr_samples_equal_jax(trees):
    samples = _both("MSCXRDataset", root=f"{trees}/mimic", split="test",
                    sentences_bbox_dir=f"{trees}/mscxr", seed=5)
    assert [s["label"] for s in samples] == [
        "enlarged cardiac silhouette", "right pleural effusion", "line"]


@pytest.mark.parametrize("kw", [dict(split="train"), dict(split="train", only_frontal=False),
                                dict(split="train", unique_patients=True),
                                dict(split="valid", flag_lab=False, seed=2)],
                         ids=["frontal", "all_views", "unique_patients", "valid"])
def test_chexpert_samples_equal_jax(trees, kw):
    _both("CheXpertDataset", root=f"{trees}/chexpert", **kw)


@pytest.mark.parametrize("kw", [dict(split="train"), dict(split="train", only_frontal=False),
                                dict(split="test"),
                                dict(split="train", filtered_reports_dir="filtered")],
                         ids=["frontal", "all_views", "test", "filtered"])
def test_chexpert_plus_samples_equal_jax(trees, kw):
    root = f"{trees}/chexpert_plus"
    if "filtered_reports_dir" in kw:
        kw = dict(kw, filtered_reports_dir=f"{root}/filtered")
    _both("CheXpertPlusDataset", root=root, **kw)


@pytest.mark.parametrize("name", ["VinDrCXRDataset", "VinDrCXRSingleLabelDataset"])
def test_vindr_samples_equal_jax(trees, name):
    samples = _both(name, root=f"{trees}/vindr", split="test", seed=1)
    if name == "VinDrCXRDataset":
        assert [os.path.basename(s["img_path"]) for s in samples] == [
            "imgA.jpg", "imgB.jpg", "imgC.jpg", "imgD.jpg"]  # groupby sorts the ids
        assert samples[1]["labels"] == ["No finding"]


@pytest.mark.parametrize("name,kw", [
    ("PadChestGroundingDataset", {}),
    ("PadChestGroundingDataset", dict(flag_txt=False, seed=4)),
    ("PadChestGroundingPerImageDataset", {}),
    ("PadChestGroundingPerImageDataset", dict(conversation_dir="convs")),
    ("PadChestGroundingDataset", dict(split="valid")),
], ids=["grounding", "grounding_no_txt", "per_image", "per_image_convs", "grounding_valid"])
def test_padchest_samples_equal_jax(trees, name, kw):
    root = f"{trees}/padchest"
    if "conversation_dir" in kw:
        kw = dict(kw, conversation_dir=f"{root}/convs")
    _both(name, root=root, **kw)


def test_read_csv_types_and_merge_order_match_pandas(tmp_path):
    """The port's `read_csv` / `merge` / `groupby` against pandas on one
    table: per-column types (int, float with a gap, str with a missing
    field, bool, an all-missing column, pandas' NA strings), the inner and
    left merges' row order with keys repeated on both sides and a column
    both sides have, and the sorted groups."""
    _csv(tmp_path / "l.csv", ["k", "a", "f", "s", "b", "e", "note"],
         [[2, 1, 1.5, "x", "True", NAN, "l0"], [1, 2, NAN, "NA", "False", NAN, "l1"],
          [2, 3, "2.25e1", "y,z", "True", NAN, "l2"], [3, -4, ".5", "null", NAN, NAN, "l3"],
          [NAN, 5, "-7", "w", "False", NAN, "l4"]])
    _csv(tmp_path / "r.csv", ["k", "v", "note"],
         [[1, 10, "r0"], [2, 20, "r1"], [2, 21, "r2"], [4, 40, "r3"], [NAN, 50, "r4"]])
    pl, pr = pd.read_csv(tmp_path / "l.csv"), pd.read_csv(tmp_path / "r.csv")
    ml, mr = tds.read_csv(str(tmp_path / "l.csv")), tds.read_csv(str(tmp_path / "r.csv"))

    def rows(df):
        return [{c: (v.item() if hasattr(v, "item") else v) for c, v in r.items()}
                for r in df.to_dict("records")]

    for mine, theirs in ((ml, pl), (mr, pr)):
        assert mine.columns == list(theirs.columns)
        same(mine.rows, rows(theirs), "read_csv")
    for how in ("inner", "left"):
        got = tds.merge(ml, mr, on=["k"], how=how)
        want = pl.merge(pr, on=["k"], how=how)
        assert got.columns == list(want.columns)
        same(got.rows, rows(want), f"merge {how}")
    got = tds.merge(ml, mr, left_on="a", right_on="k")
    want = pl.merge(pr, left_on="a", right_on="k")
    assert got.columns == list(want.columns)
    same(got.rows, rows(want), "merge left_on/right_on")
    groups = [(k[0], [r["note"] for r in g]) for k, g in tds.groupby(ml.rows, ["k"])]
    assert groups == [(float(k), list(g["note"])) for k, g in pl.groupby("k")]


def test_wbf_equals_jax():
    r = np.random.default_rng(3)
    for _ in range(20):
        n_models = int(r.integers(1, 4))
        boxes, scores, labels = [], [], []
        for _ in range(n_models):
            n = int(r.integers(0, 5))
            lo = r.uniform(0, 0.6, (n, 2))
            boxes.append(np.concatenate([lo, lo + r.uniform(0.05, 0.4, (n, 2))], 1).tolist())
            scores.append(r.uniform(0.1, 1.0, n).tolist())
            labels.append(r.integers(0, 2, n).tolist())
        for conf in ("avg", "max"):
            mine = twbf.weighted_boxes_fusion(boxes, scores, labels, iou_thr=0.3, conf_type=conf)
            theirs = jwbf.weighted_boxes_fusion(boxes, scores, labels, iou_thr=0.3, conf_type=conf)
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
        flat = [b for bs in boxes for b in bs]
        ann = [m for m, bs in enumerate(boxes) for _ in bs]
        lab = [0] * len(flat)
        for a, b in zip(twbf.fuse_annotator_boxes(flat, lab, ann),
                        jwbf.fuse_annotator_boxes(flat, lab, ann)):
            np.testing.assert_array_equal(a, b)


def test_instructions_equal_jax():
    """Every bank function of both packages, the same seeds: the same strings."""
    boxes = [[0.1234, 0.2, 0.5, 0.66], [0.3, 0.35, 0.9, 0.95]]
    calls = [
        ("report_generation", ("Heart is enlarged. ",), {}),
        ("report_generation", ("Befund.",), {"german_suffixe": True}),
        ("classification", (["Cardiomegaly", "Edema"],), {}),
        ("classification", (["No Finding"],), {}),
        ("region_location", ("right lung", boxes[:1]), {}),
        ("abnormality_grounding", ("Nodule/Mass", boxes), {}),
        ("abnormality_detection", ([("Cardiomegaly", boxes[0]), ("Effusion", boxes[1])],), {}),
        ("abnormality_detection", ([],), {}),
        ("phrase_grounding", ("small effusion", boxes), {}),
        ("foreign_objects", ([("pacemaker", boxes[0]), ("line", boxes[1])],), {}),
        ("foreign_objects", ([],), {}),
    ]
    for name, args, kw in calls:
        for seed in range(12):
            mine = getattr(tinstr, name)(*args, random.Random(seed), **kw)
            theirs = getattr(jinstr, name)(*args, random.Random(seed), **kw)
            assert mine == theirs, (name, seed)
    assert tinstr.format_boxes(boxes) == jinstr.format_boxes(boxes)
