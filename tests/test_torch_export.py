"""The port's data preparation against the JAX package's: the files each
writes are byte for byte the same.

- the exporters (`data/export.py`): every cell format over the same
  samples, `export_dataset` with repeats and caps, `write_json` /
  `write_jsonl` (mirroring tests/test_chat_export.py);
- `create_llava_dataset` and `create_exports` (every format) over one
  $DATA_DIR tree holding all nine corpora's train splits, written by
  tests/test_torch_datasets.py's writers;
- `synth_cli filter-reports` and `generate-conversations --grounding` with
  the fake LLM client over that tree's MIMIC-CXR;
- `preprocess/dicom2jpg.convert_split` with a fake `pydicom` (MONOCHROME1
  inverted), and `preprocess/normalize_mscxr.convert`.
"""

import csv
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from radvlm_tpu.data import create_exports as jexports
from radvlm_tpu.data import create_llava_dataset as jllava
from radvlm_tpu.data import export as jexport
from radvlm_tpu.data import synth_cli as jsynth
from radvlm_tpu.data.preprocess import dicom2jpg as jdicom
from radvlm_tpu.data.preprocess import normalize_mscxr as jmscxr
from radvlm_tpu_torch.data import create_exports as texports
from radvlm_tpu_torch.data import create_llava_dataset as tllava
from radvlm_tpu_torch.data import export as texport
from radvlm_tpu_torch.data import synth_cli as tsynth
from radvlm_tpu_torch.data.preprocess import dicom2jpg as tdicom
from radvlm_tpu_torch.data.preprocess import normalize_mscxr as tmscxr
from test_torch_datasets import (
    write_chexpert,
    write_chexpert_plus,
    write_mimic,
    write_mimic_sidecars,
    write_padchest,
    write_vindr,
)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def same_tree(a, b):
    """Two directories hold the same files with the same bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b) and files(a)
    for rel in files(a):
        assert _bytes(os.path.join(a, rel)) == _bytes(os.path.join(b, rel)), rel


class FakeDS:
    """Single-turn samples (tests/test_chat_export.py's), with boxes."""

    def __len__(self):
        return 3

    def __getitem__(self, i):
        return {"img_path": f"/data/mimic/files/img{i}.jpg",
                "instr": {"question": f"Q{i}", "answer": f"A{i}"},
                "boxes": [[0.1234 * i, 0.2, 0.3, 0.4]]}


CONVERSATION = {"img_path": "/x/i.jpg",
                "conversation": [{"from": "human", "value": "hi"},
                                 {"from": "gpt", "value": "hello"}]}
CELLS = ("llava_cell", "vlmr1_cell", "qwen_cell", "verl_cell", "grpo_rec_cell")


@pytest.mark.parametrize("cell", CELLS)
def test_cells_and_export_equal_jax(cell, tmp_path):
    out = {}
    for tag, mod in (("port", texport), ("jax", jexport)):
        entries = [mod.MixtureEntry(FakeDS(), "mimic", repeats=2, max_samples=2),
                   mod.MixtureEntry(FakeDS(), "other", num_images=2)]
        cells = mod.export_dataset(entries, getattr(mod, cell), data_root="/data", num_workers=2)
        mod.write_json(cells, str(tmp_path / tag / "all.json"))
        mod.write_jsonl(cells, str(tmp_path / tag / "all.jsonl"))
        out[tag] = cells
    assert out["port"] == out["jax"] and len(out["port"]) == 7
    for name in ("all.json", "all.jsonl"):
        assert _bytes(tmp_path / "port" / name) == _bytes(tmp_path / "jax" / name)
    if cell == "llava_cell":  # tests/test_chat_export.py::test_llava_cell_and_export
        c = out["port"][0]
        assert c["image"] == "mimic/files/img0.jpg"
        assert c["conversations"][0]["value"] == "<image>\nQ0"
        assert out["port"][2]["id"] == "mimic_0_rep1"
        assert out["port"][4]["conversations"][0]["value"] == "<image>\n<image>\nQ0"


def test_conversation_cell_passthrough():
    for cell in ("llava_cell", "vlmr1_cell"):
        mine = getattr(texport, cell)(json.loads(json.dumps(CONVERSATION)), "c0")
        assert mine == getattr(jexport, cell)(json.loads(json.dumps(CONVERSATION)), "c0")
    assert texport.llava_cell(CONVERSATION, "c0")["conversations"][0]["value"] == "<image>\nhi"
    for mod in (texport, jexport):
        with pytest.raises(ValueError, match="neither"):
            mod.conversations_from_sample({"img_path": "/x.jpg"})


def test_grpo_rec_cell():
    sample = {"img_path": "/x/i.jpg", "instr": {"question": "Locate X", "answer": "ans"},
              "boxes": [[0.1234, 0.2, 0.3, 0.4], [0.555, 0.6666, 0.7, 0.81]]}
    c = texport.grpo_rec_cell(sample, "g0")
    assert c == jexport.grpo_rec_cell(sample, "g0")
    assert json.loads(c["solution"]) == {"bbox": [[0.12, 0.2, 0.3, 0.4], [0.56, 0.67, 0.7, 0.81]]}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A $DATA_DIR tree of the nine corpora the mixtures read, train splits."""
    root = str(tmp_path_factory.mktemp("data_dir"))
    side = os.path.join(root, "_side")
    rng = np.random.default_rng(0)
    mimic = f"{root}/MIMIC-CXR-JPG"
    write_mimic(mimic, rng)
    write_mimic_sidecars(side, rng)
    shutil.move(f"{side}/filtered", f"{mimic}/filtered_reports")
    shutil.copytree(f"{side}/convs", f"{mimic}/conversations/grounded")
    shutil.move(f"{side}/convs", f"{mimic}/conversations/standard")
    shutil.copytree(f"{side}/mscxr", f"{root}/MS-CXR/sentences_and_BBox_mscxr")
    shutil.move(f"{side}/mscxr", f"{root}/MS-CXR/sentences_BBox_mscxr")
    shutil.move(f"{side}/chestima", f"{root}/CHEST_IMA")
    shutil.rmtree(side)
    write_chexpert(f"{root}/CheXpert", rng)
    write_chexpert_plus(f"{root}/CheXpert-Plus", rng)
    shutil.move(f"{root}/CheXpert-Plus/filtered", f"{root}/CheXpert-Plus/filtered_reports")
    vindr = f"{root}/VinDr-CXR"
    write_vindr(vindr, rng)
    for a, b in (("annotations/annotations_test.csv", "annotations/annotations_train.csv"),
                 ("annotations/image_resolutions_test.json",
                  "annotations/image_resolutions_train.json"),
                 ("test_jpg", "train_jpg")):
        shutil.move(f"{vindr}/{a}", f"{vindr}/{b}")
    write_padchest(f"{root}/PadChest", rng)
    shutil.move(f"{root}/PadChest/convs", f"{root}/PadChest/conversations")
    return root


def test_create_llava_dataset_equals_jax(data_dir, tmp_path, monkeypatch):
    out = {t: str(tmp_path / t / "all_train.json") for t in ("port", "jax")}
    tllava.main(["--data-dir", data_dir, "--output", out["port"], "--num-workers", "2"])
    monkeypatch.setattr(sys, "argv", ["create_llava_dataset", "--data-dir", data_dir,
                                      "--output", out["jax"], "--num-workers", "2"])
    jllava.main()
    assert _bytes(out["port"]) == _bytes(out["jax"])
    cells = json.loads(_bytes(out["port"]))
    names = {c["id"].rsplit("_", 1)[0].split("_rep")[0] for c in cells}
    # every entry of the mixture gave cells
    assert len(tllava.build_mixture(data_dir)) == 12 and len(cells) > 12, names


@pytest.mark.parametrize("fmt", sorted(texports.CELL_FNS))
def test_create_exports_equals_jax(fmt, data_dir, tmp_path):
    ext = ".jsonl" if fmt != "llava" else ".json"
    out = {t: str(tmp_path / t / f"train{ext}") for t in ("port", "jax")}
    results = {}
    for tag, mod in (("port", texports), ("jax", jexports)):
        try:
            mod.main(["--data-dir", data_dir, "--format", fmt, "--output", out[tag],
                      "--num-workers", "2"])
            results[tag] = None
        except Exception as e:  # a format that needs what a mixture's sample lacks
            results[tag] = (type(e), str(e))
    assert results["port"] == results["jax"]
    if results["port"] is None:
        assert _bytes(out["port"]) == _bytes(out["jax"])
    assert fmt in ("qwen", "verl") or results["port"] is None  # instr-only formats may refuse


@pytest.fixture
def fake_client_env(data_dir):
    return ["--data-dir", data_dir, "--client", "fake", "--num-workers", "1"]


def test_synth_cli_filter_and_generate_equal_jax(data_dir, tmp_path, fake_client_env):
    for cmd, extra in (("filter-reports", []), ("generate-conversations", ["--grounding"])):
        for tag, mod in (("port", tsynth), ("jax", jsynth)):
            assert mod.main([cmd] + fake_client_env + extra
                            + ["--output-dir", str(tmp_path / cmd / tag)]) == 0
        same_tree(tmp_path / cmd / "port", tmp_path / cmd / "jax")


def test_dicom2jpg_with_fake_pydicom_equals_jax(tmp_path, monkeypatch):
    class FakeDataset:
        def __init__(self, path):
            seed = int(os.path.basename(path).split(".")[0].split("_")[-1])
            r = np.random.default_rng(seed)
            self.pixel_array = r.integers(0, 4096, size=(600, 500)).astype(np.uint16)
            self.PhotometricInterpretation = "MONOCHROME1" if seed % 2 else "MONOCHROME2"

    monkeypatch.setitem(sys.modules, "pydicom", types.SimpleNamespace(dcmread=FakeDataset))
    src = tmp_path / "dicoms"
    src.mkdir()
    for i in range(3):
        (src / f"img_{i}.dicom").write_bytes(b"\x00")
    res = {}
    for tag, mod in (("port", tdicom), ("jax", jdicom)):
        res[tag] = mod.convert_split(str(src), str(tmp_path / tag / "jpg"),
                                     str(tmp_path / tag / "res.json"), num_workers=1)
    assert res["port"] == res["jax"] == {f"img_{i}": [500, 600] for i in range(3)}
    same_tree(tmp_path / "port", tmp_path / "jax")
    # a second run converts nothing new and keeps the sidecar
    assert tdicom.convert_split(str(src), str(tmp_path / "port" / "jpg"),
                                str(tmp_path / "port" / "res.json"), num_workers=1) == res["jax"]


def test_normalize_mscxr_equals_jax(tmp_path):
    path = tmp_path / "ms_cxr.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dicom_id", "label_text", "x", "y", "w", "h", "image_width", "image_height"])
        w.writerows([["d1", "cardiomegaly", 100, 200, 300, 400, 1000, 1200],
                     ["d2", "left effusion", 10.5, 20, 30, 40.25, 512, 512],
                     ["d1", "right effusion", 0, 0, 50, 60, 1000, 1200]])
    n = {tag: mod.convert(str(path), str(tmp_path / tag))
         for tag, mod in (("port", tmscxr), ("jax", jmscxr))}
    assert n == {"port": 2, "jax": 2}
    same_tree(tmp_path / "port", tmp_path / "jax")
