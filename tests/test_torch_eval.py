"""The port's evaluation path against the JAX package's at the tiny config.

- Metrics: each `evaluate_*` and `compute_scores` of both packages on the
  same seeded results agree to 1e-12 (ROUGE included); the port's numpy
  precision / recall / F1 equals sklearn's with `zero_division=0`, all-zero
  label and prediction matrices included.
- `run_task`: int8 weights (the JAX `quantize_params` output, brought over by
  `models/convert.py`), a byte tokenizer and greedy decoding, over fixture
  trees written by `tests/test_torch_datasets.py`'s writers. The continuous
  engine with the int8 and with the bf16 KV cache, and the static engine:
  the `_output.json` cells, sorted by `idx` (the engines finish requests in
  their own order), equal the JAX package's, and the metrics JSON agrees to
  1e-12. Images of several sizes, fill groups of 1.
- Errors: a sample with no `instr`, an engine error and a feeder error fail
  `run_task`; a fleet of TP engines (`fleet_tp`, `--fleet-tp`) outside
  torchrun's world raises naming torchrun; `eval.cli` without `--device` needs the card.
- `vqa_cli.run_vqa`: the JAX package's answers JSONL, record for record,
  except `shortuuid`.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from radvlm_tpu import config as cfglib
from radvlm_tpu.eval import harness as jh
from radvlm_tpu.eval import metrics as jm
from radvlm_tpu.eval import vqa_cli as jvqa
from radvlm_tpu.eval.metrics import radentity as jre
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch.eval import cli as tcli
from radvlm_tpu_torch.eval import harness as th
from radvlm_tpu_torch.eval import metrics as tm
from radvlm_tpu_torch.eval import vqa_cli as tvqa
from radvlm_tpu_torch.eval.metrics import classification as tcls
from radvlm_tpu_torch.eval.metrics import radentity as tre
from radvlm_tpu_torch.models import convert, quant_io
from test_torch_datasets import same, write_mimic, write_vindr

LABELS = ["atelectasis", "cardiomegaly", "edema", "pleural effusion", "support devices"]
WORDS = ("heart lungs clear effusion small left right no acute process stable "
         "cardiomegaly mild pleural lines tubes in place opacity").split()


def close(mine, theirs, tol=1e-12):
    assert list(mine) == list(theirs)
    for k in theirs:
        a, b = mine[k], theirs[k]
        if isinstance(b, dict):
            close(a, b, tol)
        else:
            assert abs(float(a) - float(b)) <= tol, (k, a, b)


def _text(r, n):
    return " ".join(r.choice(WORDS, size=n))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _box_results(r, n=12):
    out = []
    for i in range(n):
        gt = [sorted(r.uniform(0, 1, 2)) for _ in range(int(r.integers(1, 3)))]
        gt = [[a[0], b[0], a[1], b[1]] for a, b in zip(gt, gt[::-1])]
        preds = [[round(c + r.normal(0, 0.05), 2) for c in g] for g in gt[: int(r.integers(0, 3))]]
        text = "The box is " + ", ".join(
            "[" + ", ".join(f"{abs(c):.2f}" for c in p) + "]" for p in preds)
        out.append({"output": text, "boxes": gt})
    return out


@pytest.mark.parametrize("task", ["abnormality_grounding", "region_grounding",
                                  "phrase_grounding", "abnormality_detection"])
def test_box_metrics_equal_jax(task):
    results = _box_results(np.random.default_rng(1))
    close(tm.evaluate_results(task, results), jm.evaluate_results(task, results))
    kw = dict(iou_thresholds=[0.3, 0.5, 0.7], avg_iou=True)
    close(tm.evaluate_boxes(results, **kw), jm.evaluate_boxes(results, **kw))


def _class_results(r, kind):
    out = []
    for i in range(10):
        if kind == "none":  # all-zero labels and predictions
            gt, text = [], _text(r, 6)
        else:
            gt = [l for l in LABELS if r.random() < 0.4]
            pred = [l for l in LABELS if r.random() < (0.9 if kind == "all" else 0.4)]
            text = "Findings: " + ", ".join(p.title() for p in pred)
        out.append({"output": text, "labels": [g.title() for g in gt]})
    return out


@pytest.mark.parametrize("kind", ["random", "none", "all"])
def test_classification_metrics_equal_jax(kind):
    results = _class_results(np.random.default_rng(2), kind)
    mine = tm.evaluate_results("abnormality_classification", results, labels=LABELS)
    close(mine, jm.evaluate_results("abnormality_classification", results, labels=LABELS))
    if kind == "none":
        assert all(v == 0.0 for v in mine.values())


def test_numpy_prf_equals_sklearn():
    from sklearn.metrics import precision_recall_fscore_support

    r = np.random.default_rng(3)
    mats = [(r.random((9, 7)) < p, r.random((9, 7)) < q) for p, q in
            ((0.3, 0.3), (0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (1.0, 0.7))]
    for actual, predicted in mats:
        actual, predicted = actual.astype(np.int64), predicted.astype(np.int64)
        for average in ("micro", "macro", None):
            want = precision_recall_fscore_support(actual, predicted, average=average,
                                                   zero_division=0)[:3]
            got = tcls.precision_recall_f1(actual, predicted, average)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_clinical", [False, True])
def test_report_metrics_equal_jax(with_clinical):
    r = np.random.default_rng(4)
    refs = [_text(r, int(r.integers(4, 20))) + "." for _ in range(8)]
    hyps = [_text(r, int(r.integers(0, 20))) for _ in range(8)]
    results = [{"output": h, "txt": t} for h, t in zip(hyps, refs)]
    mine = tm.evaluate_results("report_generation", results, with_clinical=with_clinical)
    close(mine, jm.evaluate_results("report_generation", results, with_clinical=with_clinical))
    assert {"blue", "ciderd", "rouge1", "rouge2", "rougel"} <= set(mine)


def _entity_backends(sentence_cls):
    def ner(texts):
        return [[sentence_cls(tokens=s.split(), entities=[w for w in s.split() if len(w) > 4])
                 for s in t.lower().split(".") if s.strip()] for t in texts]

    def nli(premises, hypotheses):
        return [("entailment", "neutral", "contradiction")[(len(p) + len(h)) % 3]
                for p, h in zip(premises, hypotheses)]

    def sim(cands, refs):
        return [len(set(c.split()) & set(r.split())) / (1 + len(set(c.split()) | set(r.split())))
                for c, r in zip(cands, refs)]

    return dict(ner_fn=ner, nli_fn=nli, sim_fn=sim)


def test_compute_scores_equal_jax(tmp_path):
    r = np.random.default_rng(5)
    refs = [_text(r, 12) + ". " + _text(r, 6) + "." for _ in range(6)]
    refs[0] += " gallstones and the spleen is enlarged"
    hyps = [_text(r, 10) + ". " + _text(r, 5) for _ in range(6)]
    hyps[0] += " gallstones"
    corpus = [_text(r, 15) for _ in range(20)]
    names = ["BLEU", "CIDERD", "ciderdrl", "ROUGE1", "ROUGE2", "ROUGEL", "radentitymatchexact",
             "radentitynli", "stanford_ct_abd_accuracy"]
    out = {}
    for tag, m, sent in (("port", tm, tre.Sentence), ("jax", jm, jre.Sentence)):
        out[tag] = m.compute_scores(names, refs, hyps, corpus=corpus, seed=1, epoch=2,
                                    dump_dir=str(tmp_path / tag), **_entity_backends(sent))
    close(out["port"], out["jax"])
    for name in ("test_1_refs.txt", "test_1_hyps.txt", "test_1_metrics.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    logits = r.normal(size=(7, 4))
    ids = list(r.integers(0, 4, 7))
    assert tm.compute_scores(["accuracy"], ids, logits) == jm.compute_scores(["accuracy"], ids,
                                                                           logits)
    with pytest.raises(ValueError, match="not implemented"):
        tm.compute_scores(["nope"], refs, hyps)


# ---------------------------------------------------------------------------
# run_task
# ---------------------------------------------------------------------------


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


NEW = 6


@pytest.fixture(scope="module")
def tiny_q():
    cfg = cfglib.tiny_test_config()
    params = jrad.init_params(cfg, jax.random.key(11))
    return cfg, jax.tree.map(np.asarray, jquant.quantize_params(params))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eval_data"))
    rng = np.random.default_rng(7)
    write_mimic(f"{d}/MIMIC-CXR-JPG", rng)
    write_vindr(f"{d}/VinDr-CXR", rng)
    return d


def _runners(tiny_q, **kw):
    cfg, params = tiny_q
    common = dict(cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=NEW, batch_size=2,
                  pad_to_multiple=64, **kw)
    return (th.VLMRunner(model=convert.radvlm_from_jax(params, cfg, device="cpu"), **common),
            jh.VLMRunner(params=params, attn_impl="xla", **common))


def _read(out_dir, name, task):
    with open(os.path.join(out_dir, f"{name}_{task}_output.json")) as f:
        cells = json.load(f)
    with open(os.path.join(out_dir, f"{name}_{task}.json")) as f:
        return sorted(cells, key=lambda c: c["idx"]), json.load(f)


CASES = {  # id -> (task, engine, int8 KV cache)
    "classification_continuous_int8": ("abnormality_classification", "continuous", True),
    "grounding_continuous_int8": ("abnormality_grounding", "continuous", True),
    "grounding_continuous_bf16": ("abnormality_grounding", "continuous", False),
    "report_static": ("report_generation", "static", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_task_equals_jax(tiny_q, data_dir, tmp_path, case):
    task, engine, kv_quant = CASES[case]
    mine, theirs = _runners(tiny_q, kv_quant=kv_quant)
    stats = {}
    for tag, h, runner in (("port", th, mine), ("jax", jh, theirs)):
        dataset = h.build_task_dataset(task, data_dir)
        results, metrics = h.run_task(
            runner, dataset, task, output_dir=str(tmp_path / tag), model_name="tiny",
            with_clinical=False, engine=engine, **({"stats": stats} if tag == "port" else {}))
        assert len(results) == len(dataset) > 2
    cells, metrics = _read(tmp_path / "port", "tiny", task)
    want_cells, want_metrics = _read(tmp_path / "jax", "tiny", task)
    same(cells, want_cells, case)
    close(metrics, want_metrics)
    assert any(c["output"] for c in cells)
    for c in cells:
        for f in th.GT_FIELDS[task]:
            assert f in c
    if engine == "continuous":  # the engine's own counts, for the chip run's report
        assert stats["kv_quant"] is kv_quant and stats["host_stats"]["fills"] == len(cells)
        assert stats["build_s"] > 0 and stats["provenance"]["decode_matmul"] == "int8"


def test_result_cell_needs_instr():
    with pytest.raises(ValueError, match="no instr"):
        th._result_cell("x", {"idx": 0, "labels": []}, "abnormality_classification")
    cell = th._result_cell("out", {"idx": 3, "instr": {"question": "q", "answer": "a"},
                                   "boxes": [[0, 0, 1, 1]], "extra": 1}, "abnormality_grounding")
    assert cell == {"output": "out", "instr": "q", "answer": "a", "idx": 3,
                    "boxes": [[0, 0, 1, 1]], "label": None}


class _Broken:
    """A few samples, one of which fails to build."""

    def __init__(self, inner, bad):
        self.inner, self.bad = inner, bad

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError("unreadable image")
        return self.inner[i]


def test_engine_and_feeder_errors_fail_run_task(tiny_q, data_dir, monkeypatch):
    mine, _ = _runners(tiny_q, kv_quant=True)
    task = "abnormality_grounding"
    dataset = th.build_task_dataset(task, data_dir)
    real = th.multimodal.build_sample
    calls = []

    def feeder_breaks(*a, **kw):  # the sizing pass passes; the feeder's 3rd build fails
        calls.append(1)
        if len(calls) == len(dataset) + 3:
            raise OSError("unreadable image")
        return real(*a, **kw)

    monkeypatch.setattr(th.multimodal, "build_sample", feeder_breaks)
    with pytest.raises(OSError, match="unreadable"):
        th.run_task(mine, dataset, task, with_clinical=False)
    monkeypatch.setattr(th.multimodal, "build_sample", real)
    with pytest.raises(OSError, match="unreadable"):  # in the sizing pass
        th.run_task(mine, _Broken(dataset, 1), task, with_clinical=False)

    from radvlm_tpu_torch.generation.continuous import ContinuousBatcher

    def boom(self, *a, **kw):
        raise RuntimeError("injected engine fault")

    monkeypatch.setattr(ContinuousBatcher, "_dispatch_chunk", boom)
    with pytest.raises(RuntimeError, match="injected"):
        th.run_task(mine, dataset, task, with_clinical=False)
    for t in threading.enumerate():
        if t.name == "eval-feeder":
            t.join(timeout=30)
            assert not t.is_alive()


def test_not_ported_options_raise(tiny_q, monkeypatch, tmp_path):
    """A fleet of tensor-parallel engines runs one process a rank: in one
    process without torchrun's world it raises naming torchrun (the fleet
    itself runs in tests/test_torch_fleet_tp.py); a mesh and a fleet stay
    exclusive."""
    cfg, params = tiny_q
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        th.VLMRunner(model=model, cfg=cfg, tokenizer=ByteTokenizer(), fleet=2, fleet_tp=2)
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main(["--task", "abnormality_grounding", "--checkpoint", str(tmp_path),
                   "--device", "cpu", "--fleet", "2", "--fleet-tp", "2"])
    with pytest.raises(ValueError, match="exclusive"):
        th.VLMRunner(model=model, cfg=cfg, tokenizer=ByteTokenizer(), mesh=object(), fleet=2)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """An unfused int8 tiny model saved by `quant_io.save_quantized`."""
    from radvlm_tpu_torch import config as tcfg

    d = str(tmp_path_factory.mktemp("artifact"))
    cfg = tcfg.tiny_test_config()
    model = convert.random_quantized_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                                            dtype=torch.float32, fuse=False)
    quant_io.save_quantized(model, cfg, d)
    return d


def test_eval_cli_on_an_artifact(artifact, data_dir, tmp_path):
    d = artifact
    argv = ["--task", "abnormality_classification", "--checkpoint", d, "--data-dir", data_dir,
            "--output-dir", str(tmp_path), "--model-name", "tiny", "--batch-size", "2",
            "--max-new-tokens", "4", "--no-clinical"]
    metrics = tcli.main(argv + ["--device", "cpu"], tokenizer=ByteTokenizer())
    cells, saved = _read(tmp_path, "tiny", "abnormality_classification")
    assert len(cells) == 4 and set(saved) == set(metrics) >= {"F1 Score(micro)", *LABELS}
    with pytest.raises(RuntimeError, match="CUDA card"):  # no --device: the card
        tcli.main(argv, tokenizer=ByteTokenizer())


def _questions(img_dir):
    rng = np.random.default_rng(9)
    for i, size in enumerate([(48, 40), (40, 52), (56, 56)]):
        Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
    return [
        {"sample_id": "s0", "metadata": {"dataset": "fake", "question_type": "open-ended"},
         "image": ["0.png", "1.png"],
         "conversations": [{"from": "human", "value": "<image>\n<image>\nCompare."},
                           {"from": "gpt", "value": "gt one"},
                           {"from": "human", "value": "And the difference?"},
                           {"from": "gpt", "value": "gt two"}]},
        {"sample_id": "s1", "metadata": {"dataset": "fake", "question_type": "multi-choice"},
         "image": "2.png",
         "conversations": [{"from": "human", "value": "<image>\nWhat is shown? a: x b: y"},
                           {"from": "gpt", "value": "a: x"}]},
        {"sample_id": "s2", "image": [],
         "conversations": [{"from": "human", "value": "No image here."},
                           {"from": "gpt", "value": "ok"}]},
    ]


def test_run_vqa_equals_jax(tmp_path):
    cfg = cfglib.tiny_test_config(vocab_size=300)
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    common = dict(cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=4, batch_size=2,
                  pad_to_multiple=64)
    mine = th.VLMRunner(model=convert.radvlm_from_jax(params, cfg, device="cpu"), **common)
    theirs = jh.VLMRunner(params=params, attn_impl="xla", **common)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    questions = _questions(img_dir)
    records = {}
    for tag, mod, runner in (("port", tvqa, mine), ("jax", jvqa, theirs)):
        path = tmp_path / tag / "answers.jsonl"
        n = mod.run_vqa(runner, questions, image_folder=str(img_dir), answers_file=str(path),
                        model_id="tiny", max_new_tokens=4, extra_prompt="Answer: ")
        records[tag] = [json.loads(l) for l in path.read_text().splitlines()]
        assert n == len(records[tag]) == 4
    for a, b in zip(records["port"], records["jax"]):
        assert len(a.pop("shortuuid")) == len(b.pop("shortuuid")) == 22
        assert a == b
    assert [r["sample_id"] for r in records["port"]] == ["s0", "s1", "s2", "s0"]
    assert tvqa.split_list(list(range(10)), 4) == jvqa.split_list(list(range(10)), 4)
    for n, k in ((4, 3), (4, 2), (1, 0), (3, 5)):
        assert tvqa.get_chunk([1, 2], n, k) == jvqa.get_chunk([1, 2], n, k)


def test_vqa_cli_main_on_an_artifact(artifact, tmp_path, capsys):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    qfile = tmp_path / "questions.json"
    qfile.write_text(json.dumps(_questions(img_dir)))
    answers = tmp_path / "answers.jsonl"
    argv = ["--checkpoint", artifact, "--question-file", str(qfile), "--image-folder",
            str(img_dir), "--answers-file", str(answers), "--max-new-tokens", "3",
            "--batch-size", "2", "--num-chunks", "2", "--chunk-idx", "0", "--device", "cpu"]
    tvqa.main(argv, tokenizer=ByteTokenizer())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "written": 3, "answers_file": str(answers)}  # chunk 0 of 2: s0 (2 rounds), s1
    assert [json.loads(l)["sample_id"] for l in answers.read_text().splitlines()] == [
        "s0", "s1", "s0"]
