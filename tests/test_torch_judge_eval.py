"""The port's LLM-judged evaluation and synthesis front against the JAX
package's: chat templates, LLM clients, synthesis, conversation
evaluation, interleave scoring, the baselines' helpers, the LLaVA-Med remap
and the grounding plots.

- Every entry of `TEMPLATES` renders and `tokenize_chat_supervised`s
  exactly as the JAX package's does for the same turns (llama_2's system
  fold included).
- `filter_reports` / `generate_conversations` with `FakeLLMClient` write
  byte-equal files and send equal prompts; `LocalTorchClient` on a tiny
  Llama drives `filter_reports`.
- `green_batched` scores equal the JAX package's on canned responses.
- `evaluate_conversations`, `run_interleave` and `interleave.main` on a
  tiny port runner and a tiny JAX runner (the same weights through
  `models/convert.py`, greedy, byte tokenizer) give equal records and
  metrics, exactly.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from radvlm_tpu import config as jcfg
from radvlm_tpu.data import chat as jchat
from radvlm_tpu.data import llm_clients as jllm
from radvlm_tpu.data import synth as jsynth
from radvlm_tpu.eval import baselines as jbase
from radvlm_tpu.eval import conversations as jconv
from radvlm_tpu.eval import harness as jh
from radvlm_tpu.eval import interleave as jinter
from radvlm_tpu.eval import llavamed as jmed
from radvlm_tpu.eval.metrics import clinical as jclin
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch.data import chat as tchat
from radvlm_tpu_torch.data import llm_clients as tllm
from radvlm_tpu_torch.data import synth as tsynth
from radvlm_tpu_torch.eval import baselines as tbase
from radvlm_tpu_torch.eval import conversations as tconv
from radvlm_tpu_torch.eval import conversations_cli
from radvlm_tpu_torch.eval import harness as th
from radvlm_tpu_torch.eval import interleave as tinter
from radvlm_tpu_torch.eval import llavamed as tmed
from radvlm_tpu_torch.eval import plots as tplots
from radvlm_tpu_torch.eval import vqa_cli as tvqa
from radvlm_tpu_torch.eval.metrics import clinical as tclin
from radvlm_tpu_torch.models import convert, quant_io, safetensors_io
from test_torch_datasets import write_mimic
from test_torch_text_lm import write_llama

# ---------------------------------------------------------------------------
# Chat templates
# ---------------------------------------------------------------------------

TURNS = [("user", "<image>\nWhat is shown?"), ("assistant", "A chest X-ray."),
         ("user", "Any effusion?"), ("assistant", "No.")]


def _tokenize(text):
    return [3 + b for b in text.encode()]


@pytest.mark.parametrize("name", sorted(jchat.TEMPLATES))
def test_template_equals_jax(name):
    mine, theirs = tchat.TEMPLATES[name], jchat.TEMPLATES[name]
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for system in (None, "", "Be brief."):
        for gen in (False, True):
            kw = dict(system=system, add_generation_prompt=gen)
            assert mine.render(TURNS, **kw) == theirs.render(TURNS, **kw)
        assert tchat.render_generation_prompt(TURNS[:3], template=mine, system=system) == \
            jchat.render_generation_prompt(TURNS[:3], template=theirs, system=system)
        kw = dict(system=system)
        assert tchat.tokenize_chat_supervised(_tokenize, TURNS, template=mine, **kw) == \
            jchat.tokenize_chat_supervised(_tokenize, TURNS, template=theirs, **kw)
    if name == "llama_2":  # the system prompt is folded into the first user turn
        assert mine.render(TURNS[:1], system="S").startswith("<s>[INST] <<SYS>>\nS\n<</SYS>>")


# ---------------------------------------------------------------------------
# Clients, synthesis, GREEN
# ---------------------------------------------------------------------------


class ReportDS:
    def __init__(self):
        self.samples = [
            {"study_id": "s1", "img_path": "/x/a.jpg", "txt": "Compared to prior, stable.",
             "labels": ["Cardiomegaly", "Edema"], "view": "PA", "gender": "F",
             "sentencesBBox": [{"observation": "enlarged heart", "box": [0.3, 0.4, 0.7, 0.8]},
                               {"observation": "enlarged heart", "box": [0.1, 0.1, 0.2, 0.2]},
                               {"observation": "no box", "box": None}]},
            {"study_id": "s2", "img_path": "/x/b.jpg", "txt": None},
            {"study_id": "s3", "img_path": "/x/c.png", "txt": "Small effusion.", "labels": None,
             "view": "AP", "gender": "M", "sentencesBBox": None},
            {"study_id": "s4", "img_path": "/x/d.jpg", "txt": "None"},
            {"study_id": "s5", "img_path": "/x/e.jpg", "txt": "Lines in place.",
             "gender": None, "sentencesBBox": [{"observation": "x", "box": ["bad"]}]},
        ]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


CONV = [{"from": "human", "value": "What do you see?"},
        {"from": "gpt", "value": "Cardiomegaly at [0.30, 0.40, 0.70, 0.80]."}]


@pytest.mark.parametrize("pipeline", ["filter", "conversations", "grounded"])
def test_synth_with_fake_client_equals_jax(pipeline, tmp_path):
    out = {}
    for tag, synth, llm in (("port", tsynth, tllm), ("jax", jsynth, jllm)):
        client = llm.FakeLLMClient(
            responses={"Small effusion": "no array here"},
            default="Here:\n" + json.dumps(CONV) if pipeline != "filter" else "Clean report.",
            fail_first=1)
        d = str(tmp_path / tag)
        if pipeline == "filter":
            run = lambda: synth.filter_reports(ReportDS(), client, d, num_workers=1)
        else:
            run = lambda: synth.generate_conversations(
                ReportDS(), client, d, grounded=pipeline == "grounded", num_workers=1)
        # The first call fails: the second run writes that sample, the third nothing.
        out[tag] = ([run() for _ in range(3)], _files(d), client.calls)
    assert out["port"] == out["jax"]
    counts = out["port"][0]
    assert counts[0] >= 1 and counts[1] == 1 and counts[2] == 0


def test_pure_helpers_equal_jax():
    for text in ('junk [1, 2, {"a": 3}] trailing', "no array", None, "[broken", "]["):
        assert tllm.extract_json_array(text) == jllm.extract_json_array(text)
    for data in (ReportDS()[0]["sentencesBBox"], [], None, ReportDS()[4]["sentencesBBox"]):
        assert tsynth.format_sentences_bbox(data) == jsynth.format_sentences_bbox(data)
    for text in ("blah\nOverall score: 7/10", "Overall score: 8.5 / 10", "none", None):
        assert tconv.extract_judge_score(text) == jconv.extract_judge_score(text)
    assert tconv.JUDGE_PROMPT == jconv.JUDGE_PROMPT
    assert (tsynth.FILTER_REPORTS_PROMPT, tsynth.GROUNDED_CONVERSATION_PROMPT) == (
        jsynth.FILTER_REPORTS_PROMPT, jsynth.GROUNDED_CONVERSATION_PROMPT)


GREEN_RESPONSES = [
    "[Clinically Significant Errors]:\n(a) False report of a finding: 1\n(b) Missing a finding: 0"
    "\n(c) x: 2\n[Matched Findings]:\nMatched findings: 3",
    "Matched findings: 0",
    "nothing to parse",
    "(d) Misidentification: 4\n(f) Omitting comparison: 1",
]


def test_green_batched_equals_jax_on_canned_responses():
    refs = [f"ref {i}" for i in range(len(GREEN_RESPONSES))]
    hyps = [f"hyp {i}" for i in range(len(GREEN_RESPONSES))]
    seen = {}

    def judge(tag):
        def batch(prompts):
            seen[tag] = list(prompts)
            return GREEN_RESPONSES

        return batch

    mine = tclin.green_batched(refs, hyps, judge("port"))
    theirs = jclin.green_batched(refs, hyps, judge("jax"))
    assert mine == theirs and seen["port"] == seen["jax"]
    assert mine[1][2] is None and mine[1][0] is not None


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama_client")
    write_llama(path)
    return str(path)


def test_local_torch_client_drives_filter_reports(llama_dir, tmp_path):
    client = tllm.LocalTorchClient(llama_dir, template="llama_2", max_tokens=6, num_slots=2,
                                   device="cpu")
    try:
        assert isinstance(client.complete("Remove prior references: lungs clear."), str)
        batch = client.complete_batch(["a", "b", "c"])
        assert len(batch) == 3 and all(isinstance(t, str) for t in batch)
        samples = [{"study_id": f"s{i}", "txt": f"Report {i} with priors."} for i in range(3)]
        n = tsynth.filter_reports(samples, client, str(tmp_path / "filtered"), num_workers=3)
    finally:
        client.shutdown()
    # the byte tokenizer emits no "</s>" token: the template adds no eos id
    assert client.engine.eos == (client.engine.tokenizer.eos_token_id,)
    assert n == 3
    assert sorted(p.name for p in (tmp_path / "filtered").iterdir()) == [
        "s0.txt", "s1.txt", "s2.txt"]


# ---------------------------------------------------------------------------
# Conversations and interleave on tiny runners
# ---------------------------------------------------------------------------


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()][:48]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


@pytest.fixture(scope="module")
def runners():
    cfg = jcfg.tiny_test_config(vocab_size=300)
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    common = dict(cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=4, batch_size=1,
                  pad_to_multiple=64)
    return (th.VLMRunner(model=convert.radvlm_from_jax(params, cfg, device="cpu"), **common),
            jh.VLMRunner(params=params, attn_impl="xla", **common))


def _conv_samples():
    rng = np.random.default_rng(3)
    out = []
    for i, conv in enumerate((
            [{"from": "human", "value": "Any cardiomegaly?"}, {"from": "gpt", "value": "Mild."},
             {"from": "human", "value": "Where?"}, {"from": "gpt", "value": "[0.3, 0.4, 0.7, 0.8]"}],
            [{"from": "human", "value": "<image>\nEffusion?"}, {"from": "gpt", "value": "No."}],
            None)):
        out.append({"img": rng.integers(0, 255, (64, 48 + 8 * i, 3), dtype=np.uint8),
                    "conversation": conv})
    return out


class Judge:
    """A judge whose score depends on the candidate it is shown."""

    def __init__(self):
        self.calls = []

    def complete(self, prompt):
        self.calls.append(prompt)
        return f"ok\nOverall score: {len(prompt) % 11}/10" if len(self.calls) != 2 else "??"


def test_evaluate_conversations_equals_jax(runners, tmp_path):
    records, judges = {}, {}
    for tag, conv, runner in (("port", tconv, runners[0]), ("jax", jconv, runners[1])):
        judges[tag] = Judge()
        path = tmp_path / tag / "conv.json"
        metrics = conv.evaluate_conversations(runner, _conv_samples(), judges[tag],
                                              output_path=str(path))
        records[tag] = (metrics, json.loads(path.read_text()))
    assert records["port"] == records["jax"]
    assert judges["port"].calls == judges["jax"].calls and len(judges["port"].calls) == 2
    metrics, saved = records["port"]
    assert metrics["n"] == 1.0 and saved["records"][0]["candidate"].count("USER:") == 2


def test_conversations_cli_on_an_artifact(tmp_path):
    cfg = tcfg.tiny_test_config(vocab_size=300)
    model = convert.random_quantized_params(cfg,
                                            torch.Generator().manual_seed(3), device="cpu",
                                            dtype=torch.float32, fuse=False)
    art = str(tmp_path / "artifact")
    quant_io.save_quantized(model, cfg, art)
    data = tmp_path / "data"
    write_mimic(str(data / "MIMIC-CXR-JPG"), np.random.default_rng(5))
    conv_dir = data / "MIMIC-CXR-JPG" / "conversations" / "test" / "standard"
    conv_dir.mkdir(parents=True)
    for d in ("d3", "d5"):
        (conv_dir / f"{d}.json").write_text(json.dumps(_conv_samples()[0]["conversation"]))
    judge = Judge()
    out = tmp_path / "conv_eval.json"
    metrics = conversations_cli.main(
        ["--checkpoint", art, "--data-dir", str(data), "--max-new-tokens", "3", "--output",
         str(out), "--device", "cpu"], tokenizer=ByteTokenizer(), judge=judge)
    assert len(judge.calls) == 2 and metrics["n"] == 1.0
    assert json.loads(out.read_text())["n"] == 1


RESULTS = [
    {"sample_id": 0, "dataset": "vqa", "question_type": "open-ended", "gt_response": "a big heart",
     "pred_response": "the heart is big"},
    {"sample_id": 1, "dataset": "vqa", "question_type": "open-ended", "gt_response": "no",
     "pred_response": "No."},
    {"sample_id": 2, "dataset": "mc", "question_type": "multi-choice", "gt_response": "b",
     "pred_response": "B: something"},
    {"sample_id": 3, "dataset": "mc", "question_type": "multi-choice", "gt_response": "a",
     "pred_response": "answer: c"},
    {"sample_id": 4, "dataset": "nlrv2", "question_type": "open-ended", "gt_response": "a",
     "pred_response": "a"},
    {"sample_id": 5, "dataset": "COMICS_Panel", "gt_response": "c", "pred_response": "c: x"},
    {"sample_id": 6, "dataset": "odd", "question_type": "ranking", "gt_response": "1",
     "pred_response": "2"},
]


def test_interleave_scoring_equals_jax():
    assert tinter.evaluate_results(RESULTS) == jinter.evaluate_results(RESULTS)
    for fn in ("evaluate_rouge", "evaluate_multichoice"):
        assert getattr(tinter, fn)(RESULTS[:4]) == getattr(jinter, fn)(RESULTS[:4])
    for text in ("The  Cat, sat!", "An apple.", "b: the second", "answer: c", "banana"):
        assert tinter.normalize_answer(text) == jinter.normalize_answer(text)
        assert tinter.extract_choice(text) == jinter.extract_choice(text)


def test_run_interleave_equals_jax(runners):
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, (56, 56, 3), dtype=np.uint8) for _ in range(3)]
    samples = [{"prompt": "<image>\n<image>\nCompare.", "images": imgs[:2], "gt_response": "x",
                "dataset": "d", "question_type": "open-ended", "sample_id": "a"},
               {"prompt": "<image>\nWhich? a: x b: y", "images": imgs[2:], "gt_response": "a"}]
    mine = tinter.run_interleave(runners[0], samples, max_new_tokens=3)
    assert mine == jinter.run_interleave(runners[1], samples, max_new_tokens=3)
    assert [r["sample_id"] for r in mine] == ["a", 1]


def test_interleave_main_reads_the_vqa_cli_jsonl(runners, tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(9)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.png")
    questions = [
        {"sample_id": "s0", "metadata": {"dataset": "fake", "question_type": "open-ended"},
         "image": ["0.png", "1.png"],
         "conversations": [{"from": "human", "value": "<image>\n<image>\nCompare."},
                           {"from": "gpt", "value": "gt one"}]},
        {"sample_id": "s1", "metadata": {"dataset": "mc", "question_type": "multi-choice"},
         "image": "1.png",
         "conversations": [{"from": "human", "value": "<image>\nWhat? a: x b: y"},
                           {"from": "gpt", "value": "a"}]},
    ]
    answers = tmp_path / "answers.jsonl"
    tvqa.run_vqa(runners[0], questions, image_folder=str(img_dir), answers_file=str(answers),
                 model_id="tiny", max_new_tokens=3)
    outs = {}
    for tag, mod in (("port", tinter), ("jax", jinter)):
        out = tmp_path / f"{tag}.json"
        mod.main(["--result-file", str(answers), "--out", str(out)])
        outs[tag] = json.loads(out.read_text())
    assert outs["port"] == outs["jax"] and set(outs["port"]) == {"fake", "mc"}


# ---------------------------------------------------------------------------
# Baselines, LLaVA-Med, plots
# ---------------------------------------------------------------------------


def _maira_adjust(coord, *, width, height):
    return [coord[0] * 0.8 + 0.1, coord[1], coord[2] * 0.8 + width / (width + height), coord[3]]


HELPERS = {
    "vicuna_prompt": lambda m: [m.vicuna_v1_prompt("Describe."),
                                m.vicuna_v1_prompt("And?", chat_history=[("Hi", "Hello.")])],
    "mistral_prompt": lambda m: [m.mistral_instruct_prompt("Q1"),
                                 m.mistral_instruct_prompt("Q3", [("Q1", "A1"), ("Q2", "A2")])],
    "splice_image_sentinel": lambda m: [
        m.splice_image_sentinel(t, lambda s: [ord(c) for c in s])
        for t in ("ab<image>cd", "no image", "<image><image>x<image>")],
    "remap_to_uint8": lambda m: [
        m.remap_to_uint8(a, percentiles=p).tolist()
        for a, p in ((np.array([[10.0, 20.0], [30.0, 50.0]]), None),
                     (np.concatenate([np.full(98, 50.0), [0.0, 1000.0]]), (1, 99)),
                     (np.zeros((2, 2)), None))],
    "biovil_transform": lambda m: [
        m.biovil_chest_xray_transform(np.random.default_rng(s).integers(
            0, 255, size=shape, dtype=np.uint8)).tolist()
        for s, shape in ((0, (600, 480, 3)), (1, (300, 500)))],
    "chexagent_boxes": lambda m: [
        m.chexagent_boxes_to_text(t) for t in (
            "at <|box|> (12,30),(55,90) <|/box|> and <|box|> (5,5),(20,25) <|/box|>.", "none")],
    "maira2_boxes": lambda m: [
        m.maira2_boxes_to_text(b, _maira_adjust, width=1000, height=800)
        for b in ([[0.0, 0.25, 0.5, 0.75], None, [0.1, 0.2, 0.3, 0.4]], None, [])],
    "registry": lambda m: [sorted((k, c.__name__, c.name) for k, c in m.REGISTRY.items()),
                           m.VICUNA_SYSTEM, m.RaDialogBaseline.trim_output(" Report.</s> ")],
}


@pytest.mark.parametrize("helper", list(HELPERS))
def test_baseline_helpers_equal_jax(helper):
    assert HELPERS[helper](tbase) == HELPERS[helper](jbase)
    if helper == "registry":
        for mod in (tbase, jbase):
            with pytest.raises(ValueError, match="unknown baseline"):
                mod.load_baseline("nonesuch")


def test_llavamed_remap_and_splice_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    names = ["model.embed_tokens.weight", "model.layers.0.self_attn.q_proj.weight",
             "model.norm.weight", "lm_head.weight",
             "model.vision_tower.vision_tower.vision_model.embeddings.patch_embedding.weight",
             "model.mm_projector.0.weight", "model.mm_projector.2.bias", "other.thing"]
    sd = {n: torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)) for n in names}
    safetensors_io.write_file(sd, str(tmp_path / "model.safetensors"))
    mine = tmed.remap_state_dict(tmed._load_checkpoint_dir(str(tmp_path)))
    theirs = jmed.remap_state_dict(jmed._load_checkpoint_dir(str(tmp_path)))
    assert [sorted(d) for d in mine] == [sorted(d) for d in theirs]
    for a, b in zip(mine, theirs):
        for k in a:
            assert torch.equal(a[k], b[k])
    embed = torch.nn.Embedding(16, 4)
    feats = torch.randn(2, 3, 4)
    ids = torch.tensor([[1, -200, 5, 6, -200, 2]])
    for x, y in zip(tmed.splice_image_embeds(ids, embed, feats),
                    jmed.splice_image_embeds(ids, embed, feats)):
        assert torch.equal(x, y)
    hs = [torch.randn(1, 5, 4) for _ in range(3)]
    assert torch.equal(tmed.select_patch_features(hs), jmed.select_patch_features(hs))


def test_plot_grounding_results_writes_png(tmp_path):
    img = np.random.default_rng(1).integers(0, 255, (64, 80, 3), dtype=np.uint8)
    results = [{"output": "at [0.10, 0.20, 0.50, 0.60]", "boxes": [[0.1, 0.1, 0.4, 0.5]],
                "instr": {"question": "Where is the effusion?"}},
               {"output": "none", "boxes": []}]
    dataset = [{"img": img}, {"img": None}]
    n = tplots.plot_grounding_results(results, dataset, str(tmp_path / "plots"))
    assert n == 1
    with open(tmp_path / "plots" / "grounding_0.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
