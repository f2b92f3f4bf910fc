"""The port's lmms-eval shim (`radvlm_tpu_torch/training/eval_shim.py`):
command construction, results flattening and a launch through an injected
runner (lmms-eval itself never runs), as `tests/test_eval_shim.py` holds the
JAX package's; and the W&B callback (`training/wandb_logging.py`) with
`wandb` stubbed and absent."""

import json
import logging
import os
import sys
import time
import types

import pytest

from radvlm_tpu.training import eval_shim as jshim
from radvlm_tpu_torch.training import wandb_logging
from radvlm_tpu_torch.training.eval_shim import (
    LmmsEvalArgs,
    build_command,
    evaluate,
    find_results_file,
    parse_lmms_results,
)


@pytest.mark.parametrize("kw", [
    dict(model="llava_onevision", model_args="pretrained=/ckpt", task_names="mme,ai2d",
         batch_size=4, output_path="/tmp/out", limit=10, gen_kwargs="temperature=0"),
    dict(task_names="mme", limit=0, num_fewshot=0, eval_num_processes=4),
])
def test_build_command_equals_jax(kw):
    cmd = build_command(LmmsEvalArgs(**kw))
    assert cmd == jshim.build_command(jshim.LmmsEvalArgs(**kw))
    assert "--log_samples" in cmd
    assert cmd[cmd.index("--tasks") + 1] == kw["task_names"]
    if kw.get("eval_num_processes", 1) > 1:
        assert cmd[:4] == ["accelerate", "launch", "--num_processes", "4"]
        assert cmd[cmd.index("--limit") + 1] == "0"  # 0 is a limit, not "no limit"
    else:
        assert cmd[:3] == ["python", "-m", "lmms_eval"]


def test_parse_lmms_results_drops_alias_and_stderr():
    results = {"results": {
        "mme": {"alias": "MME", "mme_cognition_score,none": 300.0,
                "mme_cognition_score_stderr,none": 1.0},
        "ai2d": {"exact_match,flexible-extract": 0.5},
    }}
    out = parse_lmms_results(results, ["mme", "ai2d"])
    assert out == {"mme_mme_cognition_score": 300.0, "ai2d_exact_match": 0.5}
    assert out == jshim.parse_lmms_results(results, ["mme", "ai2d"])


def test_evaluate_with_an_injected_runner(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmms_eval", types.ModuleType("lmms_eval"))
    outdir = tmp_path / "res" / "run1"
    outdir.mkdir(parents=True)
    (outdir / "results.json").write_text(json.dumps(
        {"results": {"mme": {"score,none": 1.5, "alias": "x"}}}))
    calls = {}

    class Proc:
        returncode = 0
        stderr = ""

    def fake_run(cmd, capture_output, text):
        calls["cmd"] = cmd
        return Proc()

    args = LmmsEvalArgs(task_names="mme", output_path=str(tmp_path / "res"))
    assert evaluate(args, runner=fake_run) == {"mme_score": 1.5}
    assert calls["cmd"][calls["cmd"].index("--tasks") + 1] == "mme"

    class Failed(Proc):
        returncode, stderr = 2, "boom"

    with pytest.raises(RuntimeError, match="lmms-eval failed"):
        evaluate(args, runner=lambda cmd, capture_output, text: Failed())


def test_evaluate_without_the_tool_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmms_eval", None)
    with pytest.raises(RuntimeError, match="radvlm_tpu_torch.eval"):
        evaluate(LmmsEvalArgs(task_names="mme"), runner=lambda *a, **k: pytest.fail("ran"))


def test_find_results_file_picks_newest(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    (a / "results.json").write_text("{}")
    time.sleep(0.02)
    (b / "results.json").write_text("{}")
    os.utime(b / "results.json", None)
    assert find_results_file(str(tmp_path)).endswith("b/results.json")
    with pytest.raises(FileNotFoundError):
        find_results_file(str(tmp_path / "none"))


def test_wandb_callback_logs_through_a_stub(monkeypatch):
    """With a `wandb` module importable the callback opens one run with the
    project, name and config given, and logs each step's metrics."""
    logged, inits = [], []

    class Run:
        def log(self, metrics, step):
            logged.append((step, dict(metrics)))

    def init(project, name, config):
        inits.append((project, name, config))
        return Run()

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    cb = wandb_logging.make_wandb_callback(project="p", run_name="r", config={"lr": 1e-6})
    cb(3, {"loss": 0.5})
    cb(4, {"loss": 0.25, "kl": 0.01})
    assert inits == [("p", "r", {"lr": 1e-6})]
    assert logged == [(3, {"loss": 0.5}), (4, {"loss": 0.25, "kl": 0.01})]


def test_wandb_callback_without_wandb_is_a_no_op(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with caplog.at_level(logging.WARNING):
        cb = wandb_logging.make_wandb_callback()
    assert cb(1, {"loss": 1.0}) is None
    assert "wandb not installed" in caplog.text
