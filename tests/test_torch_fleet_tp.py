"""A fleet of tensor-parallel engines (`serve/fleet.py::TPFleetEngine`) on
one spawn of four gloo ranks, two TP = 2 engines, at the tiny config (f32
weights, greedy, on the CPU), against one process:

- `FleetEngine(fleet_size=2, tp_size=2)` gives the JAX package's
  one-engine `ContinuousBatcher` tokens for every sample; the requests
  routed before `start` alternate between the engines (balanced within 1),
  both engines log busy windows, and the caller's Requests are the ones
  completed;
- `BatchWorker(fleet=2, fleet_tp=2)` answers blocking and streamed HTTP
  requests on rank 0 as the one-process worker does, with sessions off; the
  stop flag ends the other ranks' `serve_forever`;
- `run_task` over `VLMRunner(fleet=2, fleet_tp=2)` gives the one-process
  cells and metrics on every rank, and only rank 0 writes;
- a host-side fault injected into engine 1's ranks fails engine 1's
  requests loudly and counts toward its quarantine while engine 0
  completes its own; the world ends inside the spawn's time limit;
- `eval.cli --multihost --fleet 2 --fleet-tp 2` writes the one-process
  CLI's files (RADVLM_W8A8=0 on both sides: W8A8 on a row-parallel layer
  quantizes the rank's half of K).

The spawn runs on a thread while the JAX reference and the one-process
runs go on in the test process.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import torch_dist
from radvlm_tpu import config as jcfg
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.generation.engine import GenerationConfig as JGen
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.eval import cli as tcli
from radvlm_tpu_torch.eval import harness as th
from radvlm_tpu_torch.models import convert, quant_io
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from test_torch_datasets import write_vindr

STEPS = 5
LENGTHS = (6, 11, 8, 14, 7, 9)
N_EVAL = 11
WORKER_N, WORKER_NEW = 4, 6
SPAWN_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfg.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(7)))
    return cfg, params


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """An unfused int8 tiny artifact and a VinDr-CXR test split."""
    d = tmp_path_factory.mktemp("fleet_tp_cli")
    cfg = tiny_test_config()
    model = convert.random_quantized_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                                            dtype=torch.float32, fuse=False)
    quant_io.save_quantized(model, cfg, str(d / "artifact"))
    write_vindr(str(d / "data" / "VinDr-CXR"), np.random.default_rng(7))
    return str(d / "artifact"), str(d / "data")


@pytest.fixture(scope="module")
def world(tiny, cli_inputs, tmp_path_factory):
    """Rank r's results of every case, from one spawn of four ranks,
    started on a thread: wait for it with `world()`."""
    _, params = tiny
    tmp = tmp_path_factory.mktemp("fleet_tp")
    payload = dict(cfg=tiny_test_config(), params=params, steps=STEPS, lengths=LENGTHS,
                   worker_n=WORKER_N, worker_new=WORKER_NEW, n=N_EVAL, out=str(tmp),
                   artifact=cli_inputs[0], data_dir=cli_inputs[1],
                   cases=("fleet", "worker", "run_task", "error", "cli"))
    box = {}

    def spawn():
        try:
            box["ranks"] = torch_dist.run(torch_dist.tp_fleet_cases, 4, payload, tmp / "pg",
                                          timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=spawn)
    t.start()

    def wait():
        t.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    yield wait
    t.join()


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    cfg, params = tiny
    b = JBatcher(params, cfg, JGen(max_new_tokens=STEPS, eos_token_ids=()), **torch_dist.ENGINE)
    reqs = [b.submit(s) for s in torch_dist.samples(jmm, cfg, LENGTHS)]
    done = {r.uid: r.emitted for r in b.run()}
    return [done[r.uid] for r in reqs]


def _model(tiny):
    return convert.radvlm_from_jax(tiny[1], tiny_test_config(), device="cpu")


def test_tp_fleet_equals_one_engine(world, jax_tokens):
    ranks = world()
    r0 = ranks[0]["fleet"]
    assert r0["tokens"] == jax_tokens and r0["errors"] == [None] * len(LENGTHS)
    routed = r0["routed"]
    assert routed == [i % 2 for i in range(len(LENGTHS))]
    assert abs(routed.count(0) - routed.count(1)) <= 1
    assert r0["same_requests"] and r0["uids"] == list(range(1, len(LENGTHS) + 1))
    assert r0["busy"] == {0, 1}
    assert [r["fleet"]["engine"] for r in ranks] == [0, 0, 1, 1]
    cfg = tiny_test_config()
    assert {r["fleet"]["local_heads"] for r in ranks} == {cfg.text.num_heads // 2}
    # every rank of an engine filled that engine's requests, and no other
    assert [r["fleet"]["fills"] for r in ranks] == [routed.count(0)] * 2 + [routed.count(1)] * 2
    assert len({r["fleet"]["ticks"] for r in ranks}) == 1  # lockstep: the same ticks


def test_tp_fleet_batch_worker(world, tiny, monkeypatch):
    monkeypatch.setenv("RADVLM_SESSION_CAP", "0")
    runner = th.VLMRunner(model=_model(tiny), cfg=tiny_test_config(),
                          tokenizer=torch_dist.ByteTokenizer(), max_new_tokens=WORKER_NEW,
                          attn_impl="xla")
    one = BatchWorker(runner, model_names=["m"], num_slots=2, max_len=256, prompt_bucket=128,
                      pad_tiles=2)
    try:
        want = [one.generate(r) for r in torch_dist.worker_requests(WORKER_N, WORKER_NEW)]
    finally:
        one.shutdown()
    ranks = world()
    r0 = ranks[0]["worker"]
    assert r0["texts"] == want and r0["chunks"][0] >= 1
    assert all(r["worker"]["sessions_off"] for r in ranks)
    assert [r["worker"]["follows"] for r in ranks] == [False, True, True, True]
    assert all(r["worker"]["stopped"] for r in ranks[1:])


def test_tp_fleet_run_task(world, tiny):
    runner = th.VLMRunner(model=_model(tiny), cfg=tiny_test_config(),
                          tokenizer=torch_dist.ByteTokenizer(), max_new_tokens=4, batch_size=2,
                          attn_impl="xla")
    want_cells, want_metrics = th.run_task(runner, torch_dist.grounding_split(N_EVAL),
                                           "abnormality_grounding", with_clinical=False)
    ranks = world()
    for r in ranks:
        got = r["run_task"]
        assert sorted(got["results"], key=lambda c: c["idx"]) == sorted(
            want_cells, key=lambda c: c["idx"])
        assert got["metrics"] == want_metrics
    assert [r["run_task"]["wrote"] for r in ranks] == [True, False, False, False]
    assert ranks[0]["run_task"]["engines"] == 2


def test_tp_fleet_engine_fault_is_isolated(world, jax_tokens):
    """Engine 1's ranks raise in their step: its requests fail with the
    engine's error, engine 0's complete, and the world ends in time."""
    ranks = world()
    r0 = ranks[0]["error"]
    for i, (engine, toks, err) in enumerate(zip(r0["routed"], r0["tokens"], r0["errors"])):
        if engine == 1:
            assert err is not None and "engine 1 error: injected engine fault" in err
        else:
            assert err is None and toks == jax_tokens[i]
    assert r0["quarantine"] == [0, 1] and r0["busy"] == {0}


def test_tp_fleet_eval_cli(world, cli_inputs, tmp_path, monkeypatch):
    monkeypatch.setenv("RADVLM_W8A8", "0")
    artifact, data_dir = cli_inputs
    want = tcli.main(["--task", "abnormality_grounding", "--checkpoint", artifact,
                      "--data-dir", data_dir, "--output-dir", str(tmp_path), "--model-name",
                      "tiny", "--batch-size", "2", "--max-new-tokens", "4", "--no-clinical",
                      "--device", "cpu"], tokenizer=torch_dist.ByteTokenizer())
    ranks = world()
    assert all(r["cli"]["metrics"] == want for r in ranks)
    out = ranks[0]["cli"]["out_dir"]
    for name in ("tiny_abnormality_grounding_output.json", "tiny_abnormality_grounding.json"):
        with open(os.path.join(out, name)) as f, open(tmp_path / name) as g:
            got, ref = json.load(f), json.load(g)
        if isinstance(got, list):
            got, ref = (sorted(x, key=lambda c: c["idx"]) for x in (got, ref))
        assert got == ref
