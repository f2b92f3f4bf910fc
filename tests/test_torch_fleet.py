"""The engine fleet (`serve/fleet.py`), the batch worker's and the
evaluation's fleets, and `run_task` across processes, at the tiny config
(f32 weights, greedy, on the CPU):

- a fleet of 2 engines on one device (devices may repeat) emits exactly
  one engine's tokens, under one uid stream, and the JAX `FleetEngine`'s
  (2 virtual CPU devices); its busy windows are logged per engine;
- an engine whose loop raises fails its own requests only; after
  QUARANTINE_AFTER failures it leaves the rotation, and with every engine
  quarantined submit raises;
- the device count is validated; a fleet of TP engines outside a world of
  fleet x tp ranks raises naming torchrun (the fleet of TP engines runs in
  tests/test_torch_fleet_tp.py), and a TP runner's worker takes no fleet;
- a keep_kv turn records the engine that cut it (`KVSnapshot.engine_idx`,
  carried through `to_numpy` / `from_numpy`), its resume goes back there,
  and the resumed tokens equal a full re-prefill's;
- `BatchWorker(fleet=2)` answers as the one-engine worker;
- `run_task` on 2 spawned gloo ranks (each its DistributedSampler share,
  gathered with `all_gather_object`, rank 0 writes the files), on the 2
  ranks as one TP engine (`VLMRunner(mesh=)`, more samples than the
  in-flight cap) and with `fleet=2` give the one-process cells and metrics;
- in the same spawn, a BatchWorker over the TP runner (a fleet of one TP
  engine) answers HTTP on rank 0 as the one-process worker does, with
  sessions off, and its stop flag ends rank 1's `serve_forever`.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_dist
from radvlm_tpu import config as jcfg
from radvlm_tpu.generation.engine import GenerationConfig as JGen
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.serve.fleet import FleetEngine as JFleet
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.eval import harness as th
from radvlm_tpu_torch.generation.continuous import KVSnapshot
from radvlm_tpu_torch.generation.engine import GenerationConfig
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.serve import fleet as fleet_lib
from radvlm_tpu_torch.serve.batch_worker import BatchWorker
from radvlm_tpu_torch.serve.fleet import FleetEngine

STEPS = 5
LENGTHS = (6, 11, 8, 14, 7)
ENGINE = dict(torch_dist.ENGINE, steps_per_sync=2)


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfg.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(7)))
    return tiny_test_config(), params


def _model(tiny):
    cfg, params = tiny
    return convert.radvlm_from_jax(params, cfg, device="cpu")


def _gen():
    return GenerationConfig(max_new_tokens=STEPS, eos_token_ids=())


def _fleet_tokens(fleet, cfg):
    reqs = [fleet.submit(s) for s in torch_dist.samples(tmm, cfg, LENGTHS)]
    done = {r.uid: r for r in fleet.drain(idle_timeout=120)}
    return [done[r.uid].emitted for r in reqs], [done[r.uid].error for r in reqs]


def test_fleet_of_two_equals_one_engine(tiny):
    cfg, params = tiny
    one, _ = torch_dist.engine_tokens(_model(tiny), cfg, _gen(),
                                      torch_dist.samples(tmm, cfg, LENGTHS), steps_per_sync=2)
    fleet = FleetEngine(_model(tiny), cfg, _gen(), fleet_size=2, devices=["cpu", "cpu"],
                        **ENGINE).start()
    try:
        got, errors = _fleet_tokens(fleet, cfg)
    finally:
        fleet.shutdown()
    assert got == one and errors == [None] * len(LENGTHS)
    assert fleet.batchers[0].model is fleet.batchers[1].model  # one device, one copy
    assert {i for i, _, _ in fleet.busy_log} == {0, 1}
    assert sum(b.host_stats["fills"] for b in fleet.batchers) == len(LENGTHS)
    jcfg_ = jcfg.tiny_test_config()
    jf = JFleet(params, jcfg_, JGen(max_new_tokens=STEPS, eos_token_ids=()), fleet_size=2,
                **ENGINE).start()
    try:
        reqs = [jf.submit(s) for s in torch_dist.samples(jmm, jcfg_, LENGTHS)]
        done = {r.uid: r.emitted for r in jf.drain(idle_timeout=300)}
    finally:
        jf.shutdown()
    assert [done[r.uid] for r in reqs] == one


def test_fleet_error_isolation_and_quarantine(tiny, monkeypatch):
    cfg, _ = tiny
    fleet = FleetEngine(_model(tiny), cfg, _gen(), devices=["cpu", "cpu"], **ENGINE)
    broken = fleet.batchers[0]

    def boom(*a, **kw):
        raise RuntimeError("injected engine fault")

    monkeypatch.setattr(broken, "_dispatch_chunk", boom)
    fleet.start()
    try:
        samples = torch_dist.samples(tmm, cfg, LENGTHS)
        req0 = fleet.submit(samples[0])  # both idle: engine 0 takes it
        done = {r.uid: r for r in fleet.drain(idle_timeout=60)}
        assert "engine 0 error: injected" in done[req0.uid].error and done[req0.uid].done
        while fleet._errors[0] < fleet_lib.QUARANTINE_AFTER:
            r = broken.submit(samples[1])  # straight to the broken engine
            with fleet._lock:
                fleet._pending_n += 1
            list(fleet.drain(idle_timeout=60))
            assert r.error
        assert fleet._load(0) == float("inf")
        got = [fleet.submit(s) for s in samples[1:3]]  # all to the healthy engine
        done = {r.uid: r for r in fleet.drain(idle_timeout=60)}
        assert all(done[r.uid].error is None and len(done[r.uid].emitted) == STEPS for r in got)
        assert all(r in fleet.batchers[1].slot_req or r.done for r in got)
        fleet._errors[1] = fleet_lib.QUARANTINE_AFTER
        with pytest.raises(RuntimeError, match="quarantined"):
            fleet.submit(samples[0])
    finally:
        fleet.shutdown()


def test_fleet_device_validation(tiny):
    cfg, _ = tiny
    model = _model(tiny)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        FleetEngine(model, cfg, _gen(), fleet_size=2, **ENGINE)  # a CPU model: one device
    with pytest.raises(ValueError, match="tp_size"):
        FleetEngine(model, cfg, _gen(), tp_size=0, **ENGINE)
    with pytest.raises(ValueError, match="torchrun"):  # one process a rank
        FleetEngine(model, cfg, _gen(), fleet_size=1, tp_size=2)
    fleet = FleetEngine(model, cfg, _gen(), fleet_size=2, devices=["cpu"] * 3, **ENGINE)
    assert len(fleet.batchers) == 2  # sliced to the fleet's size


def test_fleet_resume_routes_to_its_engine(tiny):
    cfg, _ = tiny
    model = _model(tiny)
    engine_kw = dict(ENGINE, max_len=384, prompt_buckets=(128, 256))
    fleet = FleetEngine(model, cfg, GenerationConfig(max_new_tokens=4, eos_token_ids=()),
                        devices=["cpu", "cpu"], **engine_kw)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
    ids1 = [5, -200] + list(rng.integers(3, 400, size=9))
    try:
        # Engine 1 gets the conversation: engine 0 is busy with another
        # request, a placeholder that counts as load, put and taken back
        # before start() (no dispatch thread can take it).
        fleet.batchers[0].queue.put(None)
        r1 = fleet.submit(tmm.build_sample(ids1, [img], cfg), keep_kv=True)
        fleet.batchers[0].queue.get_nowait()
        fleet.start()
        done = {r.uid: r for r in fleet.drain(idle_timeout=60)}
        snap = done[r1.uid].kv_snapshot
        assert snap is not None and snap.engine_idx == 1
        assert KVSnapshot.from_numpy(snap.to_numpy(), device="cpu").engine_idx == 1
        delta = list(rng.integers(3, 400, size=5))
        r2 = fleet.submit(tmm.build_sample(delta, [], cfg), resume=snap)
        assert r2 in list(fleet.batchers[1].queue.queue)
        done = {r.uid: r for r in fleet.drain(idle_timeout=60)}
        assert fleet.batchers[1].resume_fills == 1 and fleet.batchers[0].resume_fills == 0
        full_ids = ids1 + r1.emitted[:snap.n_reply] + delta
        want, _ = torch_dist.engine_tokens(model, cfg, GenerationConfig(
            max_new_tokens=4, eos_token_ids=()), [tmm.build_sample(full_ids, [img], cfg)],
            max_len=384, prompt_buckets=(128, 256))
        assert done[r2.uid].emitted == want[0]
    finally:
        fleet.shutdown()
    bad = KVSnapshot.from_numpy(dict(snap.to_numpy(), engine_idx=7), device="cpu")
    with pytest.raises(ValueError, match="engine 7"):
        fleet.submit(tmm.build_sample(delta, [], cfg), resume=bad)


def test_batch_worker_fleet(tiny, monkeypatch):
    cfg, _ = tiny
    monkeypatch.setenv("RADVLM_SESSION_CAP", "0")
    tok = torch_dist.ByteTokenizer()

    def worker(**kw):
        runner = th.VLMRunner(model=_model(tiny), cfg=cfg, tokenizer=tok, max_new_tokens=6,
                              attn_impl="xla")
        return BatchWorker(runner, model_names=["m"], num_slots=2, max_len=256,
                           prompt_bucket=128, pad_tiles=2, **kw)

    reqs = [{"prompt": f"<|im_start|>user\nquestion {i}<|im_end|>\n", "max_new_tokens": 6}
            for i in range(4)]
    one = worker()
    try:
        want = [one.generate(r) for r in reqs]
    finally:
        one.shutdown()
    two = worker(fleet=2, fleet_devices=["cpu", "cpu"])
    try:
        assert two.fleet is not None and len(two.fleet.batchers) == 2
        assert [two.generate(r) for r in reqs] == want
        assert two.queue_length() == 0
    finally:
        two.shutdown()
    with pytest.raises(ValueError, match="torchrun"):  # a world of 2 x 2 ranks
        worker(fleet=2, fleet_tp=2)
    tp_mesh = {"tensor": SimpleNamespace(size=lambda: 2)}
    with pytest.raises(ValueError, match="exclusive"):  # a TP runner is one engine
        BatchWorker(SimpleNamespace(mesh=tp_mesh), model_names=["m"], fleet=2)


N_EVAL = 11  # above the continuous path's in-flight cap of 8 at batch_size 2
WORKER_N, WORKER_NEW = 4, 6


@pytest.fixture(scope="module")
def one_process(tiny):
    cfg, _ = tiny
    runner = th.VLMRunner(model=_model(tiny), cfg=cfg, tokenizer=torch_dist.ByteTokenizer(),
                          max_new_tokens=4, batch_size=2, attn_impl="xla")
    return th.run_task(runner, torch_dist.grounding_split(N_EVAL), "abnormality_grounding",
                       with_clinical=False)


@pytest.fixture(scope="module")
def two_ranks(tiny, tmp_path_factory):
    cfg, params = tiny
    tmp = tmp_path_factory.mktemp("run_task_ranks")
    return torch_dist.run(torch_dist.run_task_ranks, 2,
                          dict(cfg=cfg, params=params, n=N_EVAL, out=str(tmp),
                               modes=("split", "tp", "worker"), worker_n=WORKER_N,
                               worker_new=WORKER_NEW), tmp / "pg")


def _by_idx(results):
    return sorted(results, key=lambda c: c["idx"])


def test_run_task_across_two_ranks(one_process, two_ranks):
    want_cells, want_metrics = one_process
    ranks = [r["split"] for r in two_ranks]
    for r in ranks:
        assert _by_idx(r["results"]) == _by_idx(want_cells)
        assert r["metrics"] == want_metrics
    assert [r["share"] for r in ranks] == [6, 5]  # i % 2 == rank
    assert [r["wrote"] for r in ranks] == [True, False]


def test_run_task_tp_engine_across_two_ranks(one_process, two_ranks):
    """The two ranks as one TP engine take every sample (one share), submit
    in lockstep and gather rank 0's cells: the one-process run's."""
    want_cells, want_metrics = one_process
    ranks = [r["tp"] for r in two_ranks]
    for r in ranks:
        assert _by_idx(r["results"]) == _by_idx(want_cells)
        assert r["metrics"] == want_metrics
    assert [r["share"] for r in ranks] == [N_EVAL, N_EVAL]
    assert [r["wrote"] for r in ranks] == [True, False]


def test_tp_batch_worker_across_two_ranks(tiny, two_ranks, monkeypatch):
    """The TP runner's BatchWorker: rank 0 serves every request over HTTP
    (one streamed), its answers are the one-process worker's; sessions stay
    off; rank 0's stop ends rank 1's serve_forever."""
    cfg, _ = tiny
    monkeypatch.setenv("RADVLM_SESSION_CAP", "0")
    runner = th.VLMRunner(model=_model(tiny), cfg=cfg, tokenizer=torch_dist.ByteTokenizer(),
                          max_new_tokens=WORKER_NEW, attn_impl="xla")
    one = BatchWorker(runner, model_names=["m"], num_slots=2, max_len=256, prompt_bucket=128,
                      pad_tiles=2)
    try:
        want = [one.generate(r) for r in torch_dist.worker_requests(WORKER_N, WORKER_NEW)]
    finally:
        one.shutdown()
    r0, r1 = (r["worker"] for r in two_ranks)
    assert r0["texts"] == want and r0["chunks"][0] >= 1
    assert r0["sessions_off"] and r1["sessions_off"]
    assert not r0["follows"] and r1["follows"] and r1["stopped"]


def test_run_task_fleet_equals_one_engine(tiny, one_process):
    cfg, _ = tiny
    runner = th.VLMRunner(model=_model(tiny), cfg=cfg, tokenizer=torch_dist.ByteTokenizer(),
                          max_new_tokens=4, batch_size=2, attn_impl="xla", fleet=2,
                          fleet_devices=["cpu", "cpu"])
    stats = {}
    cells, metrics = th.run_task(runner, torch_dist.grounding_split(N_EVAL),
                                 "abnormality_grounding", with_clinical=False, stats=stats)
    assert _by_idx(cells) == _by_idx(one_process[0]) and metrics == one_process[1]
    assert stats["engines"] == 2 and stats["host_stats"]["fills"] == N_EVAL
    with pytest.raises(ValueError, match="exclusive"):
        th.VLMRunner(model=_model(tiny), cfg=cfg, tokenizer=torch_dist.ByteTokenizer(),
                     mesh=object(), fleet=2)
