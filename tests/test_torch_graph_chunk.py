"""The continuous engine's decode chunk as a CUDA graph
(`generation/graphs.py`, `ContinuousBatcher._run_chunk`) on the CPU, at the
tiny config.

- Every tensor a chunk reads or writes keeps its storage (`data_ptr`)
  across `warmup`, fills, a snapshot, a resume fill and the chunks, with
  the int8 and the bf16 cache, spec_k 0 and 2, greedy and sampling: a
  graph holds those addresses, so a rebound tensor would be read stale.
- The graph route driven through a stand-in for `torch.cuda.CUDAGraph`
  that keeps its contract on the CPU (a capture runs nothing the engine
  can see; a replay writes the captured output again, and raises if a
  tensor it read has moved): the first dispatch of a variant runs
  eagerly, the second captures it, the rest replay it, and the greedy
  tokens equal the JAX batcher's (plain and spec, both caches, refills, a
  resume). No tolerance.
- A capture records its kernels' launches without counting them, and each
  replay counts them (a stub graph).
- `graphs.chunk_route`: "eager: cpu" on the CPU, "eager: gloo group" for a
  gloo tensor-parallel group, "graph" for an NCCL one on the card,
  "eager: asked"; `kernel_provenance` reports it as "decode_chunk".
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation import graphs
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm

K = 4
ENGINE = dict(num_slots=2, max_len=512, prompt_buckets=(128, 256), pad_tiles=2,
              steps_per_sync=K, pipeline_depth=2)


def _sample(mm, cfg, n, seed, image=True):
    r = np.random.default_rng(seed)
    ids = [int(t) for t in r.integers(3, cfg.text.vocab_size, size=n)]
    if not image:
        return mm.build_sample(ids, [], cfg)
    img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
    return mm.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg)


def _chunk_tensors(b):
    """Every tensor a chunk reads or writes, by name."""
    ts = {f"cache{i}": c for i, c in enumerate(b.cache)}
    ts.update(cache_seg=b.cache_seg, cur_tok=b.cur_tok, slot_temp=b.slot_temp,
              slot_top_p=b.slot_top_p)
    for name in (("dec_pos", "dec_widx", "tok_hist") if b.spec_k else ("chunk_pos", "chunk_widx")):
        ts[name] = getattr(b, name)
    return ts


def _pointers(b):
    return {n: t.data_ptr() for n, t in _chunk_tensors(b).items()}


# ---------------------------------------------------------------------------
# (a) storage kept across the engine's life
# ---------------------------------------------------------------------------

_ENGINES = {}


@pytest.fixture(scope="module")
def port_model():
    cfg = tiny_test_config()
    return cfg, convert.random_quantized_params(cfg, torch.Generator().manual_seed(3),
                                                device="cpu", dtype=torch.float32)


def _case_engine(port_model, kv_quant, spec_k, sampling):
    """One engine a case, kept for the module."""
    key = (kv_quant, spec_k, sampling)
    if key not in _ENGINES:
        cfg, model = port_model
        gen = teng.GenerationConfig(max_new_tokens=3 * K, temperature=0.8 if sampling else 0.0)
        _ENGINES[key] = TBatcher(model, cfg, gen, kv_quant=kv_quant, spec_k=spec_k, seed=5,
                                 **ENGINE)
    return _ENGINES[key]


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampling"])
@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8", "bf16"])
def test_chunk_tensors_keep_their_storage(port_model, kv_quant, spec_k, sampling):
    cfg, _ = port_model
    b = _case_engine(port_model, kv_quant, spec_k, sampling)
    assert b.chunk_route() == "eager: cpu"
    start = _pointers(b)
    b.warmup()
    assert _pointers(b) == start, "warmup"
    r1 = b.submit(_sample(tmm, cfg, 9, 1), keep_kv=True)
    r2 = b.submit(_sample(tmm, cfg, 6, 2))
    chunks = b.host_stats["chunks"]
    assert sorted(r.uid for r in b.run()) == sorted([r1.uid, r2.uid])
    assert b.host_stats["chunks"] - chunks >= 3
    assert r1.kv_snapshot is not None
    assert _pointers(b) == start, "fills, chunks and a snapshot"
    r3 = b.submit(_sample(tmm, cfg, 5, 3, image=False), resume=r1.kv_snapshot)
    assert [r.uid for r in b.run()] == [r3.uid] and b.resume_fills == 1
    assert len(r3.emitted) == 3 * K
    assert _pointers(b) == start, "a resume fill"


# ---------------------------------------------------------------------------
# (b) the graph route against the JAX batcher
# ---------------------------------------------------------------------------


class EmulatedGraph:
    """`torch.cuda.CUDAGraph`'s contract on the CPU. A capture queues work
    without running it: here the body runs once to give its output, and
    the engine's state and generator are put back at `capture_end`. A
    replay runs the captured body again into that output, and fails if a
    tensor the body reads or writes has moved since the capture (a real
    graph would read the old storage)."""

    capturing = None  # the graph whose capture is under way
    replays = 0

    def __init__(self):
        self.engine = self.sampling = self.out = None

    def register_generator_state(self, generator):
        pass

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        EmulatedGraph.capturing = self

    def begin_body(self, engine, sampling):
        self.engine, self.sampling = engine, sampling
        self.saved = {n: t.clone() for n, t in _chunk_tensors(engine).items()}
        self.pointers = _pointers(engine)
        self.rng = engine.generator.get_state()

    def capture_end(self):
        EmulatedGraph.capturing = None
        for n, t in _chunk_tensors(self.engine).items():
            t.copy_(self.saved[n])
        self.engine.generator.set_state(self.rng)

    def replay(self):
        assert _pointers(self.engine) == self.pointers
        EmulatedGraph.replays += 1
        self.out.copy_(_ORIGINAL_BODY(self.engine, self.sampling))


_ORIGINAL_BODY = TBatcher._chunk_body


def _recording_body(self, sampling):
    g = EmulatedGraph.capturing
    if g is None:
        return _ORIGINAL_BODY(self, sampling)
    g.begin_body(self, sampling)
    g.out = _ORIGINAL_BODY(self, sampling)
    return g.out


@pytest.fixture
def graph_route(monkeypatch):
    """Engines on the CPU take the graph route through `EmulatedGraph`."""
    monkeypatch.setattr(TBatcher, "chunk_route",
                        lambda self: "eager: asked" if self.eager_chunks else "graph")
    monkeypatch.setattr(TBatcher, "_chunk_body", _recording_body)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    EmulatedGraph.replays = 0


@pytest.fixture(scope="module")
def tiny_q():
    cfg = cfglib.tiny_test_config()
    params = jax.tree.map(np.asarray, jquant.quantize_params(
        jrad.init_params(cfg, jax.random.key(7))))
    return cfg, params, convert.radvlm_from_jax(params, cfg, device="cpu")


NEW = 9
SAMPLES = [(6, 11), (11, 12), (8, 13), (14, 14), (7, 15)]  # (ids, seed): more than the slots


def _jax_tokens(cfg, params, kv_quant):
    jb = JBatcher(params, cfg, jeng.GenerationConfig(max_new_tokens=NEW), attn_impl="xla",
                  kv_quant=kv_quant, **ENGINE)
    reqs = [jb.submit(_sample(jmm, cfg, n, s)) for n, s in SAMPLES]
    done = {r.uid: r.emitted for r in jb.run()}
    return [done[r.uid] for r in reqs]


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8", "bf16"])
def test_graph_route_gives_the_jax_batchers_tokens(tiny_q, graph_route, kv_quant, spec_k):
    cfg, params, model = tiny_q
    b = TBatcher(model, cfg, teng.GenerationConfig(max_new_tokens=NEW), kv_quant=kv_quant,
                 spec_k=spec_k, **ENGINE)
    reqs = [b.submit(_sample(tmm, cfg, n, s)) for n, s in SAMPLES]
    done = {r.uid: r.emitted for r in b.run()}
    assert [done[r.uid] for r in reqs] == _jax_tokens(cfg, params, kv_quant)
    # The greedy variant ran eagerly once, was captured at its second
    # dispatch and replayed at every dispatch from then on.
    assert list(b._graphs) == [False] and b._ran_eager == {False}
    assert EmulatedGraph.replays == b.host_stats["chunks"] - 1
    assert b._graphs[False].name == ("verify" if spec_k else "greedy")


def test_graph_route_resumes_and_warms_up(tiny_q, graph_route):
    """`warmup` captures both variants after their eager chunks; a resumed
    turn on the replayed chunks gives the tokens of the same turn on an
    engine that runs every chunk eagerly."""
    cfg, _, model = tiny_q
    runs = {}
    for route in ("graph", "eager"):
        b = TBatcher(model, cfg, teng.GenerationConfig(max_new_tokens=NEW), kv_quant=True,
                     eager_chunks=route == "eager", **ENGINE)
        if route == "graph":
            b.warmup()
            assert set(b._graphs) == {False, True} and b._ran_eager == {False, True}
            assert {"capture_greedy", "capture_sampling"} <= set(b.warmup_timings)
        r1 = b.submit(_sample(tmm, cfg, 9, 21), keep_kv=True)
        list(b.run())
        r2 = b.submit(_sample(tmm, cfg, 5, 22, image=False), resume=r1.kv_snapshot)
        list(b.run())
        runs[route] = (r1.emitted, r2.emitted)
    assert runs["graph"] == runs["eager"]
    assert len(runs["graph"][1]) == NEW and EmulatedGraph.replays > 0


# ---------------------------------------------------------------------------
# (c) launch counts
# ---------------------------------------------------------------------------


class StubGraph:
    def __init__(self):
        self.calls = []

    def register_generator_state(self, generator):
        self.calls.append("generator")

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", pool, capture_error_mode))

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


def test_replay_counts_the_launches_its_capture_recorded():
    def body():
        for _ in range(3):
            kernels.count_launch("decode_attention_q8")
        kernels.count_launch("int8_matmul")
        return torch.zeros(2)

    stub = StubGraph()
    g = graphs.ChunkGraph("greedy", pool=(1, 2), graph=stub,
                          generator=torch.Generator().manual_seed(0))
    before = kernels.launch_counts()
    g.capture(body)
    assert kernels.launch_counts() == before  # the capture launched nothing
    assert g.launches == {"decode_attention_q8": 3, "int8_matmul": 1}
    assert stub.calls == ["generator", ("begin", (1, 2), "thread_local"), "end"]
    for n in (1, 2):
        out = g.replay()
        after = kernels.launch_counts()
        assert after["decode_attention_q8"] == before["decode_attention_q8"] + 3 * n
        assert after["int8_matmul"] == before["int8_matmul"] + n
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "decode_attention_q8": 3 * n, "int8_matmul": n}
    assert out is g.out and stub.calls[-2:] == ["replay", "replay"]
    kernels.count_launch("int8_matmul")  # outside a capture: counted as before
    assert kernels.launch_counts()["int8_matmul"] == before["int8_matmul"] + 3


def test_failed_capture_raises_and_ends_the_capture():
    stub = StubGraph()
    g = graphs.ChunkGraph("sampling", graph=stub)

    def body():
        kernels.count_launch("int8_matmul")
        raise RuntimeError("operation not permitted when stream is capturing")

    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="capturing the sampling chunk failed"):
        g.capture(body)
    assert stub.calls[-1] == "end" and kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# (d) the route predicate
# ---------------------------------------------------------------------------


@pytest.fixture
def gloo_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_route_predicate(gloo_world, monkeypatch):
    cuda, cpu = torch.device("cuda:0"), torch.device("cpu")
    assert graphs.chunk_route(cpu) == "eager: cpu"
    assert graphs.chunk_route(cpu, gloo_world) == "eager: cpu"
    assert graphs.chunk_route(cuda) == "graph"
    assert graphs.chunk_route(cuda, eager=True) == "eager: asked"
    assert graphs.chunk_route(cuda, gloo_world) == "eager: gloo group"
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert graphs.chunk_route(cuda, gloo_world) == "graph"


def test_provenance_reports_the_route(port_model):
    cfg, model = port_model
    kw = dict(prompt_len=256, max_new_tokens=32)
    assert teng.kernel_provenance(cfg, **kw)["decode_chunk"] == "graph"
    assert teng.kernel_provenance(cfg, device="cpu", **kw)["decode_chunk"] == "eager: cpu"
    gen = teng.GenerationConfig(max_new_tokens=2)
    assert TBatcher(model, cfg, gen, **ENGINE).kernel_provenance()["decode_chunk"] == "eager: cpu"
    asked = TBatcher(model, cfg, gen, eager_chunks=True, **ENGINE)
    assert asked.kernel_provenance()["decode_chunk"] == "eager: asked"


# ---------------------------------------------------------------------------
# A faster engine ends a stream before its run() loop yields the request
# ---------------------------------------------------------------------------


class CharTokenizer:
    """Ids round-trip through text (id i is the character chr(256 + i);
    ASCII encodes as 2 + its byte), as a session's prefix match needs."""

    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [ord(c) - 256 if ord(c) >= 256 else 2 + ord(c) for c in text]

    def decode(self, ids):
        return "".join(chr(256 + i) for i in ids)


def test_worker_stores_the_session_before_the_turn_ends(port_model, monkeypatch):
    """The engine thread stores a finished turn's session only once its
    run() loop yields the request, after the chunks still in flight are
    read back; the client has its last token before that. With that store
    held back, each next turn (streamed, then blocking) must still find the
    session and be a delta prefill."""
    import time

    from radvlm_tpu_torch.eval.harness import VLMRunner
    from radvlm_tpu_torch.serve.batch_worker import BatchWorker

    cfg, model = port_model
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=CharTokenizer(), max_new_tokens=4,
                       pad_to_multiple=128)
    worker = BatchWorker(runner, model_names=["tiny"], num_slots=2, max_len=768,
                         prompt_bucket=256, pad_tiles=2, steps_per_sync=4, kv_quant=True)
    engine_store = worker._signal_done

    def late(req):
        time.sleep(1.0)
        engine_store(req)

    monkeypatch.setattr(worker, "_signal_done", late)
    b = worker.batcher
    try:
        body = {"session_id": "s", "max_new_tokens": 4, "temperature": 0.0}
        prompt = "Describe the film."
        reply = list(worker.generate_stream(dict(body, prompt=prompt)))[-1]["text"]
        assert len(reply) == 4 and b.resume_fills == 0
        prompt += reply + " Any effusion?"
        reply = list(worker.generate_stream(dict(body, prompt=prompt)))[-1]["text"]
        assert b.resume_fills == 1
        out = worker.generate(dict(body, prompt=prompt + reply + " Size?"))
        assert out["error_code"] == 0 and b.resume_fills == 2
    finally:
        worker.shutdown()
