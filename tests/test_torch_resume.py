"""Multi-turn KV reuse in the port against the JAX package, on the CPU at
the tiny config (inputs from a numpy seed; the same weights on both sides).

- `ContinuousBatcher`: a turn prefilled as a delta on a `KVSnapshot` emits
  exactly the tokens of a full prefill of the whole conversation (the JAX
  package's static engine on the concatenated history, and the port's own
  full prefill), with both caches, a text delta and a delta with a new
  image; on a spec engine; beside other slots; after `truncated`; with the
  partial coverage of `pipeline_depth=0`. Geometry mismatches raise; no
  snapshot is cut without `keep_kv`; the snapshot is a copy. Identical
  tokens, no tolerance (greedy argmax).
- A snapshot cut by the JAX engine, carried over as numpy, resumes in the
  port to the same tokens, and one cut by the port resumes in JAX.
- `serve/sessions.py` and `serve/openai_api.py` give what the JAX modules
  give on the same inputs; `BatchWorker` serves a two-turn session over
  `/v1/chat/completions` with a delta prefill, plain and SSE.
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import continuous as jcont
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.serve import openai_api as joai
from radvlm_tpu.serve import sessions as jsess
from radvlm_tpu_torch.eval.harness import VLMRunner
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.generation.continuous import KVSnapshot
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.serve import openai_api as toai
from radvlm_tpu_torch.serve import sessions as tsess
from radvlm_tpu_torch.serve.batch_worker import BatchWorker

ENGINE = dict(num_slots=2, max_len=512, prompt_buckets=(128,), pad_tiles=2)


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(7)))
    return cfg, params, convert.radvlm_from_jax(params, cfg, device="cpu")


def _static_reference(params, cfg, ids, images, steps):
    """The JAX package's static engine on the full conversation."""
    gen_fn = jeng.make_generate_fn(
        cfg, jeng.GenerationConfig(max_new_tokens=steps, eos_token_ids=()), attn_impl="xla")
    batch = jmm.collate([jmm.build_sample(ids, images, cfg)], pad_to_multiple=128, left_pad=True)
    out = gen_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    return [int(t) for t in np.asarray(out["tokens"])[0, :steps]]


def _run_one(batcher, sample, steps, **kw):
    req = batcher.submit(sample, max_new_tokens=steps, **kw)
    done = list(batcher.run())
    assert [r.uid for r in done] == [req.uid]
    return req


def _conversation(cfg, seed=0):
    """(turn-1 ids, its image, a text delta, a delta with a new image, that image)."""
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
    img2 = rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
    ints = lambda n: [int(t) for t in rng.integers(3, cfg.text.vocab_size, size=n)]  # noqa: E731
    t1, d2, t3 = ints(9), ints(7), ints(5)
    return t1[:2] + [IMAGE_TOKEN_INDEX] + t1[2:], img1, d2, t3[:3] + [IMAGE_TOKEN_INDEX] + t3[3:], img2


def _engine(tiny, steps, **kw):
    cfg, _, model = tiny
    return TBatcher(model, cfg, teng.GenerationConfig(max_new_tokens=steps),
                    **dict(ENGINE, **kw))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_resume_matches_full_prefill(tiny, kv_quant):
    """Three turns: full prefill, a text delta, a delta with a NEW image."""
    cfg, params, _ = tiny
    ids1, img1, d2, d3, img2 = _conversation(cfg)
    steps = 4
    b = _engine(tiny, steps, kv_quant=kv_quant)
    r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    assert r1.emitted == _static_reference(params, cfg, ids1, [img1], steps)
    snap = r1.kv_snapshot
    assert snap is not None and snap.widx == 128 + snap.n_reply and snap.kv_quant == kv_quant
    assert len(snap.cache_rows) == (4 if kv_quant else 2) and snap.hist_row is None

    ids2 = ids1 + r1.emitted + d2
    r2 = _run_one(b, tmm.build_sample(d2, [], cfg), steps, keep_kv=True, resume=snap)
    assert r2.emitted == _static_reference(params, cfg, ids2, [img1], steps)
    assert b.resume_fills == 1
    # ... which is also what the port's own full prefill gives.
    full = _run_one(_engine(tiny, steps, kv_quant=kv_quant),
                    tmm.build_sample(ids2, [img1], cfg), steps)
    assert r2.emitted == full.emitted

    ids3 = ids2 + r2.emitted + d3
    r3 = _run_one(b, tmm.build_sample(d3, [img2], cfg), steps, resume=r2.kv_snapshot)
    assert r3.emitted == _static_reference(params, cfg, ids3, [img1, img2], steps)
    assert b.resume_fills == 2 and r3.kv_snapshot is None


def test_snapshot_is_a_copy_and_survives_reuse(tiny):
    """The slot is refilled under the snapshot, and one snapshot resumes
    twice to the same tokens (the resume only reads it)."""
    cfg, _, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    b = _engine(tiny, 4, num_slots=1)
    r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), 4, keep_kv=True)
    snap = r1.kv_snapshot
    before = [c.clone() for c in snap.cache_rows] + [snap.seg_row.clone()]
    assert all(c.data_ptr() != s.data_ptr() for c, s in zip(snap.cache_rows, b.cache))
    other = _conversation(cfg, seed=5)
    _run_one(b, tmm.build_sample(other[0], [other[1]], cfg), 4)  # refills the only slot
    first = _run_one(b, tmm.build_sample(d2, [], cfg), 4, resume=snap)
    for was, now in zip(before, list(snap.cache_rows) + [snap.seg_row]):
        assert torch.equal(was, now)
    again = _run_one(b, tmm.build_sample(d2, [], cfg), 4, resume=snap)
    assert first.emitted == again.emitted and b.resume_fills == 2


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_resume_on_spec_engine(tiny, kv_quant):
    """Resume and speculative decoding compose: the resumed turn's tokens are
    the plain greedy stream of the full conversation."""
    cfg, params, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    steps = 6
    b = _engine(tiny, steps, spec_k=2, kv_quant=kv_quant)
    r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    snap = r1.kv_snapshot
    assert snap.hist_row is not None and snap.hist_row.shape == (1, 512)
    ids2 = ids1 + r1.emitted + d2
    delta = r1.emitted[snap.n_reply:] + d2
    r2 = _run_one(b, tmm.build_sample(delta, [], cfg), steps, resume=snap)
    assert r2.emitted == _static_reference(params, cfg, ids2, [img1], steps)
    # A snapshot of a plain engine has no history row: a spec engine refuses it.
    plain = _engine(tiny, steps, kv_quant=kv_quant)
    p1 = _run_one(plain, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    with pytest.raises(ValueError, match="hist_row"):
        b.submit(tmm.build_sample(d2, [], cfg), resume=p1.kv_snapshot)


def test_resume_alongside_other_slots(tiny):
    """A resumed fill does not disturb the requests in the other slots."""
    cfg, params, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    steps = 4
    b = _engine(tiny, steps, num_slots=3, fill_batch=2)
    r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    rng = np.random.default_rng(1)
    others = []
    for n in (6, 11):
        t = [int(x) for x in rng.integers(3, cfg.text.vocab_size, size=n)]
        others.append((t[:2] + [IMAGE_TOKEN_INDEX] + t[2:],
                       rng.integers(0, 255, size=(80, 64, 3), dtype=np.uint8)))
    reqs = [b.submit(tmm.build_sample(ids, [img], cfg), max_new_tokens=steps)
            for ids, img in others]
    rres = b.submit(tmm.build_sample(d2, [], cfg), max_new_tokens=steps, resume=r1.kv_snapshot)
    list(b.run())
    assert rres.emitted == _static_reference(params, cfg, ids1 + r1.emitted + d2, [img1], steps)
    for req, (ids, img) in zip(reqs, others):
        assert req.emitted == _static_reference(params, cfg, ids, [img], steps)


def test_resume_geometry_validation(tiny):
    cfg, _, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    b = _engine(tiny, 2)
    snap = _run_one(b, tmm.build_sample(ids1, [img1], cfg), 2, keep_kv=True).kv_snapshot
    with pytest.raises(ValueError, match="geometry mismatch"):
        _engine(tiny, 2, max_len=256).submit(tmm.build_sample(d2, [], cfg), resume=snap)
    with pytest.raises(ValueError, match="geometry mismatch"):
        _engine(tiny, 2, kv_quant=True).submit(tmm.build_sample(d2, [], cfg), resume=snap)
    big = [int(t) for t in np.random.default_rng(2).integers(3, cfg.text.vocab_size, size=400)]
    with pytest.raises(ValueError, match="delta pads to"):
        b.submit(tmm.build_sample(big, [], cfg), resume=snap)
    assert b.queue.empty()


def test_resume_pipeline_depth0_partial_coverage(tiny):
    """At pipeline_depth=0 the last emitted token's K/V may never be fed: the
    snapshot covers fewer reply tokens (n_reply), and a resume whose delta
    feeds the uncovered tail again still matches the full prefill."""
    cfg, params, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    steps = 4
    for spec_k in (0, 2):
        b = _engine(tiny, steps, pipeline_depth=0, spec_k=spec_k)
        r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
        snap = r1.kv_snapshot
        assert 0 <= snap.n_reply <= len(r1.emitted)
        if spec_k:
            assert snap.n_reply == len(r1.emitted) - 1
        delta = r1.emitted[snap.n_reply:] + d2
        r2 = _run_one(b, tmm.build_sample(delta, [], cfg), steps, resume=snap)
        assert r2.emitted == _static_reference(params, cfg, ids1 + r1.emitted + d2, [img1], steps)


def test_snapshot_truncated(tiny):
    cfg, params, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    steps = 4
    b = _engine(tiny, steps)
    r1 = _run_one(b, tmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    snap = r1.kv_snapshot
    assert snap.n_reply >= 2
    short = snap.truncated(2)
    assert (short.widx, short.real_len, short.n_reply) == (
        snap.widx - 2, snap.real_len - 2, snap.n_reply - 2)
    assert short.cache_rows[0] is snap.cache_rows[0] and snap.truncated(0) is snap
    delta = r1.emitted[short.n_reply:] + d2
    r2 = _run_one(b, tmm.build_sample(delta, [], cfg), steps, resume=short)
    assert r2.emitted == _static_reference(params, cfg, ids1 + r1.emitted + d2, [img1], steps)
    with pytest.raises(ValueError):
        snap.truncated(snap.n_reply + 1)


def test_no_snapshot_without_keep_kv(tiny):
    cfg, _, _ = tiny
    ids1, img1, _, _, _ = _conversation(cfg)
    r = _run_one(_engine(tiny, 2, max_len=256), tmm.build_sample(ids1, [img1], cfg), 2)
    assert r.kv_snapshot is None


# ------------------------------------------------ snapshots across the packages


def _jax_snapshot_fields(snap):
    """A JAX `KVSnapshot` as numpy: bf16 rows as their uint16 bit patterns."""
    def host(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    fields = {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
    fields["cache_rows"] = tuple(host(c) for c in snap.cache_rows)
    fields["seg_row"] = host(snap.seg_row)
    fields["hist_row"] = None if snap.hist_row is None else host(snap.hist_row)
    return fields


@pytest.mark.parametrize("kv_quant,spec_k", [(False, 0), (True, 0), (True, 2)],
                         ids=["bf16", "int8", "int8-spec"])
def test_jax_snapshot_resumes_in_the_port_and_back(tiny, kv_quant, spec_k):
    cfg, params, _ = tiny
    ids1, img1, d2, _, _ = _conversation(cfg)
    steps = 5
    jb = jcont.ContinuousBatcher(
        params, cfg, jeng.GenerationConfig(max_new_tokens=steps, eos_token_ids=()),
        attn_impl="xla", kv_quant=kv_quant, spec_k=spec_k, **ENGINE)
    j1 = _run_one(jb, jmm.build_sample(ids1, [img1], cfg), steps, keep_kv=True)
    jsnap = j1.kv_snapshot
    snap = KVSnapshot.from_numpy(_jax_snapshot_fields(jsnap), device="cpu")
    assert (snap.widx, snap.real_len, snap.n_reply, snap.max_len, snap.kv_quant) == (
        jsnap.widx, jsnap.real_len, jsnap.n_reply, jsnap.max_len, kv_quant)
    assert snap.cache_rows[0].dtype == (torch.int8 if kv_quant else torch.bfloat16)
    emitted = [int(t) for t in j1.emitted]
    delta = emitted[snap.n_reply:] + d2
    expected = _static_reference(params, cfg, ids1 + emitted + d2, [img1], steps)
    tb = _engine(tiny, steps, kv_quant=kv_quant, spec_k=spec_k)
    t2 = _run_one(tb, tmm.build_sample(delta, [], cfg), steps, keep_kv=True, resume=snap)
    assert t2.emitted == expected
    # The round trip through numpy keeps every array and scalar.
    again = KVSnapshot.from_numpy(snap.to_numpy(), device="cpu")
    assert dataclasses.replace(again, cache_rows=(), seg_row=None, hist_row=None) == \
        dataclasses.replace(snap, cache_rows=(), seg_row=None, hist_row=None)
    for a, b in zip(again.cache_rows + (again.seg_row,), snap.cache_rows + (snap.seg_row,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # And back: the port's snapshot of turn 2 resumes in the JAX engine.
    f = t2.kv_snapshot.to_numpy()
    rows = tuple(jnp.asarray(c.view(jnp.bfloat16) if c.dtype == np.uint16 else c)
                 for c in f["cache_rows"])
    back = jcont.KVSnapshot(**dict(
        f, cache_rows=rows, seg_row=jnp.asarray(f["seg_row"]),
        hist_row=None if f["hist_row"] is None else jnp.asarray(f["hist_row"])))
    d3 = [int(t) for t in np.random.default_rng(9).integers(3, cfg.text.vocab_size, size=6)]
    ids3 = ids1 + emitted + d2 + t2.emitted + d3
    j3 = _run_one(jb, jmm.build_sample(t2.emitted[back.n_reply:] + d3, [], cfg), steps,
                  resume=back)
    assert [int(t) for t in j3.emitted] == _static_reference(params, cfg, ids3, [img1], steps)


# ------------------------------------------------------- sessions and OpenAI API


def test_sessions_module_equals_jax(monkeypatch):
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 255, (9, 7, 3), dtype=np.uint8)
    img2 = rng.integers(0, 255, (7, 9, 3), dtype=np.uint8)
    assert tsess.image_hash(img1) == jsess.image_hash(img1) != tsess.image_hash(img2)
    assert tsess.image_hash(img1.reshape(7, 9, 3)) != tsess.image_hash(img1)  # the shape counts
    h1, h2 = tsess.image_hash(img1), tsess.image_hash(img2)
    stored = [5, IMAGE_TOKEN_INDEX, 6, 7, 8]
    cases = [
        (stored + [9, 10], [h1]),  # a text delta
        (stored + [9, IMAGE_TOKEN_INDEX], [h1, h2]),  # a delta with a new image
        (stored, [h1]),  # nothing new
        (stored[:-1] + [3, 9], [h1]),  # edited history
        (stored + [9], [h2]),  # another image under the prefix
        (stored + [9, IMAGE_TOKEN_INDEX], [h1]),  # a sentinel without its image
        (stored + [9], [h1, h2]),  # an image without its sentinel
    ]
    for ids, hashes in cases:
        got = tsess.split_delta(tsess.Session(stored, [h1], None), ids, hashes)
        want = jsess.split_delta(jsess.Session(stored, [h1], None), ids, hashes)
        assert got == want
    assert tsess.split_delta(tsess.Session(stored, [h1], None), *cases[1]) == (
        [9, IMAGE_TOKEN_INDEX], 1)
    monkeypatch.setenv("RADVLM_SESSION_CAP", "2")
    for mod in (tsess, jsess):
        store = mod.SessionStore()
        assert store.cap == 2
        for sid in "abc":
            store.put(sid, mod.Session([1], [], sid))
            store.get("a")  # keeps "a" the most recently used
        assert len(store) == 2 and store.get("b") is None
        assert store.get("a").snapshot == "a" and store.get("c").snapshot == "c"
        store.drop("a")
        assert len(store) == 1


def test_openai_converters_equal_jax():
    url = "data:image/png;base64,QUJD"
    bodies = [
        {"messages": [{"role": "user", "content": "hi"}]},
        {"messages": [{"role": "system", "content": "Be brief."},
                      {"role": "user", "content": [{"type": "text", "text": "Look:"},
                                                   {"type": "image_url", "image_url": {"url": url}}]},
                      {"role": "assistant", "content": "A chest film."},
                      {"role": "user", "content": "Any effusion?"}],
         "max_tokens": 7, "temperature": 0.5, "top_p": 0.9, "stop": ["##", "x"], "user": "dr-a"},
        {"messages": [{"role": "user", "content": "again"}], "max_completion_tokens": 3,
         "stop": "END", "user": "dr-a"},
    ]
    for body in bodies:
        assert toai.messages_to_request(body) == joai.messages_to_request(body)
    with_user = toai.messages_to_request(bodies[1])
    assert with_user["session_id"].startswith("oai-") and with_user["images"] == ["QUJD"]
    assert with_user["prompt"].count("<image>") == 1
    # The port also passes an explicit session id through.
    explicit = toai.messages_to_request(dict(bodies[1], session_id="chat-7"))
    assert explicit == dict(with_user, session_id="chat-7")
    bad = [{"messages": []}, {"messages": [{"role": "assistant", "content": "x"}]},
           {"messages": [{"role": "tool", "content": "x"}]},
           {"messages": [{"role": "user", "content": [{"type": "audio"}]}]},
           {"messages": [{"role": "user", "content": [
               {"type": "image_url", "image_url": {"url": "http://example.invalid/x.png"}}]}]}]
    for body in bad:
        for mod in (toai, joai):
            with pytest.raises(ValueError):
                mod.messages_to_request(body)
    result = {"text": "fine", "error_code": 0}
    assert toai.completion_json("m", result, "id1", 5) == joai.completion_json("m", result, "id1", 5)
    failed = {"text": "boom", "error_code": 1}
    assert toai.completion_json("m", failed, "id1", 5) == joai.completion_json("m", failed, "id1", 5)
    assert toai.models_json(["a", "b"], 5) == joai.models_json(["a", "b"], 5)
    chunks = [{"text": "He", "error_code": 0}, {"text": "Hello", "error_code": 0},
              {"text": "Hell", "error_code": 0}]
    assert list(toai.sse_stream("m", iter(chunks), "id1", 5)) == \
        list(joai.sse_stream("m", iter(chunks), "id1", 5))
    err = chunks[:1] + [{"text": "bad", "error_code": 1}]
    frames = list(toai.sse_stream("m", iter(err), "id1", 5))
    assert frames == list(joai.sse_stream("m", iter(err), "id1", 5))
    assert frames[-1] == b"data: [DONE]\n\n" and b'"finish_reason": "error"' in frames[-2]
    assert toai.new_request_id().startswith("chatcmpl-")


class CharTokenizer:
    """Text -> ids -> text -> ids round-trips: id i decodes to the character
    chr(256 + i), which encodes back to i; ASCII text (the chat template)
    encodes as 2 + its byte. A client that sends a reply back as text then
    sends the very ids the engine emitted, which a session's prefix match
    needs."""

    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [ord(c) - 256 if ord(c) >= 256 else 2 + ord(c) for c in text]

    def decode(self, ids):
        return "".join(chr(256 + i) for i in ids)


def _http(port, path, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _png_url(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def test_batch_worker_sessions_over_openai_endpoints(tiny):
    """Two turns of one chat over /v1/chat/completions on a spec engine: the
    second is a delta prefill and gives the text of a full prefill of the
    same conversation (another session id); SSE gives the same text."""
    cfg, _, model = tiny
    runner = VLMRunner(model=model, cfg=cfg, tokenizer=CharTokenizer(), max_new_tokens=6,
                       pad_to_multiple=128)
    worker = BatchWorker(runner, model_names=["tiny"], num_slots=2, max_len=768,
                         prompt_bucket=256, pad_tiles=2, steps_per_sync=4, spec_k=2,
                         kv_quant=True)
    b = worker.batcher
    assert b.resume_fills == 0  # the warmup's own resume is not counted
    img = np.random.default_rng(3).integers(0, 255, (90, 70, 3), dtype=np.uint8)
    first = {"role": "user", "content": [{"type": "image_url", "image_url": {"url": _png_url(img)}},
                                         {"type": "text", "text": "Describe."}]}
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    try:
        code, body = _http(port, "/v1/models")
        assert code == 200 and [m["id"] for m in json.loads(body)["data"]] == ["tiny"]

        def chat(messages, sid, **kw):
            code, body = _http(port, "/v1/chat/completions",
                               dict(messages=messages, max_tokens=6, session_id=sid, **kw))
            assert code == 200, body
            return body

        out1 = json.loads(chat([first], "s1"))
        reply1 = out1["choices"][0]["message"]["content"]
        assert out1["object"] == "chat.completion" and out1["model"] == "tiny" and reply1
        assert b.resume_fills == 0 and len(worker._sessions) == 1
        turns = [first, {"role": "assistant", "content": reply1},
                 {"role": "user", "content": "Any effusion?"}]
        reply2 = json.loads(chat(turns, "s1"))["choices"][0]["message"]["content"]
        assert b.resume_fills == 1
        # The same conversation under a new session id: a full prefill.
        assert json.loads(chat(turns, "s2"))["choices"][0]["message"]["content"] == reply2
        assert b.resume_fills == 1
        # SSE, on the stored first turn again (s2 now holds both turns).
        frames = chat(turns, "s1", stream=True).split(b"\n\n")
        deltas = [json.loads(f[6:])["choices"][0]["delta"].get("content", "")
                  for f in frames if f.startswith(b"data: {")]
        assert "".join(deltas) == reply2 and frames[-2] == b"data: [DONE]"
        assert b.resume_fills == 1  # s1 was overwritten by turn 2: no prefix match
        # Errors: an unknown model, a body without a user turn, an unknown path.
        code, body = _http(port, "/v1/chat/completions", dict(messages=turns, model="nope"))
        assert code == 404 and json.loads(body)["error"]["code"] == "model_not_found"
        code, body = _http(port, "/v1/chat/completions", {"messages": turns[:2]})
        assert code == 400 and json.loads(body)["error"]["type"] == "invalid_request_error"
        assert _http(port, "/v1/nothing")[0] == 404
    finally:
        worker.shutdown()
    assert b.spec_stats["verify_steps"] > 0
