"""Speculative decoding in the port against the JAX package, on the CPU at
the tiny config with its text head dim widened from 12 to 16, the smallest
that the int8-cache kernels K4 / K11 take, so that the int8 engine routes
through them as it does on the card (inputs from a numpy seed; the same
weights on both sides through the weight bridge).

- `generation/spec.py`: `write_history`, `propose_ngram`, `greedy_accept`
  and `history_from_prompt` equal the JAX functions exactly (integers).
- `qwen2.forward` with a per-row window of k + 1 tokens (K10 / K11 through
  their plain versions on the CPU) gives the logits and the cache of k + 1
  single-token steps, bf16 and int8 cache, within 2e-2 (the tolerance of
  tests/test_spec_decode.py: the bf16 cache rounds K/V, the int8 cache
  quantizes it, and the two paths sum in another order), and the logits of
  the JAX package's window forward within 2e-2.
- `ContinuousBatcher(spec_k=k)`: greedy tokens identical to the port's plain
  engine and to the JAX spec engine (no tolerance: greedy argmax), with both
  caches and k in {2, 4}; eos and the max_new headroom of spec_k are
  respected; a sampling request is served beside a greedy one; a repetitive
  stream accepts more than one token per verify step; `RADVLM_SPEC_K` sets
  the default; `kernel_provenance` names the verify window's routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation import spec as jspec
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import qwen2 as jqwen
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation import spec as tspec
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.models import qwen2 as tqwen

ENGINE = dict(num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2, steps_per_sync=4)


def _tiny_config():
    cfg = cfglib.tiny_test_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, head_dim=16))


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ------------------------------------------------------------------ functions


@pytest.mark.parametrize("seed", range(4))
def test_spec_functions_equal_jax(seed):
    """Random histories over a small vocabulary (many repeated bigrams), -1
    runs for padding and images, rows at different write indices."""
    rng = np.random.default_rng(seed)
    b, s, k, v = 5, 96, 1 + seed, 7
    hist = rng.integers(0, v, size=(b, s)).astype(np.int32)
    hist[:, :6] = -1
    hist[1, 20:31] = -1
    widx = rng.integers(8, s - k - 2, size=b).astype(np.int32)
    widx[0] = 8
    for i in range(b):  # nothing is written past the stream's end
        hist[i, widx[i] + 1:] = -1
    got = tspec.propose_ngram(_t(hist), _t(widx), k)
    want = np.asarray(jspec.propose_ngram(jnp.asarray(hist), jnp.asarray(widx), k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    window = rng.integers(0, v, size=(b, k + 1)).astype(np.int32)
    got_h = tspec.write_history(_t(hist).clone(), _t(widx), _t(window)).numpy()
    want_h = np.asarray(jspec.write_history(jnp.asarray(hist), jnp.asarray(widx),
                                            jnp.asarray(window)))
    np.testing.assert_array_equal(got_h, want_h)

    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    draft = logits[:, :-1].argmax(-1).astype(np.int32)
    draft[1, 0] = (draft[1, 0] + 1) % v  # row 1 accepts nothing
    if k > 1:
        draft[2, 1] = (draft[2, 1] + 1) % v  # row 2 accepts one
    got_a = tspec.greedy_accept(torch.from_numpy(logits), _t(draft))
    want_a = jspec.greedy_accept(jnp.asarray(logits), jnp.asarray(draft))
    for g, w in zip(got_a, want_a):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got_a[1][1] == 1 and got_a[1][0] == k + 1

    tokens = rng.integers(0, v, size=(b, 24)).astype(np.int32)
    seg = (rng.random((b, 24)) > 0.2).astype(np.int32)
    img_src = np.where(rng.random((b, 24)) > 0.7, 3, -1).astype(np.int32)
    got_p = tspec.history_from_prompt(_t(tokens), _t(seg), _t(img_src), 40)
    want_p = jspec.history_from_prompt(jnp.asarray(tokens), jnp.asarray(seg),
                                       jnp.asarray(img_src), 40)
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_propose_ngram_cases_of_the_jax_tests():
    """The three hand-made histories of tests/test_spec_decode.py."""
    cases = [([5, 6, 7, 8, 9, 5, 6, -1, -1, -1], 6, 3, [7, 8, 9]),
             ([1, 2, 3, 4, -1, -1], 3, 2, [0, 0]),
             ([-1, -1, 0, 9, 0, 9, -1, -1], 5, 2, [0, 9])]
    for hist, widx, k, want in cases:
        got = tspec.propose_ngram(_t([hist]), _t([widx]), k)
        assert got.tolist() == [want]


# --------------------------------------------------------- the verify window


@pytest.fixture(scope="module")
def text_model():
    cfg = _tiny_config().text
    params = jax.tree.map(np.asarray, jqwen.init_params(cfg, jax.random.key(0)))
    model = tqwen.Qwen2Decoder(cfg, dtype=torch.float32)
    convert.load_qwen2(model, params)
    return cfg, params, model


@pytest.mark.parametrize("cache_format", ["bf16", "int8"])
def test_verify_window_matches_stepwise_decode(text_model, cache_format):
    """One (k + 1)-wide cached forward at per-row offsets (rows at different
    offsets after their own left padding) against k + 1 single-token steps,
    and against the JAX package's window forward on the same inputs."""
    cfg, params, model = text_model
    b, prompt_len, max_len, k = 2, 8, 64, 3
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab_size, size=(b, prompt_len))
    window = rng.integers(3, cfg.vocab_size, size=(b, k + 1))
    pad = np.array([0, 3])  # row 1 is left-padded by 3
    seg0 = (np.arange(prompt_len)[None] >= pad[:, None]).astype(np.int32)
    pos0 = np.maximum(np.arange(prompt_len)[None] - pad[:, None], 0)
    offs = np.full((b,), prompt_len, np.int32)
    real = prompt_len - pad

    def t_prefill():
        init = tqwen.init_kv_cache_q8 if cache_format == "int8" else tqwen.init_kv_cache
        cache = init(cfg, b, max_len)
        seg = torch.zeros((b, max_len), dtype=torch.int32)
        seg[:, :prompt_len] = _t(seg0)
        with torch.inference_mode():
            tqwen.forward(model, cfg, input_embeds=tqwen.embed_tokens(model, _t(prompt), cfg),
                          positions=_t(pos0), segment_ids=_t(seg0), kv_cache=cache,
                          cache_index=0, cache_segment_ids=seg, attn_impl="xla")
        return cache, seg

    rows = torch.arange(b)
    cache_a, seg_a = t_prefill()
    step_logits = []
    with torch.inference_mode():
        for j in range(k + 1):
            idx = _t(offs + j)
            seg_a[rows, idx.long()] = 1
            lg, _ = tqwen.forward(
                model, cfg, input_embeds=tqwen.embed_tokens(model, _t(window[:, j:j + 1]), cfg),
                positions=_t(real + j)[:, None], segment_ids=torch.ones((b, 1), dtype=torch.int32),
                kv_cache=cache_a, cache_index=idx, cache_segment_ids=seg_a)
            step_logits.append(lg[:, 0])
        cache_b, seg_b = t_prefill()
        idxw = _t(offs)[:, None].long() + torch.arange(k + 1)[None]
        seg_b[rows[:, None], idxw] = 1
        lg_w, _ = tqwen.forward(
            model, cfg, input_embeds=tqwen.embed_tokens(model, _t(window), cfg),
            positions=_t(real)[:, None] + torch.arange(k + 1)[None],
            segment_ids=torch.ones((b, k + 1), dtype=torch.int32),
            kv_cache=cache_b, cache_index=_t(offs), cache_segment_ids=seg_b)
    assert tqwen.cached_attention_route(cfg, max_len, "auto", k + 1, True,
                                        cache_format == "int8").startswith("window")
    for j in range(k + 1):
        np.testing.assert_allclose(lg_w[:, j].numpy(), step_logits[j].numpy(),
                                   rtol=2e-2, atol=2e-2)
    for ca, cb in zip(cache_a, cache_b):
        np.testing.assert_allclose(ca.float().numpy(), cb.float().numpy(), rtol=2e-2, atol=2e-2)

    # The JAX package's window forward (its XLA route) on the same inputs.
    init = jqwen.init_kv_cache_q8 if cache_format == "int8" else jqwen.init_kv_cache
    jcache = init(cfg, b, max_len)
    jseg = jnp.zeros((b, max_len), jnp.int32).at[:, :prompt_len].set(jnp.asarray(seg0))
    _, jcache = jqwen.forward(
        params, cfg, input_embeds=jqwen.embed_tokens(params, jnp.asarray(prompt), cfg),
        positions=jnp.asarray(pos0), segment_ids=jnp.asarray(seg0), kv_cache=jcache,
        cache_index=0, cache_segment_ids=jseg, attn_impl="xla")
    jidxw = jnp.asarray(offs)[:, None] + jnp.arange(k + 1)[None]
    jseg = jseg.at[jnp.arange(b)[:, None], jidxw].set(1)
    jlg, _ = jqwen.forward(
        params, cfg, input_embeds=jqwen.embed_tokens(params, jnp.asarray(window), cfg),
        positions=jnp.asarray(real)[:, None] + jnp.arange(k + 1)[None],
        segment_ids=jnp.ones((b, k + 1), jnp.int32), kv_cache=jcache,
        cache_index=jnp.asarray(offs), cache_segment_ids=jseg, attn_impl="xla")
    np.testing.assert_allclose(lg_w.numpy(), np.asarray(jlg, np.float32), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(7)))
    return cfg, params, convert.radvlm_from_jax(params, cfg, device="cpu")


def _mk_sample(mm, cfg, seed, n_text):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
    ids = [int(t) for t in rng.integers(3, cfg.text.vocab_size, size=n_text)]
    return mm.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg)


def _run(batcher, samples, new, **kw):
    reqs = [batcher.submit(s, new, **kw) for s in samples]
    list(batcher.run())
    return [list(r.emitted) for r in reqs]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_engine_tokens_equal_plain_and_jax(tiny, kv_quant, spec_k):
    """Four requests over two slots (refills), 4-step chunks."""
    cfg, params, model = tiny
    new = 12
    lens = (6, 11, 8, 14)
    tgen = teng.GenerationConfig(max_new_tokens=new, eos_token_ids=())
    samples = [_mk_sample(tmm, cfg, n, n) for n in lens]
    plain = _run(TBatcher(model, cfg, tgen, kv_quant=kv_quant, **ENGINE), samples, new)
    sb = TBatcher(model, cfg, tgen, kv_quant=kv_quant, spec_k=spec_k, **ENGINE)
    got = _run(sb, samples, new)
    assert got == plain
    assert all(len(e) == new for e in got)
    assert sb.spec_stats["emitted"] >= sb.spec_stats["verify_steps"] > 0
    jb = JBatcher(params, cfg, jeng.GenerationConfig(max_new_tokens=new, eos_token_ids=()),
                  attn_impl="xla", kv_quant=kv_quant, spec_k=spec_k, **ENGINE)
    assert got == _run(jb, [_mk_sample(jmm, cfg, n, n) for n in lens], new)


def test_spec_eos_and_max_new_respected(tiny):
    cfg, _, model = tiny
    sample = _mk_sample(tmm, cfg, 6, 6)
    one = dict(ENGINE, num_slots=1)
    ref = _run(TBatcher(model, cfg, teng.GenerationConfig(max_new_tokens=6), **one),
               [sample], 6)[0]
    # The 3rd greedy token is eos: the spec engine stops there even if a
    # verify window accepted past it.
    gen = teng.GenerationConfig(max_new_tokens=6, eos_token_ids=(ref[2],))
    assert _run(TBatcher(model, cfg, gen, spec_k=3, **one), [sample], 6)[0] == ref[:2]
    # max_new keeps spec_k cache entries free: 256-cache, 128-bucket, spec_k 3.
    gen = teng.GenerationConfig(max_new_tokens=500)
    out = _run(TBatcher(model, cfg, gen, spec_k=3, **one), [sample], 500)[0]
    assert len(out) == 256 - 128 + 1 - 3


def test_spec_engine_serves_a_sampling_request(tiny):
    """A temperature > 0 request sends the chunks to the sampling variant,
    which carries the spec state; the greedy request beside it still gives
    the plain greedy tokens."""
    cfg, _, model = tiny
    gen = teng.GenerationConfig(max_new_tokens=8)
    sample = _mk_sample(tmm, cfg, 9, 9)
    b = TBatcher(model, cfg, gen, spec_k=3, **ENGINE)
    greedy = b.submit(sample, 8)
    hot = b.submit(sample, 8, temperature=5.0, top_p=1.0)
    list(b.run())
    assert len(hot.emitted) == 8
    assert greedy.emitted == _run(TBatcher(model, cfg, gen, **ENGINE), [sample], 8)[0]
    # ... and once the sampling request is gone the verify chunks come back.
    again = b.submit(sample, 8)
    list(b.run())
    assert again.emitted == greedy.emitted


def test_spec_acceptance_on_a_repetitive_stream():
    """A 16-token vocabulary falls into a greedy loop: prompt lookup then
    accepts whole windows (more tokens emitted than verify steps), and the
    tokens stay the plain greedy ones and the JAX spec engine's."""
    cfg = cfglib.tiny_test_config(vocab_size=16)
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(1)))
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    rng = np.random.default_rng(12345)
    img = rng.integers(0, 255, size=(80, 64, 3), dtype=np.uint8)
    ids = [3, IMAGE_TOKEN_INDEX] + [int(t) for t in rng.integers(3, 16, size=6)]
    gen = teng.GenerationConfig(max_new_tokens=48)
    one = dict(ENGINE, num_slots=1)
    ref = _run(TBatcher(model, cfg, gen, **one), [tmm.build_sample(ids, [img], cfg)], 48)[0]
    bigrams = list(zip(ref, ref[1:]))
    assert len(set(bigrams)) < len(bigrams), "the greedy stream no longer loops"
    b = TBatcher(model, cfg, gen, spec_k=4, **one)
    assert _run(b, [tmm.build_sample(ids, [img], cfg)], 48)[0] == ref
    assert b.spec_stats["emitted"] > b.spec_stats["verify_steps"], b.spec_stats
    jb = JBatcher(params, cfg, jeng.GenerationConfig(max_new_tokens=48, eos_token_ids=()),
                  attn_impl="xla", spec_k=4, **one)
    assert _run(jb, [jmm.build_sample(ids, [img], cfg)], 48)[0] == ref
    assert jb.spec_stats == b.spec_stats


def test_spec_k_default_and_provenance(tiny, monkeypatch):
    cfg, _, model = tiny
    gen = teng.GenerationConfig(max_new_tokens=4)
    monkeypatch.setenv("RADVLM_SPEC_K", "3")
    assert TBatcher(model, cfg, gen, **ENGINE).spec_k == 3
    assert TBatcher(model, cfg, gen, spec_k=0, **ENGINE).spec_k == 0
    monkeypatch.delenv("RADVLM_SPEC_K")
    plain = TBatcher(model, cfg, gen, **ENGINE)
    assert plain.spec_k == 0 and "verify_attention" not in plain.kernel_provenance()
    prov = TBatcher(model, cfg, gen, spec_k=4, kv_quant=True, **ENGINE).kernel_provenance()
    assert prov["verify_attention"] == "window_q8" and prov["decode_attention"] == "kernel_q8"
    prov = TBatcher(model, cfg, gen, spec_k=4, **ENGINE).kernel_provenance()
    assert prov["verify_attention"] == "window"
    # Past 16 queries, or where the decode kernels do not serve, the window is plain.
    assert TBatcher(model, cfg, gen, spec_k=16, **ENGINE).kernel_provenance()[
        "verify_attention"] == "plain"
    assert TBatcher(model, cfg, gen, spec_k=4, attn_impl="xla", **ENGINE).kernel_provenance()[
        "verify_attention"] == "plain"
    # The int8 7B engine of 8 slots: 40 verify rows stay on the int8 decode matmul.
    q8 = teng.kernel_provenance(cfglib.radvlm_7b(), prompt_len=4096, max_new_tokens=128,
                                quantized=True, cache_format="int8", decode_rows=8, spec_k=4)
    assert (q8["verify_attention"], q8["verify_matmul"], q8["verify_lm_head"]) == (
        "window_q8", "int8", "int8")
    wide = teng.kernel_provenance(cfglib.radvlm_7b(), prompt_len=4096, max_new_tokens=128,
                                  quantized=True, cache_format="int8", decode_rows=32, spec_k=4)
    assert wide["verify_matmul"] == "dequant"
