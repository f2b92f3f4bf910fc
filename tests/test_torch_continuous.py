"""The port's continuous engine and batch worker against the JAX package at
the tiny config with int8 weights (the JAX `quantize_params` output, brought
over by the weight bridge).

- `ContinuousBatcher`: the greedy `emitted` list of every request equals the
  JAX `ContinuousBatcher`'s, with the int8 and the bf16 KV cache, fill
  groups of 1 and 2, more requests than slots (refills), 4-step chunks two
  deep in flight, an eos id that fires mid-chunk and a request capped by the
  cache. Identical tokens, no tolerance: greedy argmax over logits that
  agree to ~1e-4 (tests/test_torch_int8.py). Its `kernel_provenance` names
  the matmul routes at the row counts the projections are given.
- `sample_token_vec`: the per-row top-k/top-p keep masks equal JAX's exactly
  (the JAX side's masked logits are read where it hands them to
  `jax.random.categorical`); the draws are checked statistically only (the
  two generators differ).
- `BatchWorker` over localhost HTTP: `generate` and `generate_stream` return
  the text of the engine's greedy tokens; a bad request gets error_code 1
  and an engine error fails only the requests in flight, while the worker
  stays up.
"""

import base64
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch.eval.harness import VLMRunner
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.ops.quant import qmm_route
from radvlm_tpu_torch.serve.batch_worker import BatchWorker

NEW = 9
ENGINE = dict(num_slots=2, max_len=256, prompt_buckets=(128, 256), pad_tiles=2,
              steps_per_sync=4, pipeline_depth=2)


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


@pytest.fixture(scope="module")
def tiny_q():
    cfg = cfglib.tiny_test_config()
    params = jrad.init_params(cfg, jax.random.key(7))
    return cfg, jax.tree.map(np.asarray, jquant.quantize_params(params))


def _samples(mm, cfg):
    """Five prompts of the 128 bucket and one of the 256 bucket, which the
    256-slot cache caps at one token."""
    out = []
    for n in (6, 11, 8, 14, 7, 150):
        r = np.random.default_rng(n)
        img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
        ids = list(r.integers(3, cfg.text.vocab_size, size=n))
        out.append(mm.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg))
    assert out[-1].length > 128
    return out


def _run_port(cfg, params, eos, **kw):
    b = TBatcher(convert.radvlm_from_jax(params, cfg), cfg,
                 teng.GenerationConfig(max_new_tokens=NEW, eos_token_ids=eos), **ENGINE, **kw)
    reqs = [b.submit(s) for s in _samples(tmm, cfg)]
    done = {r.uid: r.emitted for r in b.run()}
    return [done[r.uid] for r in reqs]


@pytest.mark.parametrize("kv_quant", [True, False])
@pytest.mark.parametrize("fill_batch", [1, 2])
def test_tokens_identical_to_jax_batcher(tiny_q, kv_quant, fill_batch):
    cfg, params = tiny_q
    free = _run_port(cfg, params, (), kv_quant=kv_quant, fill_batch=fill_batch)
    eos = (free[1][2],)  # the second token of the first decode chunk of request 1
    got = _run_port(cfg, params, eos, kv_quant=kv_quant, fill_batch=fill_batch)
    jb = JBatcher(params, cfg, jeng.GenerationConfig(max_new_tokens=NEW, eos_token_ids=eos),
                  attn_impl="xla", kv_quant=kv_quant, fill_batch=fill_batch, **ENGINE)
    reqs = [jb.submit(s) for s in _samples(jmm, cfg)]
    done = {r.uid: r.emitted for r in jb.run()}
    expected = [done[r.uid] for r in reqs]
    assert got == expected
    assert len(got[1]) == 2 and got[1] == free[1][:2]  # eos cut request 1 mid-chunk
    assert len(got[-1]) == 1  # capped by the cache: 256 - 256 + 1 tokens
    assert max(len(e) for e in got) == NEW


def test_provenance_reads_the_row_counts_the_matmuls_see(tiny_q):
    """`ContinuousBatcher.kernel_provenance` routes each int8 matmul stage
    at the row count the engine's projections are given: the tower takes a
    fill group's tiles in one batch (2 x 6 tiles x 16 tokens: W8A8, where one
    tile alone would go weight-only), the prompt W8A8, decode weight-only."""
    cfg, params = tiny_q
    model = convert.radvlm_from_jax(params, cfg)
    b = TBatcher(model, cfg, teng.GenerationConfig(max_new_tokens=5),
                 **dict(ENGINE, pad_tiles=6), fill_batch=2, kv_quant=True)
    rows = {"tower": set(), "text": set()}

    def spy(stage):
        return lambda mod, args: rows[stage].add(args[0].numel() // args[0].shape[-1])

    model.vision_tower.layers[0].fc1.register_forward_pre_hook(spy("tower"))
    model.text.layers[0].o.register_forward_pre_hook(spy("text"))
    for s in _samples(tmm, cfg)[:2]:
        b.submit(s)
    list(b.run())
    prov = b.kernel_provenance()
    assert rows["tower"] == {2 * 6 * 16}
    assert prov["tower_matmul"] == qmm_route(2 * 6 * 16) == "w8a8" != qmm_route(16)
    assert rows["text"] == {2 * 128, 2}  # one fill of two prompts, then decode steps
    assert prov["prefill_matmul"] == qmm_route(2 * 128) == "w8a8"
    assert prov["decode_matmul"] == qmm_route(2, False) == "int8"


def test_sampling_masks_match_jax(rng, monkeypatch):
    """Per-row temperature and top-p, and a top-k: the same -inf pattern
    and the same finite tempered logits as JAX's; greedy rows take the
    argmax."""
    logits = rng.normal(size=(5, 40)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 2.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 0.1, 1.0], np.float32)
    for top_k in (0, 7):
        seen = {}

        def grab(key, lg, axis=-1):
            seen["logits"] = np.asarray(lg)
            return jnp.zeros(lg.shape[0], jnp.int32)

        monkeypatch.setattr(jax.random, "categorical", grab)
        jtok = jeng.sample_token_vec(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p),
                                     jax.random.key(0), top_k=top_k)
        mine = teng.sampling_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                                    torch.from_numpy(top_p), top_k).numpy()
        np.testing.assert_array_equal(np.isfinite(mine), np.isfinite(seen["logits"]))
        keep = np.isfinite(mine)
        np.testing.assert_allclose(mine[keep], seen["logits"][keep], rtol=1e-6)
        assert np.asarray(jtok)[0] == logits[0].argmax()
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([teng.sample_token_vec(torch.from_numpy(logits), torch.from_numpy(temp),
                                            torch.from_numpy(top_p), gen).numpy()
                      for _ in range(2000)])
    assert np.all(draws[:, 0] == logits[0].argmax())
    kept = teng.sampling_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                                torch.from_numpy(top_p)).numpy()  # top_k = 0, as drawn
    assert np.all(np.isfinite(kept[np.arange(5)[None, :].repeat(2000, 0), draws]))
    # Row 4 (temperature 2, no cut): the draw frequencies follow softmax(l / 2).
    p = np.exp(logits[4] / 2 - (logits[4] / 2).max())
    p /= p.sum()
    freq = np.bincount(draws[:, 4], minlength=40) / len(draws)
    assert np.abs(freq - p).max() < 0.04


def _png_b64(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, path, obj, raw=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=raw if raw is not None else json.dumps(obj).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
    except urllib.error.HTTPError as e:
        body = e.read()
    if path.endswith("_stream"):
        return [json.loads(c) for c in body.split(b"\0") if c]
    return json.loads(body)


def test_batch_worker_over_http(tiny_q):
    cfg, params = tiny_q
    tok = ByteTokenizer()
    runner = VLMRunner(model=convert.radvlm_from_jax(params, cfg), cfg=cfg, tokenizer=tok,
                       max_new_tokens=NEW, pad_to_multiple=128)
    engine_kw = dict(num_slots=2, max_len=256, prompt_bucket=128, kv_quant=True, pad_tiles=2,
                     steps_per_sync=4)
    worker = BatchWorker(runner, model_names=["tiny"], **engine_kw)
    assert worker.warmup_seconds > 0 and set(worker.batcher.warmup_timings) >= {
        "fill_128_x1", "decode_greedy", "decode_sampling"}
    img = np.random.default_rng(3).integers(0, 255, (90, 70, 3), dtype=np.uint8)
    prompts = ["<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n",
               "<|im_start|>user\n<image>\nAny effusion?<|im_end|>\n<|im_start|>assistant\n"]
    # The engine's own greedy tokens for each prompt, without the worker.
    ref = TBatcher(runner.model, cfg, teng.GenerationConfig(max_new_tokens=5, eos_token_ids=(1,)),
                   num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2,
                   steps_per_sync=4, kv_quant=True)
    reqs = [ref.submit(tmm.build_sample(tmm.tokenize_with_images(tok.encode, p), [img], cfg), 5)
            for p in prompts]
    list(ref.run())
    expected = [teng.trim_at_stop_strings(tok.decode(r.emitted), runner.template.stop_strings)
                for r in reqs]
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    try:
        for p, exp in zip(prompts, expected):
            body = {"prompt": p, "images": [_png_b64(img)], "max_new_tokens": 5}
            assert _post(port, "/worker_generate", body) == {"text": exp, "error_code": 0}
            chunks = _post(port, "/worker_generate_stream", body)
            assert chunks and all(c["error_code"] == 0 for c in chunks)
            assert chunks[-1]["text"] == exp
        # Bad requests: an over-long prompt and a malformed body.
        long = {"prompt": "x" * 400, "max_new_tokens": 3}
        assert _post(port, "/worker_generate", long)["error_code"] == 1
        assert _post(port, "/worker_generate_stream", long)[-1]["error_code"] == 1
        assert _post(port, "/worker_generate", None, raw=b"{nope")["error_code"] == 1
        # An engine error fails the request in flight; the loop carries on.
        real = worker.batcher._dispatch_chunk
        calls = []

        def flaky(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected")
            return real(*a, **kw)

        worker.batcher._dispatch_chunk = flaky
        body = {"prompt": prompts[0], "images": [_png_b64(img)], "max_new_tokens": 5}
        failed = _post(port, "/worker_generate", body)
        assert failed["error_code"] == 1 and "injected" in failed["text"]
        assert _post(port, "/worker_generate", body) == {"text": expected[0], "error_code": 0}
        status = _post(port, "/worker_get_status", {})
        assert status["model_names"] == ["tiny"] and status["queue_length"] == 0
    finally:
        worker.shutdown()
    assert not worker._engine_thread.is_alive()
