"""The MPT family in the port against the JAX package: ALiBi instead of
rope, weight-only LayerNorm, a non-gated exact-GELU MLP, MHA, a tied
lm_head (the JAX tests/test_mpt_parity.py MPT_TINY, and a 6-head copy whose
ALiBi slopes take the odd-first interleave). Weights are the JAX package's
init, moved across by `models/convert.py`; inputs come from numpy with a
seed.

- `alibi_head_slopes` for 8 and 12 heads: exactly the JAX function's;
- forward logits in f32: atol / rtol 1e-5;
- cached decode, token by token after an 8-token prefill, against the full
  forward: the f32 cache at the JAX test's 2e-4 / 2e-3, the bf16 and the
  int8 cache at 2e-2 of the logits' scale / 5e-3;
- greedy tokens of a tiny MPT `RadVLM` through `ContinuousBatcher` (int8
  weights, the int8 cache, `RADVLM_W8A8=0`) equal the JAX engine's, and
  its `kernel_provenance` reports plain prefill and decode attention (no
  kernel takes ALiBi) beside K1 for the tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX, Qwen2Config
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import attention as jatt
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert, qwen2
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.ops import attention as tatt

MPT_TINY = Qwen2Config(
    vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=8, rms_norm_eps=1e-5, attention_bias=False,
    tie_word_embeddings=True, hidden_act="gelu", pos_embedding="alibi", norm_kind="layernorm",
    mlp_gated=False, max_position_embeddings=512,
)
CONFIGS = {"4_heads": MPT_TINY,
           "6_heads": dataclasses.replace(MPT_TINY, hidden_size=48, num_heads=6, num_kv_heads=6)}
MPT_FIELDS = ("num_kv_heads", "attention_bias", "tie_word_embeddings", "hidden_act",
              "pos_embedding", "norm_kind", "mlp_gated", "rms_norm_eps")


@pytest.mark.parametrize("heads", [8, 12])
def test_alibi_slopes_equal_jax(heads):
    got = tatt.alibi_head_slopes(heads).numpy()
    np.testing.assert_array_equal(got, np.asarray(jatt.alibi_head_slopes(heads)))
    bias = tatt.alibi_bias(heads, 7)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jatt.alibi_bias(heads, 7)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models' small ops: several test
    workers share the cores, and PyTorch's thread pools contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def decoder(request):
    cfg = CONFIGS[request.param]
    params = jax.tree.map(np.asarray, jq.init_params(cfg, jax.random.key(0)))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("ln1", "ln2", "norm") for k in p) else x,
        params,
    )
    model = qwen2.Qwen2Decoder(cfg)
    convert.load_qwen2(model, params)
    return cfg, params, model


def _ids(seed=0, b=2, s=48):
    ids = np.random.default_rng(seed).integers(0, 128, (b, s))
    return ids, np.tile(np.arange(s)[None], (b, 1)), np.ones((b, s), np.int32)


def _port_logits(model, cfg, ids, pos, seg):
    out, _ = qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(
        model, torch.from_numpy(ids), cfg), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg))
    return out.numpy()


def test_mpt_logits_match_jax(decoder):
    cfg, params, model = decoder
    blk = model.layers[0]
    assert not hasattr(blk, "gate") and model.lm_head is None
    ids, pos, seg = _ids()
    ref, _ = jq.forward(params, cfg, input_embeds=jq.embed_tokens(params, jnp.asarray(ids), cfg),
                        positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                        attn_impl="xla")
    got = _port_logits(model, cfg, ids, pos, seg)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)
    # ALiBi matters: without it the logits move.
    flat = _port_logits(model, dataclasses.replace(cfg, pos_embedding="none"), ids, pos, seg)
    assert np.abs(flat - got).max() > 1e-3


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_mpt_cached_decode_matches_full_forward(decoder, kv):
    cfg, _, model = decoder
    ids, pos, seg = _ids(seed=2, b=1, s=40)
    full = _port_logits(model, cfg, ids, pos, seg)
    max_len, n0 = 64, 8
    if kv == "int8":
        cache = qwen2.init_kv_cache_q8(cfg, 1, max_len)
    else:
        cache = qwen2.init_kv_cache(cfg, 1, max_len,
                                    dtype=torch.float32 if kv == "f32" else torch.bfloat16)
    cache_seg = torch.zeros(1, max_len, dtype=torch.int32)
    cache_seg[:, :n0] = 1
    qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(ids[:, :n0]),
                  cfg), positions=torch.from_numpy(pos[:, :n0]),
                  segment_ids=torch.from_numpy(seg[:, :n0]), kv_cache=cache, cache_index=0,
                  cache_segment_ids=cache_seg)
    tol = (dict(atol=2e-4, rtol=2e-3) if kv == "f32"
           else dict(atol=2e-2 * np.abs(full).max(), rtol=5e-3))
    for i in range(n0, ids.shape[1]):
        cache_seg[:, i] = 1
        # Scalar offsets and per-row ones alternate: both write paths run.
        index = i if i % 2 else torch.tensor([i])
        out, _ = qwen2.forward(
            model, cfg, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(ids[:, i:i + 1]),
                                                        cfg),
            positions=torch.tensor([[i]]), segment_ids=torch.ones(1, 1, dtype=torch.int32),
            kv_cache=cache, cache_index=index, cache_segment_ids=cache_seg)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, i], **tol)


def _tiny_mpt():
    base = cfglib.tiny_test_config()
    text = dataclasses.replace(base.text, num_kv_heads=base.text.num_heads,
                               **{f: getattr(MPT_TINY, f) for f in MPT_FIELDS[1:]})
    return dataclasses.replace(base, text=text)


def _samples(mod, cfg):
    out = []
    for n in (6, 11, 8):
        r = np.random.default_rng(n)
        img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
        ids = list(r.integers(3, cfg.text.vocab_size, size=n))
        out.append(mod.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg))
    return out


ENGINE = dict(num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2, steps_per_sync=4,
              pipeline_depth=2)


def test_engine_tokens_identical_to_jax(monkeypatch):
    monkeypatch.setenv("RADVLM_W8A8", "0")
    cfg = _tiny_mpt()
    params = jax.tree.map(np.asarray,
                          jquant.quantize_params(jrad.init_params(cfg, jax.random.key(7))))
    assert "gate" not in params["text"]["layers"]["mlp"]
    gen = dict(max_new_tokens=6)
    tb = TBatcher(convert.radvlm_from_jax(params, cfg, device="cpu"), cfg,
                  teng.GenerationConfig(**gen), kv_quant=True, **ENGINE)
    treqs = [tb.submit(s) for s in _samples(tmm, cfg)]
    tdone = {r.uid: r.emitted for r in tb.run()}
    jb = JBatcher(params, cfg, jeng.GenerationConfig(**gen), attn_impl="xla", kv_quant=True,
                  **ENGINE)
    jreqs = [jb.submit(s) for s in _samples(jmm, cfg)]
    jdone = {r.uid: r.emitted for r in jb.run()}
    got, want = [tdone[r.uid] for r in treqs], [jdone[r.uid] for r in jreqs]
    assert got == want and all(len(e) == 6 for e in got)
    prov = tb.kernel_provenance()
    assert prov["prefill_attention"] == prov["decode_attention"] == "plain"
    assert prov["tower_attention"] == "kernel"
    # The same geometry at the card's head dim: the kernels would take the
    # heads, and ALiBi alone sends both stages to the plain path.
    wide = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, head_dim=128))
    prov = teng.kernel_provenance(wide, prompt_len=1024, max_new_tokens=32, quantized=True,
                                  cache_format="int8", decode_rows=8)
    assert prov["prefill_attention"] == prov["decode_attention"] == "plain"
    rope = dataclasses.replace(wide, text=dataclasses.replace(wide.text, pos_embedding="rope"))
    prov = teng.kernel_provenance(rope, prompt_len=1024, max_new_tokens=32, quantized=True,
                                  cache_format="int8", decode_rows=8)
    assert prov["prefill_attention"] == "kernel" and prov["decode_attention"] == "kernel_q8"
