"""The decoder's family knobs in the port against the JAX package, at
`tiny_test_config` sizes: Mistral's sliding window (8 keys under a
24-token prompt, so the windowed plain attention route runs), Gemma's GeGLU,
zero-centred norms and embedding normaliser, Llama-3 rope scaling (factor 8)
and linear rope scaling (factor 2).

For each family: left-padded prefill logits and the collected bf16 K/V,
one cached decode step, and `hf_import.config_from_hf_dir` on a small
config.json of that family, field by field against the JAX package's.
Tolerances as in test_torch_models.py: 1e-4 on f32 logits, one bf16
rounding on cache entries, 5e-4 on logits read through the bf16 cache.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import hf_import as jhf
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu_torch.models import convert, hf_import, qwen2

TOL = dict(atol=1e-4, rtol=1e-4)

FAMILIES = {
    "mistral": dict(sliding_window=8, attention_bias=False),
    "gemma": dict(hidden_act="gelu_tanh", rms_norm_offset=True, embed_normalizer=True,
                  attention_bias=False),
    "llama3": dict(rope_scaling_type="llama3", rope_scaling=8.0, attention_bias=False),
    "linear_rope": dict(rope_scaling=2.0),
}

# A config.json of each family at the tiny text sizes (two flat, two in the
# LLaVA layout with text_config / vision_config).
TEXT_SIZES = dict(vocab_size=300, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=12,
                  max_position_embeddings=2048)
HF_CONFIGS = {
    "mistral": dict(model_type="mistral", sliding_window=8, rope_theta=1e6, **TEXT_SIZES),
    "gemma": dict(model_type="gemma", rms_norm_eps=1e-6, **TEXT_SIZES),
    "llama3": {"text_config": dict(model_type="llama", rope_theta=5e5, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}, **TEXT_SIZES),
        "vision_config": dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, image_size=56, patch_size=14),
        "image_grid_pinpoints": [[56, 112], [112, 56], [112, 112]],
        "image_aspect_ratio": "anyres_max_4"},
    "linear_rope": {"text_config": dict(model_type="qwen2", tie_word_embeddings=True,
                                        rope_scaling={"type": "linear", "factor": 2.0},
                                        **TEXT_SIZES),
                    "vision_config": dict(image_size=384, patch_size=14)},
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    base = cfglib.tiny_test_config(vocab_size=300)
    text = dataclasses.replace(base.text, **FAMILIES[request.param])
    params = _np_tree(jq.init_params(text, jax.random.key(0)))
    # Non-trivial norms and biases (Gemma's norms are zero-centred: 0 is 1).
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale") for k in p)
        else x,
        params,
    )
    model = qwen2.Qwen2Decoder(text)
    convert.load_qwen2(model, params)
    return request.param, text, params, model


def _batch(rng, text, b=2, s=24, pad=(5, 0)):
    tokens = rng.integers(2, text.vocab_size, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for i, p in enumerate(pad):
        seg[i, :p] = 0
        pos[i, p:] = np.arange(s - p)
    return tokens, seg, pos


def test_family_prefill_logits_and_kv_match_jax(rng, family):
    _, text, params, model = family
    tokens, seg, pos = _batch(rng, text)
    ref, (rk, rv) = jq.forward(params, text, input_embeds=jq.embed_tokens(
        params, jnp.asarray(tokens), text), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), collect_kv=True)
    out, (k, v) = qwen2.forward(model, text, input_embeds=qwen2.embed_tokens(
        model, torch.from_numpy(tokens), text), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg), collect_kv=True)
    real = seg != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)
    for a, r in ((k, rk), (v, rv)):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        np.testing.assert_allclose(a.float().numpy()[:, real], np.asarray(r, np.float32)[:, real],
                                   atol=1e-5, rtol=2 ** -7)


def test_family_cached_decode_step_matches_jax(rng, family):
    name, text, params, model = family
    tokens, seg, pos = _batch(rng, text)
    b, l = tokens.shape
    max_len = 64
    _, (rk, rv) = jq.forward(params, text, input_embeds=jq.embed_tokens(
        params, jnp.asarray(tokens), text), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), collect_kv=True)
    ck, cv = jq.init_kv_cache(text, b, max_len)
    ck, cv = ck.at[:, :, :l].set(rk), cv.at[:, :, :l].set(rv)
    cache_seg = np.zeros((b, max_len), np.int32)
    cache_seg[:, :l] = seg
    cache_seg[:, l] = 1
    tok = rng.integers(2, text.vocab_size, (b, 1)).astype(np.int32)
    dpos = pos[:, -1:] + 1
    ref, _ = jq.forward(params, text, input_embeds=jq.embed_tokens(params, jnp.asarray(tok), text),
                        positions=jnp.asarray(dpos), segment_ids=jnp.ones((b, 1), jnp.int32),
                        kv_cache=(ck, cv), cache_index=jnp.int32(l),
                        cache_segment_ids=jnp.asarray(cache_seg))
    # The decode kernel has no window mask: Mistral's step takes the plain route.
    assert qwen2.decode_kernel_eligible(text, max_len, "auto") == (name != "mistral")
    tck = torch.from_numpy(np.asarray(ck, np.float32)).to(torch.bfloat16)
    tcv = torch.from_numpy(np.asarray(cv, np.float32)).to(torch.bfloat16)
    out, _ = qwen2.forward(
        model, text, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(tok), text),
        positions=torch.from_numpy(dpos), segment_ids=torch.ones(b, 1, dtype=torch.int32),
        kv_cache=(tck, tcv), cache_index=l, cache_segment_ids=torch.from_numpy(cache_seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=1e-3)


def _same_fields(port, ref, path="cfg"):
    """Every field of the port's config dataclass equals the JAX one's."""
    for f in dataclasses.fields(port):
        a, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, r, f"{path}.{f.name}")
        else:
            assert a == r, (f"{path}.{f.name}", a, r)


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_dir_matches_jax(tmp_path, name):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(HF_CONFIGS[name], f)
    port, ref = hf_import.config_from_hf_dir(str(tmp_path)), jhf.config_from_hf_dir(str(tmp_path))
    _same_fields(port, ref)
    knobs = {k: getattr(port.text, k) for k in FAMILIES[name] if k != "rope_scaling"}
    assert knobs == {k: v for k, v in FAMILIES[name].items() if k != "rope_scaling"}
    assert port.text.rope_scaling == FAMILIES[name].get("rope_scaling", 1.0)
