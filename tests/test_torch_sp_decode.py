"""Sequence-parallel generation on two spawned gloo ranks against the JAX
package at the tiny config (f32 weights):

- `make_sp_generate_fn` (the ring prefill, then decode over a cache split
  along the sequence) emits the JAX `make_sp_generate_fn`'s greedy tokens
  (virtual mesh, seq = 2) and the port's one-process `make_generate_fn`'s,
  over the bf16 cache; the int8 cache gives the same tokens;
- the ring prefill's segment ids equal `engine.prefill`'s, its logits to
  1e-5, its bf16 cache to one bf16 rounding step at the non-padding
  positions (a padding position attends nothing: the ring writes 0 there,
  plain attention the mean of v, so later layers' K/V differ there);
- SP decode steps over the split cache give the plain cached step's logits
  on the whole cache, bf16 and int8, within the JAX package's SP-decode
  tolerance (5e-4 + 2e-3 of the logits' scale: plain attention rounds its
  probabilities to the cache's bf16, the merge keeps them f32), also for a
  prompt so left-padded that one rank's block is all padding (the merge's
  -finfo.max sentinel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from radvlm_tpu import config as jcfg
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.parallel.mesh import make_mesh as jmake_mesh
from radvlm_tpu.parallel.ring import enable_ring_attention as jenable_ring
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.models import convert

NEW, EXTRA = 4, 64


def _batches(cfg):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, size=(70, 60, 3), dtype=np.uint8)
    image_prompt = jmm.build_sample([5, IMAGE_TOKEN_INDEX] + list(rng.integers(2, 400, size=50)),
                                    [img], cfg)
    tiny_prompt = jmm.build_sample([5] + list(rng.integers(2, 400, size=6)), [], cfg)
    return [jmm.collate([s], pad_len=256, pad_to_multiple=256, left_pad=True)
            for s in (image_prompt, tiny_prompt)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jcfg.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    batches = _batches(cfg)
    payload = dict(cfg=tiny_test_config(), params=params, batches=batches, new=NEW, extra=EXTRA)
    ranks = torch_dist.run(torch_dist.sp_generate, 2, payload, tmp_path_factory.mktemp("sp2"))
    return cfg, params, batches, ranks


def test_sp_generate_tokens_equal_jax_and_plain(setup):
    cfg, params, batches, ranks = setup
    gen = jeng.GenerationConfig(max_new_tokens=NEW, eos_token_ids=())
    mesh = jmake_mesh({"seq": 2}, devices=jax.devices()[:2])
    tcfg = tiny_test_config()
    model = convert.radvlm_from_jax(params, tcfg, device="cpu")
    plain = teng.make_generate_fn(tcfg, teng.GenerationConfig(max_new_tokens=NEW, eos_token_ids=()),
                                  attn_impl="xla")
    for i, hb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        want = jeng.make_sp_generate_fn(cfg, mesh, gen, local_impl="xla")(params, jb,
                                                                          jax.random.key(1))
        jenable_ring(None)
        one = plain(model, {k: torch.from_numpy(v) for k, v in hb.items()})
        for r in ranks:
            np.testing.assert_array_equal(r[i]["tokens_False"], np.asarray(want["tokens"]))
            np.testing.assert_array_equal(r[i]["num_False"], np.asarray(want["num_tokens"]))
            np.testing.assert_array_equal(r[i]["tokens_False"], one["tokens"].numpy())
            # the int8 cache gives the bf16 cache's tokens
            np.testing.assert_array_equal(r[i]["tokens_True"], r[i]["tokens_False"])


def test_sp_prefill_equals_prefill(setup):
    for r in setup[3]:
        for out in r:
            assert out["prefill_seg_equal"]
            assert out["prefill_cache_ok"]
            assert out["prefill_logits_err"] <= 1e-5


@pytest.mark.parametrize("kv_quant", [False, True])
def test_sp_decode_equals_plain_decode(setup, kv_quant):
    """Both prompts; the second leaves rank 0's block all padding."""
    batches = setup[2]
    assert batches[1]["segment_ids"][0, :(256 + EXTRA) // 2].sum() == 0
    for r in setup[3]:
        for out in r:
            err, scale = out[f"step_err_{kv_quant}"]
            assert err <= 5e-4 + 2e-3 * scale, (err, scale)
            assert out[f"seg_equal_{kv_quant}"]
