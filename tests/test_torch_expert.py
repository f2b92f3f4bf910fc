"""The expert axis (`qwen2._moe_mlp` under `parallel/sharding.py`) on
spawned gloo ranks: the `{expert: 2, fsdp: 2}` SFT micro-steps of a tiny
Qwen2-MoE RadVLM (4 experts, top-2, a shared expert, the router's
load-balancing loss on) against the JAX package's one-device train step,
in exact mode and in capacity mode (the GShard dispatch: capacity from the
global token count, picks ranked after the other ranks'), and capacity
mode under `{data: 2, fsdp: 2}` too. Each rank computes its two experts on
the tokens it holds; the router statistics average over the batch ranks.
Tolerances as `test_torch_sharding.py`.
"""

import dataclasses

import jax
import numpy as np
import pytest

import torch_dist
from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu_torch import config as tcfglib
from test_torch_sharding import TRAIN, _leaves, check_against, jax_sft, mesh_batches

VOCAB = 300
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
           shared_expert_intermediate_size=56, norm_topk_prob=True, router_aux_coef=0.05)
MODES = {"exact": ({"expert": 2, "fsdp": 2}, 0.0),
         "capacity": ({"expert": 2, "fsdp": 2}, 1.0),
         "capacity_data": ({"data": 2, "fsdp": 2}, 1.0)}


def _moe(mod, factor):
    base = mod.tiny_test_config(vocab_size=VOCAB)
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, moe_capacity_factor=factor, **MOE))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the ranks' (losses, norms, tree), the JAX steps, the start."""
    jcfg0 = _moe(cfglib, 0.0)
    params = jax.tree.map(np.asarray, jax.jit(jrad.init_params, static_argnums=0)(
        jcfg0, jax.random.key(0)))
    batches = mesh_batches(_moe(tcfglib, 0.0), seed=21)
    # Plain attention, as the JAX step's XLA path: the router statistics
    # count every position, and a padding row's attention output is the
    # mean of v there, 0 through the kernels' route.
    cases = [dict(shape=shape, cfg=_moe(tcfglib, f), train=TRAIN, attn="xla")
             for shape, f in MODES.values()]
    ranks = torch_dist.run(torch_dist.sharded_sft, 4,
                           dict(params=params, batches=batches, cases=cases),
                           tmp_path_factory.mktemp("moe"))
    want = {f: jax_sft(_moe(cfglib, f), params, batches, TRAIN) for f in (0.0, 1.0)}
    out = {n: ([r[i] for r in ranks], want[f]) for i, (n, (_, f)) in enumerate(MODES.items())}
    return out, _leaves(params)


@pytest.mark.parametrize("mode", list(MODES))
def test_expert_step_matches_jax(runs, mode):
    """Two micro-steps equal the JAX one-device steps (the router's aux
    loss included); the ranks agree."""
    out, start = runs
    per_rank, (jlosses, jnorm0, jparams) = out[mode]
    losses, norms, tree = per_rank[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms[0], jnorm0, rtol=1e-4)
    check_against(_leaves(tree), jparams, start)
    for other in per_rank[1:]:
        np.testing.assert_allclose(other[0], losses, rtol=1e-6)
