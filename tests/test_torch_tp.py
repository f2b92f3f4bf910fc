"""Tensor-parallel serving (`parallel/tp.py`, `ContinuousBatcher(mesh=)`)
against the JAX package at the tiny config with f32 weights.

- `local_text_cfg` equals the JAX one, and the rank-r shard of the port's
  model equals the r-th slice of every leaf under the JAX package's
  `tp_param_pspecs`, brought over by the weight bridge;
- two spawned gloo ranks run the port's TP engine: its greedy tokens equal
  the JAX TP engine's (an 8-device virtual mesh with tensor = 2) and the
  port's one-process engine's, over the bf16 and the int8 cache and with
  spec_k = 3; seeded sampling gives both ranks the same tokens; the
  provenance names the degree and the local shapes;
- a fused tree, int4 weights and ALiBi are refused.

f32 weights: W8A8 on a row-parallel layer quantizes the rank's K slice, so
an int8 TP model differs from the one-process int8 model (in the JAX
package too).
"""

import dataclasses

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
from radvlm_tpu.parallel import tp as jtp
from radvlm_tpu.parallel.mesh import make_mesh as jmake_mesh
from radvlm_tpu.parallel.sharding import path_str
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.generation.engine import GenerationConfig
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.parallel import tp

STEPS = 5
LENGTHS = (6, 11, 8)
RUNS = {
    "bf16": (dict(kv_quant=False), dict(max_new_tokens=STEPS)),
    "int8": (dict(kv_quant=True), dict(max_new_tokens=STEPS)),
    "spec": (dict(kv_quant=False, spec_k=3), dict(max_new_tokens=STEPS)),
    "hot": (dict(kv_quant=False, seed=3), dict(max_new_tokens=6, temperature=1.0, top_p=0.9)),
}


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfg.tiny_test_config()
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(7)))
    return cfg, params


@pytest.fixture(scope="module")
def ranks(tiny, tmp_path_factory):
    cfg, params = tiny
    payload = dict(cfg=tiny_test_config(), params=params, runs=RUNS, lengths=LENGTHS)
    return torch_dist.run(torch_dist.tp_engines, 2, payload, tmp_path_factory.mktemp("tp2"))


def _jax_tokens(params, cfg, mesh, **kw):
    b = JBatcher(params, cfg, JGen(max_new_tokens=STEPS, eos_token_ids=()),
                 **torch_dist.ENGINE, mesh=mesh, **kw)
    reqs = [b.submit(s) for s in torch_dist.samples(jmm, cfg, LENGTHS)]
    done = {r.uid: r.emitted for r in b.run()}
    return [done[r.uid] for r in reqs]


def _port_tokens(params, name):
    cfg = tiny_test_config()
    engine_kw, gen_kw = RUNS[name]
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    toks, _ = torch_dist.engine_tokens(model, cfg, GenerationConfig(eos_token_ids=(), **gen_kw),
                                       torch_dist.samples(tmm, cfg, LENGTHS), **engine_kw)
    return toks


def test_local_cfg_and_shards_equal_the_jax_slices(tiny):
    cfg, params = tiny
    tcfg = tiny_test_config()
    local = tp.local_text_cfg(tcfg.text, 2)
    assert dataclasses.asdict(local) == dataclasses.asdict(jtp.local_text_cfg(cfg.text, 2))
    specs = jtp.tp_param_pspecs(params)
    for rank in range(2):
        def part(path, leaf, spec):
            for dim, ax in enumerate(spec):
                if ax == "tensor":
                    n = leaf.shape[dim] // 2
                    return np.take(leaf, np.arange(rank * n, (rank + 1) * n), axis=dim)
            return leaf

        sliced = jax.tree_util.tree_map_with_path(
            lambda p, leaf, spec: part(path_str(p), leaf, spec), params, specs,
            is_leaf=lambda x: isinstance(x, np.ndarray))
        lcfg = dataclasses.replace(tcfg, text=local)
        want = convert.radvlm_from_jax(sliced, lcfg, device="cpu").state_dict()
        got = tp.shard_text_tp(convert.radvlm_from_jax(params, tcfg, device="cpu").text, 2, rank)
        got = {"text." + k: v for k, v in got.state_dict().items()}
        text_keys = [k for k in want if k.startswith("text.")]
        assert sorted(got) == sorted(text_keys)
        for k in text_keys:
            assert torch.equal(got[k], want[k]), k


def test_tp_engine_tokens_equal_jax_tp_and_one_process(tiny, ranks):
    cfg, params = tiny
    mesh = jmake_mesh({"tensor": 2, "data": 1, "fsdp": 4})
    for name in ("bf16", "int8"):
        kvq = name == "int8"
        want = _jax_tokens(params, cfg, mesh, kv_quant=kvq)
        assert ranks[0][name] == ranks[1][name] == want, name
        assert want == _port_tokens(params, name)
        assert all(len(t) == STEPS for t in want)


def test_tp_spec_tokens_equal_plain_greedy(tiny, ranks):
    cfg, params = tiny
    assert ranks[0]["spec"] == ranks[1]["spec"] == ranks[0]["bf16"]
    assert ranks[0]["spec"] == _port_tokens(params, "spec")
    mesh = jmake_mesh({"tensor": 2, "data": 1, "fsdp": 4})
    assert ranks[0]["spec"] == _jax_tokens(params, cfg, mesh, spec_k=3)


def test_tp_sampling_replicated(ranks):
    """Temperature > 0: one seeded generator per rank draws the same tokens
    from the same logits, so the ranks' caches stay one."""
    assert ranks[0]["hot"] == ranks[1]["hot"]
    assert all(len(t) == 6 for t in ranks[0]["hot"])


def test_tp_provenance_and_local_shapes(ranks):
    cfg = tiny_test_config()
    hd = cfg.text.head_dim
    for r in ranks:
        prov = r["int8_provenance"]
        assert prov["tp"] == 2
        assert prov["tp_local"] == {"heads": 2, "kv_heads": 1, "intermediate": 48}
        assert r["bf16_q_rows"] == ((2 + 2 * 1) * hd, cfg.text.hidden_size)  # local q|k|v, fused
        assert r["bf16_cache"] == (cfg.text.num_layers, 2, 256, 1 * hd)
        assert r["context_after"] is None


def test_tp_rejects_fused_int4_and_alibi(tiny):
    cfg, params = tiny
    tcfg = tiny_test_config()
    model = convert.radvlm_from_jax(params, tcfg, device="cpu")
    from radvlm_tpu_torch.models import qwen2

    qwen2.fuse_projections(model.text)
    with pytest.raises(ValueError, match="unfused"):
        tp.shard_text_tp(model.text, 2, 0)
    with pytest.raises(ValueError, match="must divide"):
        tp.local_text_cfg(tcfg.text, 3)
    text = dataclasses.replace(tcfg.text, pos_embedding="alibi", num_heads=4, num_kv_heads=4)
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tp.local_text_cfg(text, 2)
    q4 = convert.random_quantized_params(
        dataclasses.replace(tcfg, text=dataclasses.replace(
            tcfg.text, hidden_size=128, intermediate_size=256, head_dim=32)),
        torch.Generator().manual_seed(0), device="cpu", bits=4, fuse=False)
    with pytest.raises(NotImplementedError, match="int4"):
        tp.shard_text_tp(q4.text, 2, 0)
    assert tp.maybe_all_reduce(torch.ones(2)).tolist() == [1.0, 1.0]  # no context: identity
