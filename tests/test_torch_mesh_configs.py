"""Four training configurations over the mesh, on spawned gloo ranks,
against the JAX package:

- an MoE decoder (4 experts, top-2, a shared expert, the router loss on)
  at `{tensor: 2}`: the experts' m channels and the shared expert sliced
  over tensor, the partial sums all-reduced in `qwen2._moe_mlp`, against
  the JAX one-device step;
- MoE capacity mode at `{seq: 2}` (the zigzag ring): the GShard ranking
  interleaves the seq blocks of a row (`sharding.row_offsets`), against the
  JAX step on the virtual mesh at `{seq: 2}` with its zigzag batch;
- LoRA over a dense base and QLoRA over an int8 base at `{tensor: 2}`: a
  sliced projection applies its slice of the whole adapters, whose
  gradients sum over tensor, against the JAX one-device LoRA / QLoRA step,
  the adapters equal on both ranks;
- a step saved under `{fsdp: 2}` (ZeRO-3 unit slices) and under
  `{stage: 2}` (the stages' layers), restored under `{tensor: 2}`, under
  `{stage: 2}` with the interleaved layout and on one process: the
  restored parameters and Adam state equal the saved ones exactly (each
  mesh's state saved again reassembles to the same tensors), and
  `read_params` of either step equals the JAX one-device steps' tree.

Tolerances as `test_torch_sharding.py` (`adam_eps=1e-5`); MoE runs with
`attn="xla"` as `test_torch_expert.py` explains.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu.parallel import mesh as jmesh
from radvlm_tpu.parallel import ring as jring
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch import config as tcfglib
from radvlm_tpu_torch.training import checkpoint as ckpt
from test_torch_expert import MOE
from test_torch_pp import LORA_CFG, _adapters, _Background, jax_lora, pp_config
from test_torch_sharding import LORA, TRAIN, _leaves, check_against, jax_sft, mesh_batches

VOCAB = 300


def _moe(mod, factor):
    base = mod.tiny_test_config(vocab_size=VOCAB)
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, moe_capacity_factor=factor, **MOE))


def _init(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax.jit(jrad.init_params, static_argnums=0)(
        jcfg, jax.random.key(seed)))


def jax_seq_step(jcfg, params, batches, train):
    """The JAX steps on the virtual mesh at {seq: 2}: the zigzag ring over
    the permuted batch, as the JAX loop runs it."""
    mesh = jmesh.make_mesh({"seq": 2}, devices=jax.devices()[:2])
    jring.enable_ring_attention(mesh, axis_name="seq", impl="xla", schedule="zigzag")
    try:
        state, step, _ = jts.setup_training(mesh, jcfg, jopt.TrainConfig(**train),
                                            jax.tree.map(jnp.asarray, params), remat=False,
                                            attn_impl="ring")
        losses, norms = [], []
        for b in batches:
            state, m = step(state, jts.put_batch(mesh, jring.zigzag_shift_batch(b, 2)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return losses, norms, _leaves(jax.device_get(state.params))
    finally:
        jring.enable_ring_attention(None)


@pytest.fixture(scope="module")
def setting():
    jcfg, tcfg = cfglib.tiny_test_config(vocab_size=VOCAB), tcfglib.tiny_test_config(
        vocab_size=VOCAB)
    params = _init(jcfg)
    moe_params = _init(_moe(cfglib, 0.0))
    qparams = jax.tree.map(np.asarray, jquant.quantize_params(jax.tree.map(jnp.asarray, params)))
    # The checkpoints' model has 4 decoder layers, so that {stage: 2} takes
    # the interleaved layout (V = 2) too.
    jcfg4 = pp_config(cfglib)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, moe=moe_params, qparams=qparams,
                ads=_adapters(params), batches=mesh_batches(tcfg, seed=21),
                moe_batches=mesh_batches(_moe(tcfglib, 0.0), seed=21),
                jcfg4=jcfg4, tcfg4=pp_config(tcfglib), params4=_init(jcfg4, 3))


@pytest.fixture(scope="module")
def spawned(setting, tmp_path_factory):
    """One spawn of two ranks, on a thread while the JAX side compiles: the
    training cases, then the checkpoints (per rank: its cases' results, its
    one-process restores)."""
    s = setting
    lora = dict(train=LORA, lora=LORA_CFG, adapters=s["ads"], shape={"tensor": 2})
    cases = [dict(shape={"tensor": 2}, cfg=_moe(tcfglib, 0.0), train=TRAIN, attn="xla",
                  params=s["moe"], batches=s["moe_batches"]),
             dict(shape={"seq": 2}, cfg=_moe(tcfglib, 1.0), train=TRAIN, ring="zigzag",
                  params=s["moe"], batches=s["moe_batches"]),
             dict(lora, attn="xla"),
             dict(lora, attn="xla", params=s["qparams"])]
    root = tmp_path_factory.mktemp("configs")

    def run():
        out = torch_dist.run(torch_dist.sft_and_checkpoints, 2, dict(
            sft=dict(cfg=s["tcfg"], params=s["params"], batches=s["batches"], cases=cases),
            checkpoints=dict(cfg=s["tcfg4"], params=s["params4"], train=TRAIN,
                             batches=s["batches"], dir=str(root / "ckpt"),
                             saves={"fsdp": {"fsdp": 2}, "stage": {"stage": 2}},
                             restores={"tensor": ({"tensor": 2}, 1),
                                       "interleaved": ({"stage": 2}, 2)})), root / "ranks")
        return [r[0] for r in out], [r[1] for r in out], root / "ckpt"

    return _Background(run)


@pytest.fixture(scope="module")
def ranks(spawned, jax_steps):
    return spawned.value()


@pytest.fixture(scope="module")
def jax_steps(setting, spawned):
    s = setting
    out = dict(dense=jax_sft(s["jcfg4"], s["params4"], s["batches"], TRAIN),
               moe_tensor=jax_sft(_moe(cfglib, 0.0), s["moe"], s["moe_batches"], TRAIN))
    out["moe_capacity_seq"] = jax_seq_step(_moe(cfglib, 1.0), s["moe"], s["moe_batches"], TRAIN)
    return out


@pytest.mark.parametrize("case,name", [(0, "moe_tensor"), (1, "moe_capacity_seq")])
def test_moe_configs_match_jax(setting, ranks, jax_steps, case, name):
    """Two micro-steps equal the JAX steps (the router's loss included);
    both ranks report the same losses."""
    jlosses, jnorms, jparams = jax_steps[name]
    per_rank = [r[case] for r in ranks[0]]
    losses, norms, tree = per_rank[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms[0], jnorms if np.isscalar(jnorms) else jnorms[0], rtol=1e-4)
    check_against(_leaves(tree), jparams, _leaves(setting["moe"]))
    np.testing.assert_allclose(per_rank[1][0], losses, rtol=1e-6)


@pytest.mark.parametrize("case,base", [(2, "dense"), (3, "int8")])
def test_lora_under_tensor_matches_jax(setting, ranks, case, base):
    """LoRA / QLoRA at `{tensor: 2}`: two micro-steps leave the adapters the
    JAX one-device step leaves (losses 1e-5, adapters rtol 1e-4 / atol
    1e-6), whole and equal on both ranks."""
    s = setting
    jlosses, want = jax_lora(s["jcfg"], s["params"] if base == "dense" else s["qparams"],
                             s["ads"], s["batches"], LORA)
    per_rank = [r[case] for r in ranks[0]]
    for losses, norms, adapters in per_rank:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert adapters.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(adapters[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in want:
        np.testing.assert_array_equal(per_rank[0][2][k], per_rank[1][2][k], err_msg=k)


@pytest.mark.parametrize("saved", ["fsdp", "stage"])
def test_checkpoint_restores_across_meshes(setting, ranks, jax_steps, saved):
    """A step saved under `saved` restores under `{tensor: 2}` and under
    `{stage: 2}` with the interleaved layout (each saved again reassembles to
    the very tensors: parameters, Adam's mu and nu) and on one process (its
    parameters and Adam state equal the reassembled ones); `read_params`
    equals the JAX one-device steps' tree."""
    _, outs, root = ranks
    manager = ckpt.CheckpointManager(str(root / saved))
    step = len(setting["batches"])
    whole = ckpt._reassemble(manager, step, ckpt._read_meta(manager, step))
    for label in ("tensor", "interleaved"):
        again = ckpt.CheckpointManager(str(root / f"{saved}_{label}"))
        back = ckpt._reassemble(again, step, ckpt._read_meta(again, step))
        assert back.keys() == whole.keys() == {"params/", "opt/mu/", "opt/nu/"}
        for prefix in whole:
            assert back[prefix].keys() == whole[prefix].keys()
            for k, t in whole[prefix].items():
                assert torch.equal(back[prefix][k], t), (label, prefix, k)
    for one in (r[saved] for r in outs):
        assert (one["step"], one["count"]) == (step, step)
        for kind, prefix in (("params", "params/"), ("mu", "opt/mu/"), ("nu", "opt/nu/")):
            assert one[kind].keys() == whole[prefix].keys()
            for k, v in one[kind].items():
                np.testing.assert_array_equal(v, whole[prefix][k].numpy(), err_msg=k)
    _, _, jparams = jax_steps["dense"]
    tree = _leaves(jax.tree.map(lambda t: t.numpy(), ckpt.read_params(manager, step)))
    check_against(tree, jparams, _leaves(setting["params4"]))
