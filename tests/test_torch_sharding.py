"""The port's sharded SFT (`parallel/sharding.py`, `training/train_step.py`
with `mesh=`) on spawned gloo ranks against the JAX package's one-device
train step, at the tiny config: `{data: 2, fsdp: 2}`, `{fsdp: 2, tensor:
2}` and `{fsdp: 2, seq: 2}` (ZeRO-3 slices, HSDP replicas, Megatron TP
with differentiable all_reduces, the zigzag ring), LoRA under `{fsdp: 2}` (the base sharded, the adapters whole),
and a checkpoint resume under `{fsdp: 2}` against an uninterrupted run. The
batches' rows hold different numbers of supervised tokens, so a rank that
divided its loss by its own token count would move the gradients. Losses
rtol 1e-5, the first grad norm rtol 1e-4, parameters rtol 1e-5 / atol 2e-5,
as `test_torch_train.py` holds the one-card step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist
from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.parallel import sharding as jshard
from radvlm_tpu.training import lora as jlora
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch.config import IGNORE_INDEX, tiny_test_config
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.parallel import sharding

VOCAB = 300
TRAIN = dict(learning_rate=1e-3, vision_tower_lr=5e-4, projector_lr=2e-3, weight_decay=0.01,
             max_grad_norm=0.5, warmup_ratio=0.25, total_steps=8, grad_accum_steps=1,
             adam_eps=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=VOCAB)
    params = jax.tree.map(np.asarray, jax.jit(jrad.init_params, static_argnums=0)(
        cfg, jax.random.key(0)))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
               for k in p) else x,
        params,
    )
    return cfg, tiny_test_config(vocab_size=VOCAB), params


def mesh_batches(tcfg, n=2, rows=4, seed=0):
    """`n` host batches of `rows` image prompts each, every row with its own
    number of supervised tokens."""
    out = []
    for j in range(n):
        samples = []
        for i in range(rows):
            r = np.random.default_rng(seed + 100 * j + i)
            img = r.integers(0, 255, (70, 90, 3), dtype=np.uint8)
            n_prompt, n_reply = 4 + 3 * i, 3 + 4 * i + j
            ids = ([int(t) for t in r.integers(2, VOCAB, n_prompt)] + [-200]
                   + [int(t) for t in r.integers(2, VOCAB, n_reply)])
            labels = [IGNORE_INDEX] * (n_prompt + 1) + ids[n_prompt + 1:]
            samples.append(tmm.build_sample(ids, [img], tcfg, labels=labels))
        out.append(tmm.collate(samples, pad_to_multiple=128))
    return out


def jax_sft(jcfg, params, batches, train):
    """The JAX one-device steps: (losses, the first step's grad norm over
    the trainable leaves, the trained leaves)."""
    tx, labels = jopt.make_optimizer(params, jopt.TrainConfig(**train))
    jparams = jax.tree.map(jnp.asarray, params)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams))
    step = jts.make_train_step(jcfg, tx, remat=False, attn_impl="xla", donate=False)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    g = jax.jit(jax.grad(lambda p: jrad.loss_fn(p, jcfg, jb0, remat=False,
                                                attn_impl="xla")[0]))(jparams)
    g = jax.tree.map(lambda x, l: x if l != "frozen" else jnp.zeros_like(x), g, labels)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, float(optax.global_norm(g)), _leaves(state.params)


def check_against(got, want, start):
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(want[k], start[k]))
    assert moved > 0


# `fsdp2_seq2`: the batch zigzag-permuted with its labels shifted, each rank
# holding its rows' sequence half, the decoder's attention the zigzag ring
# (parallel/ring.py), against the JAX step on the batch in order.
CASES = {"data2_fsdp2": dict(shape={"data": 2, "fsdp": 2}),
         "fsdp2_tensor2": dict(shape={"fsdp": 2, "tensor": 2}),
         "fsdp2_seq2": dict(shape={"fsdp": 2, "seq": 2}, ring="zigzag")}


@pytest.fixture(scope="module")
def sharded_runs(tiny, tmp_path_factory):
    jcfg, tcfg, params = tiny
    batches = mesh_batches(tcfg)
    cases = [dict(case, train=TRAIN) for case in CASES.values()]
    ranks = torch_dist.run(torch_dist.sharded_sft, 4,
                           dict(cfg=tcfg, params=params, batches=batches, cases=cases),
                           tmp_path_factory.mktemp("sharded"))
    return dict(zip(CASES, zip(*ranks))), jax_sft(jcfg, params, batches, TRAIN)


@pytest.mark.parametrize("shape", list(CASES))
def test_sharded_step_matches_jax(tiny, sharded_runs, shape):
    """Two micro-steps under the mesh equal the JAX one-device steps; every
    rank reports the same global loss and norm and holds the same whole
    parameters."""
    _, _, params = tiny
    runs, (jlosses, jnorm0, jparams) = sharded_runs
    per_rank = runs[shape]
    losses, norms, tree = per_rank[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms[0], jnorm0, rtol=1e-4)
    check_against(_leaves(tree), jparams, _leaves(params))
    for other in per_rank[1:]:
        assert other[0] == losses and other[1] == norms
        for k, v in _leaves(other[2]).items():
            np.testing.assert_array_equal(v, _leaves(tree)[k], err_msg=k)


LORA = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=8, grad_accum_steps=1,
            max_grad_norm=0.5, adam_eps=1e-5)


def test_lora_under_fsdp_matches_jax(tiny, tmp_path):
    """LoRA under `{fsdp: 2}`: the frozen base sharded by the rules, the
    adapters whole on both ranks and equal to the JAX LoRA step's after two
    micro-steps (rtol 1e-4 / atol 1e-6, as `test_torch_lora.py` holds the
    one-card LoRA step)."""
    jcfg, tcfg, params = tiny
    batches = mesh_batches(tcfg, seed=7)
    lcfg = dict(rank=4, alpha=8.0)
    shapes = jlora.init_lora(jax.tree.map(jnp.asarray, params), jlora.LoraConfig(**lcfg),
                             jax.random.key(1))
    rng = np.random.default_rng(5)
    ads = {p: {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in ad.items()}
           for p, ad in shapes.items()}
    case = dict(shape={"fsdp": 2}, train=LORA, lora=lcfg, adapters=ads)
    ranks = torch_dist.run(torch_dist.sharded_sft, 2,
                           dict(cfg=tcfg, params=params, batches=batches, cases=[case]),
                           tmp_path)
    jtrain = jopt.TrainConfig(**LORA)
    tx = optax.chain(
        optax.clip_by_global_norm(jtrain.max_grad_norm),
        optax.adamw(jopt.make_schedule(jtrain, jtrain.learning_rate), b1=jtrain.adam_b1,
                    b2=jtrain.adam_b2, eps=jtrain.adam_eps, weight_decay=jtrain.weight_decay))
    jads = jax.tree.map(jnp.asarray, ads)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jads, opt_state=tx.init(jads))
    step = jts.make_lora_train_step(jcfg, jlora.LoraConfig(**lcfg), tx, remat=False,
                                    attn_impl="xla")
    base = jax.tree.map(jnp.asarray, params)
    jlosses = []
    for b in batches:
        state, m = step(state, base, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
    want = {f"{p}/{k}": np.asarray(v) for p, ad in state.params.items() for k, v in ad.items()}
    for losses, _, adapters in (r[0] for r in ranks):
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert adapters.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(adapters[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
            start = ads[k.rsplit("/", 1)[0]][k.rsplit("/", 1)[1]]
            assert not np.array_equal(adapters[k], start), k


def test_checkpoint_resume_under_fsdp(tiny, tmp_path):
    """Under `{fsdp: 2}` with accumulation 2: three micro-steps, a save in
    the middle of a window, a fresh setup restored from it and a fourth step
    equal four straight micro-steps (1e-6); every rank wrote its own file
    and rank 0 the meta.json."""
    _, tcfg, params = tiny
    batches = mesh_batches(tcfg, n=4, seed=3)
    train = dict(TRAIN, grad_accum_steps=2)
    ranks = torch_dist.run(torch_dist.sharded_resume, 2,
                           dict(cfg=tcfg, params=params, batches=batches, train=train,
                                shape={"fsdp": 2}, dir=str(tmp_path / "ckpt")),
                           tmp_path / "ranks")
    for diff, files, step, count, mini in ranks:
        assert diff <= 1e-6
        assert files == ["meta.json", "state.rank0.safetensors", "state.rank1.safetensors"]
        assert (step, count, mini) == (4, 2, 0)


def test_rules_place_the_tiny_model():
    """The port's placements follow the JAX rule table: column / row
    parallel projections sliced over tensor on their output / input dim,
    the tower, projector, embedding and lm_head whole over tensor, norms
    and biases of row-parallel layers whole over fsdp; `param_pspecs` of a
    bare decoder reads the LLM rules."""
    from radvlm_tpu_torch.models import radvlm

    model = radvlm.RadVLM(tiny_test_config(), device="meta")
    specs = sharding.param_pspecs(model)
    assert specs["text.layers.0.q.weight"] == ("tensor", "fsdp")
    assert specs["text.layers.1.o.weight"] == ("fsdp", "tensor")
    assert specs["text.layers.0.ln1"] == ()
    for name, want in (("text.layers.0.q.weight", (0, None, True)),
                       ("text.layers.0.q.bias", (0, None, False)),
                       ("text.layers.0.down.weight", (1, None, True)),
                       ("text.layers.0.ln2", (None, None, False)),
                       ("text.embed", (None, None, True)),
                       ("text.lm_head.weight", (None, None, True)),
                       ("vision_tower.layers.0.fc1.weight", (None, None, True)),
                       ("projector.fcs.0.weight", (None, None, True)),
                       ("image_newline", (None, None, False))):
        pl = sharding.placement(name)
        assert (pl.tensor_dim, pl.expert_dim, pl.fsdp) == want, name
    # The JAX specs of the same leaves, in the [in, out] layout.
    jspecs = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        jshard.param_pspecs({"text": {"layers": {"attn": {"q": {"kernel": 0}, "o": {
            "kernel": 0}}}}}), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    assert tuple(jspecs["['text']['layers']['attn']['q']['kernel']"])[1:] == ("fsdp", "tensor")
    assert tuple(jspecs["['text']['layers']['attn']['o']['kernel']"])[1:] == ("tensor", "fsdp")
    llm = sharding.param_pspecs(model.text, llm_only=True)
    assert llm["layers.0.gate.weight"] == ("tensor", "fsdp")


def test_batch_shardings_cut_rows_and_sequence():
    """A rank's rows are its block of (data, fsdp), data-major, as
    P(("data", "fsdp")) lays them out; with seq > 1 the token arrays are
    cut along the sequence too, the tiles and merge plan are not."""
    batch = {"tokens": np.arange(8 * 16).reshape(8, 16), "tiles": np.arange(8 * 3).reshape(8, 3)}
    mg = sharding.MeshGroups(None, {}, {"data": 1, "fsdp": 0, "seq": 1},
                             {"data": 2, "fsdp": 2, "seq": 2})
    part = sharding.batch_shardings(mg, batch)
    np.testing.assert_array_equal(part["tokens"], batch["tokens"][4:6, 8:])
    np.testing.assert_array_equal(part["tiles"], batch["tiles"][4:6])
    with pytest.raises(ValueError, match="does not split"):
        sharding.batch_shardings(mg, {"tokens": np.zeros((6, 16))})
