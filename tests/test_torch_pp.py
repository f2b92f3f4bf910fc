"""Pipeline parallelism (`parallel/pp.py`) on spawned gloo ranks, against
the JAX package's (`radvlm_tpu/parallel/pp.py` on the virtual CPU mesh) and
its plain one-device steps, as `tests/test_pp.py` holds the JAX module:

- the GPipe loss and gradients at `{data: 2, stage: 2}`, M = 2, and the
  interleaved ones at `{stage: 2}`, V = 2, M = 2 (the two pipeline cases of
  `__graft_entry__.py::dryrun_multichip`) against JAX `make_pp_grad_fn` on
  a virtual mesh of the same shape and against plain `radvlm.loss_fn`, on
  the same weights moved through `models/convert.py`: loss 1e-5 relative,
  gradients within 1e-4 of the largest;
- the fold round trip and `canonicalize_layer_stacks` against the JAX
  functions; the mesh checks with the JAX messages;
- masked_drop's draw reaching stage 0 (one uniform draw injected into both
  packages, as `tests/test_torch_resampler.py` does); the loss independent
  of the microbatch count;
- PP train steps against the JAX one-device SFT step, PP LoRA against the
  JAX LoRA step and the interleaved QLoRA step (int8 base) against the JAX
  QLoRA step, `adam_eps=1e-5` (`test_torch_sharding.py`'s tolerances);
- the training CLI under `--mesh-stage 2 --pp-interleave 2` on two ranks
  (its tiny model given 4 decoder layers), its checkpoint converted to an
  HF directory that `--verify` accepts (the config the step saved).

Every case that needs ranks runs in one of two spawns (4 ranks and 2), on
a thread while the JAX side compiles.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist
from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu.parallel import mesh as jmesh
from radvlm_tpu.parallel import pp as jpp
from radvlm_tpu.training import lora as jlora
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch import config as tcfglib
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.parallel import pp
from test_torch_sharding import LORA, TRAIN, _leaves, jax_sft, mesh_batches
from test_torch_train import _write_llava_json

VOCAB = 300
LORA_CFG = dict(rank=4, alpha=8.0)


def pp_config(mod, n_layers=4, **resampler):
    cfg = mod.tiny_test_config(vocab_size=VOCAB)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=n_layers))
    if resampler:
        cfg = dataclasses.replace(cfg, resampler=mod.ResamplerConfig(**resampler))
    return cfg


def tree_leaves(cfg, named):
    """{JAX keystr: array} of the tree of a whole {parameter name: array}
    dict (the union of the ranks' parameters)."""
    full = radvlm.RadVLM(cfg, device="cpu", dtype=torch.float32)
    full.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in named.items()})
    return _leaves(torch_dist._numpy_tree(convert.radvlm_to_tree(full)))


def union(per_rank):
    out = {}
    for d in per_rank:
        for k, v in d.items():
            out.setdefault(k, v)
    return out


def close_to_largest(got, want, rel=1e-4):
    """Every leaf of `got` within rel x the largest |want| of all leaves."""
    big = max(float(np.abs(v).max()) for v in want.values())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * big, err_msg=k)


def _adapters(params, seed=5):
    shapes = jlora.init_lora(jax.tree.map(jnp.asarray, params), jlora.LoraConfig(**LORA_CFG),
                             jax.random.key(1))
    rng = np.random.default_rng(seed)
    return {p: {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in ad.items()}
            for p, ad in shapes.items()}


def jax_lora(jcfg, base, ads, batches, train):
    """The JAX one-device LoRA steps: (losses, the adapters after)."""
    jtrain = jopt.TrainConfig(**train)
    tx = optax.chain(
        optax.clip_by_global_norm(jtrain.max_grad_norm),
        optax.adamw(jopt.make_schedule(jtrain, jtrain.learning_rate), b1=jtrain.adam_b1,
                    b2=jtrain.adam_b2, eps=jtrain.adam_eps, weight_decay=jtrain.weight_decay))
    jads = jax.tree.map(jnp.asarray, ads)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jads, opt_state=tx.init(jads))
    step = jts.make_lora_train_step(jcfg, jlora.LoraConfig(**LORA_CFG), tx, remat=False,
                                    attn_impl="xla")
    jbase = jax.tree.map(jnp.asarray, base)
    losses = []
    for b in batches:
        state, m = step(state, jbase, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, {f"{p}/{k}": np.asarray(v) for p, ad in state.params.items()
                    for k, v in ad.items()}


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = pp_config(cfglib), pp_config(tcfglib)
    params = jax.tree.map(np.asarray, jax.jit(jrad.init_params, static_argnums=0)(
        jcfg, jax.random.key(0)))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm") for k in p) else x,
        params)
    return jcfg, tcfg, params


@pytest.fixture(scope="module")
def data(tiny):
    _, tcfg, _ = tiny
    return dict(grads=mesh_batches(tcfg, n=1, seed=11), steps=mesh_batches(tcfg, seed=3),
                lora=mesh_batches(tcfg, seed=7))


def _jax_pp_grads(jcfg, params, batch, shape, devices, interleave):
    mesh = jmesh.make_mesh(shape, devices=jax.devices()[:devices])
    sharded = jpp.shard_params_pp(mesh, jax.tree.map(jnp.asarray, params),
                                  interleave=interleave)
    fn = jpp.make_pp_grad_fn(mesh, jcfg, sharded, n_microbatches=2, remat=False,
                             attn_impl="xla", interleave=interleave)
    grads, metrics = jax.jit(fn)(sharded, jpp.put_batch_pp(mesh, batch))
    grads = jax.device_get(grads)
    if interleave > 1:
        grads = jpp.unfold_layers_interleaved(grads)
    return float(metrics["loss"]), float(metrics["tokens"]), _leaves(grads)


@pytest.fixture(scope="module")
def inputs(tiny, data):
    """What both sides take: the adapters, the int8 base, masked_drop's
    uniform draw."""
    _, _, params = tiny
    batch = data["grads"][0]
    n_tiles = batch["tiles"].shape[0] * batch["tiles"].shape[1]
    qparams = jax.tree.map(np.asarray, jquant.quantize_params(jax.tree.map(jnp.asarray, params)))
    return dict(ads=_adapters(params), qparams=qparams,
                u=np.random.default_rng(4).uniform(size=(n_tiles, 16)).astype(np.float32))


class _Background(threading.Thread):
    """fn() on a thread; `value()` joins it and returns or raises."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.result, self.error = fn, None, None
        self.start()

    def run(self):
        try:
            self.result = self.fn()
        except BaseException as e:  # handed to the test that reads it
            self.error = e

    def value(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


@pytest.fixture(scope="module")
def spawned(tiny, data, inputs, tmp_path_factory):
    """The two spawns (4 ranks, then 2), run on a thread while the JAX side
    compiles (`references` asks for this first)."""
    _, tcfg, params = tiny
    root = tmp_path_factory.mktemp("pp")
    sft = _write_llava_json(str(root), n=4)
    out = str(root / "run")
    argv = ["--model-size", "tiny", "--data-path", sft, "--image-folder", str(root),
            "--device", "cpu", "--log-every", "1", "--warmup-ratio", "0",
            "--micro-batch-size", "2", "--pack-factor", "2", "--buckets", "256:4",
            "--grad-accum-steps", "1", "--save-steps", "2", "--num-epochs", "3",
            "--mesh-stage", "2", "--pp-interleave", "2", "--pp-microbatches", "2",
            "--output-dir", out]
    lora = dict(train=LORA, lora=LORA_CFG, adapters=inputs["ads"], batches=data["lora"])
    # {data: 2, stage: 2}: the GPipe gradients.
    four = [dict(kind="grads", shape={"data": 2, "stage": 2}, remat=False)]
    # {stage: 2}: the interleaved gradients, masked_drop, the microbatch
    # counts, PP LoRA (GPipe), interleaved QLoRA, the training CLI and two
    # PP SFT steps.
    two = [dict(kind="grads", shape={"stage": 2}, interleave=2, remat=False),
           dict(kind="masked_drop", shape={"stage": 2},
                cfg=pp_config(tcfglib, kind="masked_drop", drop_ratio=0.5), u=inputs["u"]),
           dict(kind="invariant", shape={"stage": 2}, counts=(1, 2, 4)),
           dict(kind="lora", shape={"stage": 2}, **lora),
           dict(kind="lora", shape={"stage": 2}, interleave=2, params=inputs["qparams"], **lora),
           dict(kind="cli", argv=argv + ["--max-steps", "2"], out=out, layers=4),
           dict(kind="cli", argv=argv + ["--max-steps", "3"], out=out, layers=4),
           dict(kind="step", shape={"stage": 2}, train=TRAIN, batches=data["steps"])]

    def run():
        payload = dict(cfg=tcfg, params=params, batches=data["grads"])
        return (torch_dist.run(torch_dist.pp_cases, 4, dict(payload, cases=four), root / "r4"),
                (torch_dist.run(torch_dist.pp_cases, 2, dict(payload, cases=two), root / "r2"),
                 out))

    return _Background(run)


@pytest.fixture(scope="module")
def references(tiny, data, inputs, spawned):
    """The JAX side: plain loss and gradients, the two pipelines' (on the
    virtual mesh), the SFT, LoRA and QLoRA steps, masked_drop's loss under
    the injected draw."""
    jcfg, tcfg, params = tiny
    batch = data["grads"][0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jrad.loss_fn(p, jcfg, jb, remat=False, attn_impl="xla"), has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    out = dict(plain=(float(loss), float(metrics["tokens"]), _leaves(grads)))
    out["gpipe"] = _jax_pp_grads(jcfg, params, batch, {"data": 2, "stage": 2}, 4, 1)
    out["interleaved"] = _jax_pp_grads(jcfg, params, batch, {"stage": 2}, 2, 2)
    out["sft"] = jax_sft(jcfg, params, data["steps"], TRAIN)
    ads, qparams, u = inputs["ads"], inputs["qparams"], inputs["u"]
    out["lora"] = (ads, jax_lora(jcfg, params, ads, data["lora"], LORA))
    out["qlora"] = (qparams, jax_lora(jcfg, qparams, ads, data["lora"], LORA))
    md_j = pp_config(cfglib, kind="masked_drop", drop_ratio=0.5)
    orig = jax.random.uniform
    jax.random.uniform = lambda key, shape, *a, **k: jnp.asarray(u)
    try:
        md_loss = float(jax.jit(lambda p: jrad.loss_fn(
            p, md_j, jb, remat=False, attn_impl="xla", rng=jax.random.key(0))[0])(
            jax.tree.map(jnp.asarray, params)))
    finally:
        jax.random.uniform = orig
    out["masked_drop"] = (u, md_loss)
    return out


@pytest.fixture(scope="module")
def four_ranks(spawned):
    return spawned.value()[0]


@pytest.fixture(scope="module")
def two_ranks(spawned):
    return spawned.value()[1]


def _check_grads(tcfg, per_rank, want_loss, want_tokens, want_grads, against):
    for loss, tokens, _ in per_rank:
        assert loss == pytest.approx(want_loss, rel=1e-5), against
        assert tokens == want_tokens
    got = tree_leaves(tcfg, union(g for _, _, g in per_rank))
    close_to_largest(got, want_grads)


@pytest.mark.parametrize("against", ["jax_pipeline", "plain_loss_fn"])
def test_gpipe_matches_jax(tiny, references, four_ranks, against):
    """`{data: 2, stage: 2}`, M = 2: every rank's loss and the ranks' summed
    gradients (each layer from the stage that holds it) equal the JAX
    pipeline's on a virtual mesh of the same shape, and plain
    `radvlm.loss_fn`'s."""
    _, tcfg, _ = tiny
    want = references["gpipe" if against == "jax_pipeline" else "plain"]
    _check_grads(tcfg, [r[0] for r in four_ranks], *want, against)


@pytest.mark.parametrize("against", ["jax_pipeline", "plain_loss_fn"])
def test_interleaved_matches_jax(tiny, references, two_ranks, against):
    """`{stage: 2}`, V = 2 (chunks [0, 2] and [1, 3]), M = 2: as above
    against the JAX interleaved pipeline (its folded [V, S, C] gradients
    unfolded) and the plain loss."""
    _, tcfg, _ = tiny
    want = references["interleaved" if against == "jax_pipeline" else "plain"]
    _check_grads(tcfg, [r[0] for r in two_ranks[0]], *want, against)


def test_fold_roundtrip_and_canonicalize(tiny):
    """The port's fold / unfold / canonicalize give the JAX functions'
    trees, leaf for leaf: chunk v of stage s at [v, s], layer (v S + s) C."""
    _, _, params = tiny
    folded = pp.fold_layers_interleaved(params, stages=2, interleave=2)
    want = _leaves(jpp.fold_layers_interleaved(params, stages=2, interleave=2))
    got = _leaves(folded)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lf = folded["text"]["layers"]["attn"]["q"]["kernel"]
    assert lf.shape[:2] == (2, 2)
    np.testing.assert_array_equal(lf[1, 0, 0], params["text"]["layers"]["attn"]["q"]["kernel"][2])
    back = _leaves(pp.unfold_layers_interleaved(folded))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    canon = pp.canonicalize_layer_stacks(folded, 4)
    np.testing.assert_array_equal(canon["text"]["layers"]["mlp"]["up"]["kernel"],
                                  params["text"]["layers"]["mlp"]["up"]["kernel"])
    assert pp.canonicalize_layer_stacks(params, 4) is params
    with pytest.raises(ValueError, match="not divisible"):
        pp.fold_layers_interleaved(params, stages=3, interleave=1)


def test_masked_drop_reaches_stage_0(references, two_ranks):
    """masked_drop under PP: with one uniform draw injected into both
    packages the loss equals the JAX plain loss under it (1e-5); with the
    port's own draws the same generator seed gives the same loss and
    another seed another."""
    _, want = references["masked_drop"]
    for r in two_ranks[0]:
        injected, (a, a2, b) = r[1]
        assert injected == pytest.approx(want, rel=1e-5)
        assert a == a2 and a != b


def test_microbatch_count_invariant(two_ranks):
    """The loss is the same at M = 1, 2 and 4 (1e-5)."""
    for r in two_ranks[0]:
        losses = r[2]
        assert losses[1] == pytest.approx(losses[0], rel=1e-5)
        assert losses[2] == pytest.approx(losses[0], rel=1e-5)


def test_pp_train_step_matches_plain_sft(tiny, references, two_ranks):
    """Two PP SFT micro-steps at `{stage: 2}` equal the JAX one-device
    steps: losses 1e-5, the first grad norm 1e-4, the parameters (each
    layer from its stage) rtol 1e-5 / atol 2e-5."""
    _, tcfg, params = tiny
    jlosses, jnorm0, jparams = references["sft"]
    per_rank = [r[7] for r in two_ranks[0]]
    for losses, norms, _ in per_rank:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        np.testing.assert_allclose(norms[0], jnorm0, rtol=1e-4)
    got = tree_leaves(tcfg, union(h for _, _, h in per_rank))
    moved = 0
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(v, _leaves(params)[k]))
    assert moved > 0


@pytest.mark.parametrize("case,name", [(3, "lora"), (4, "qlora")])
def test_pp_lora_matches_plain_lora(references, two_ranks, case, name):
    """PP LoRA (GPipe) and QLoRA over an int8 base (interleaved, V = 2):
    two micro-steps equal the JAX one-device LoRA / QLoRA steps (losses
    1e-5, adapters rtol 1e-4 / atol 1e-6), both ranks hold the same whole
    adapters, and `make_pp_lora_grad_fn`'s gradients have the first step's
    global norm (1e-5)."""
    ads, (jlosses, want) = references[name][0], references[name][1]
    if name == "qlora":
        ads = references["lora"][0]
    ranks = [r[case] for r in two_ranks[0]]
    for losses, norms, adapters, grad_norm in ranks:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        assert all(n > 0 for n in norms)
        np.testing.assert_allclose(grad_norm, norms[0], rtol=1e-5)
        assert adapters.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(adapters[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
            start = ads[k.rsplit("/", 1)[0]][k.rsplit("/", 1)[1]]
            assert not np.array_equal(adapters[k], start), k
    for k in want:
        np.testing.assert_array_equal(ranks[0][2][k], ranks[1][2][k], err_msg=k)


def test_training_cli_under_mesh_stage(two_ranks, tmp_path):
    """`training.cli --mesh-stage 2 --pp-interleave 2` on two ranks trains 2
    steps, saves, resumes to step 3; `models.convert_cli` writes an HF
    directory from the last step that `--verify` accepts, with whole
    [L, ...] stacks reassembled from the two stages' files."""
    from radvlm_tpu_torch.models import convert_cli
    from radvlm_tpu_torch.training import checkpoint as ckpt

    ranks, out = two_ranks
    for r in ranks:
        assert r[5] == (2, ["step_2"]) and r[6] == (3, ["step_3"])
    files = sorted(os.listdir(os.path.join(out, "step_3")))
    assert files == ["meta.json", "state.rank0.safetensors", "state.rank1.safetensors"]
    tree = ckpt.read_params(ckpt.CheckpointManager(out), 3)
    assert tree["text"]["layers"]["attn"]["q"]["kernel"].shape[0] == 4
    hf = str(tmp_path / "hf")
    model = convert_cli.main(["--checkpoint-dir", out, "--model-size", "tiny", "--output", hf,
                              "--verify", "--device", "cpu"])
    assert os.path.exists(os.path.join(hf, "model.safetensors"))
    assert len(model.text.layers) == 4


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["layers", "no_stage", "tensor", "interleave", "microbatches"])
def test_mesh_validation(case):
    """The port's checks raise the JAX package's ValueErrors, word for word."""
    cfg3 = (pp_config(cfglib, n_layers=3), pp_config(tcfglib, n_layers=3))
    cfg4 = (pp_config(cfglib), pp_config(tcfglib))
    shape, cfgs, kw = {
        "layers": ({"data": 2, "stage": 4}, cfg3, dict(n_microbatches=1)),
        "no_stage": ({"data": 8}, cfg4, dict(n_microbatches=1)),
        "tensor": ({"stage": 2, "tensor": 4}, cfg4, dict(n_microbatches=1)),
        "interleave": ({"data": 4, "stage": 2}, cfg4, dict(n_microbatches=2, interleave=4)),
        "microbatches": ({"data": 4, "stage": 2}, cfg4, dict(n_microbatches=3, interleave=2)),
    }[case]
    want = _raised(lambda: jpp.make_pp_grad_fn(jmesh.make_mesh(shape), cfgs[0], {}, **kw))
    assert _raised(lambda: pp.make_pp_grad_fn(shape, cfgs[1], **kw)) == want
