"""Parity of the port's resamplers (identity, spatial_pool, masked_drop,
perceiver, Q-Former) with the JAX package, alone and inside the whole
model, and masked_drop in the SFT train step.

JAX random-init trees go through the weight bridge; f32, plain attention:
atol 1e-5, rtol 1e-4. masked_drop's mask comes from a JAX key on one side
and a `torch.Generator` on the other, whose bits cannot agree: the parity
tests inject one uniform draw into both (`jax.random.uniform` and the
port's `resampler.draw_uniform`), and the contract (identity at inference,
whole tokens zeroed in training, about `drop_ratio` of them, a stream that
follows the step) is checked on the port's own draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import ResamplerConfig
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.models import resampler as jres
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch.models import convert, radvlm, resampler
from radvlm_tpu_torch.training import train_step as ts

TOL = dict(atol=1e-5, rtol=1e-4)

KINDS = {
    "identity": ResamplerConfig(),
    "spatial_pool_avg": ResamplerConfig(kind="spatial_pool", stride=2),
    "spatial_pool_max_crop": ResamplerConfig(kind="spatial_pool", stride=2, mode="max"),
    "perceiver": ResamplerConfig(kind="perceiver", depth=2, num_latents=6, num_heads=2,
                                 head_dim=8, ff_mult=2),
    "qformer": ResamplerConfig(kind="qformer", depth=2, num_latents=4, qformer_layers=3,
                               qformer_hidden=32, qformer_heads=2, qformer_intermediate=64),
    "masked_drop": ResamplerConfig(kind="masked_drop", drop_ratio=0.5),
}


def perturbed(tree, seed=1):
    noise = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "scale") for k in p) else x,
        jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name", list(KINDS))
def test_resampler_matches_jax(rng, name):
    rcfg = KINDS[name]
    side = 5 if name == "spatial_pool_max_crop" else 4  # 5 x 5 crops to 4 x 4
    feats = rng.normal(size=(3, side * side, 24)).astype(np.float32)
    tree = perturbed(jres.init_params(rcfg, 24, jax.random.key(2)))
    module = resampler.build(rcfg, 24, device="cpu", dtype=torch.float32)
    assert (module is None) == (not tree)
    if module is not None:
        convert.load_tower(module, tree)
        back = jax.tree.map(np.asarray, convert.module_to_tree(module))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
    ref = jres.forward(tree, rcfg, jnp.asarray(feats))
    out = resampler.forward(module, rcfg, torch.from_numpy(feats))
    assert out.shape == ref.shape
    assert out.shape[1] == resampler.output_tokens(rcfg, side * side) == jres.output_tokens(
        rcfg, side * side)
    assert resampler.output_dim(rcfg, 24) == jres.output_dim(rcfg, 24) == out.shape[-1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def inject_uniform(monkeypatch, u):
    """One uniform draw [N, T] for both packages' masked_drop."""
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    monkeypatch.setattr(resampler, "draw_uniform", lambda gen, shape, device: torch.from_numpy(u))


def test_masked_drop_with_an_injected_mask(rng, monkeypatch):
    rcfg = KINDS["masked_drop"]
    feats = rng.normal(size=(2, 16, 4)).astype(np.float32)
    u = rng.uniform(size=(2, 16)).astype(np.float32)
    inject_uniform(monkeypatch, u)
    ref = jres.forward({}, rcfg, jnp.asarray(feats), rng=jax.random.key(0), training=True)
    out = resampler.forward(None, rcfg, torch.from_numpy(feats),
                            generator=torch.Generator().manual_seed(0), training=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert ((out.numpy() == 0).all(-1) == (u < rcfg.drop_ratio)).all()


def test_masked_drop_train_vs_infer(rng):
    """The contract of tests/test_resampler.py on the port's own draws."""
    rcfg = KINDS["masked_drop"]
    feats = torch.from_numpy(rng.normal(size=(2, 64, 4)).astype(np.float32) + 3.0)
    assert torch.equal(resampler.forward(None, rcfg, feats), feats)
    assert torch.equal(resampler.forward(None, rcfg, feats, training=True), feats)  # no stream
    out = resampler.forward(None, rcfg, feats, generator=torch.Generator().manual_seed(1),
                            training=True).numpy()
    assert out.shape == (2, 64, 4)
    zeroed = (out == 0).all(axis=-1)
    assert 0.2 < zeroed.mean() < 0.8
    np.testing.assert_array_equal(out[~zeroed], feats.numpy()[~zeroed])
    # The train step's stream: seeded by the step, the same after a resume.
    cfg = dataclasses.replace(tcfg.tiny_test_config(), resampler=rcfg)
    cpu = torch.device("cpu")
    draws = [torch.rand(8, generator=ts.resampler_generator(cfg, s, cpu)) for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert ts.resampler_generator(tcfg.tiny_test_config(), 3, cpu) is None


def test_perceiver_rejects_anyres():
    for mod in (cfglib, tcfg):
        with pytest.raises(ValueError, match="spatial"):
            mod.RadVLMConfig(resampler=ResamplerConfig(kind="perceiver"),
                             image_aspect_ratio="anyres_max_9")


def vlm_config(rcfg, **kw):
    return dataclasses.replace(cfglib.tiny_test_config(vocab_size=300), resampler=rcfg, **kw)


def vlm_batch(rng, cfg, n=2):
    tok = lambda s: [2 + b for b in s.encode()]
    imgs = [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)][:n]
    samples = [jmm.build_sample(jmm.tokenize_with_images(tok, p), [im], cfg)
               for p, im in zip(["<image>\nhi", "a longer <image>\nprompt"], imgs)]
    return jmm.collate(samples, pad_to_multiple=32, left_pad=True)


@pytest.mark.parametrize("name,aspect", [("perceiver", "pad"), ("spatial_pool_avg", "anyres_max_9"),
                                         ("qformer", "pad")])
def test_radvlm_forward_with_resampler_matches_jax(rng, name, aspect):
    cfg = vlm_config(KINDS[name], image_aspect_ratio=aspect)
    assert tcfg.tokens_per_tile(cfg) == cfg.tokens_per_tile
    assert tcfg.feature_grid_side(cfg) == cfg.feature_grid_side
    params = perturbed(jrad.init_params(cfg, jax.random.key(5)))
    batch = vlm_batch(rng, cfg)
    ref, _ = jrad.forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          attn_impl="xla")
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    assert model.projector.fcs[0].weight.shape[1] == resampler.output_dim(
        cfg.resampler, cfg.vision.hidden_size)
    out, _ = radvlm.forward(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            attn_impl="xla")
    real = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)
    tree = convert.radvlm_to_tree(model)
    assert ("resampler" in tree) == ("resampler" in params)


def test_sft_step_with_masked_drop_matches_jax(rng, monkeypatch):
    """One SFT micro-step through `training/train_step.py` with masked_drop:
    the loss is finite, equals the JAX train step's loss when both draw the
    same mask, and differs from the drop-free loss."""
    import optax

    from radvlm_tpu.training import train_step as jts
    from radvlm_tpu_torch.training.optimizer import TrainConfig

    torch.set_num_threads(1)
    cfg = vlm_config(ResamplerConfig(kind="masked_drop", drop_ratio=0.6))
    params = jrad.init_params(cfg, jax.random.key(7))
    batch = vlm_batch(rng, cfg)
    batch["labels"] = batch["tokens"]
    n_tiles = batch["tiles"].shape[0] * batch["tiles"].shape[1]
    u = rng.uniform(size=(n_tiles, cfg.vision.tokens_per_tile)).astype(np.float32)
    inject_uniform(monkeypatch, u)
    tx = optax.sgd(1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                            opt_state=tx.init(jparams))
    jstep = jts.make_train_step(cfg, tx, remat=False, attn_impl="xla", donate=False)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    plain, _ = jrad.loss_fn(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=False, attn_impl="xla")

    model = convert.radvlm_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    state, step_fn, _ = ts.setup_training(cfg, TrainConfig(total_steps=4), model, remat=False,
                                          attn_impl="xla")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step_fn(state, tb)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and abs(loss - float(plain)) > 1e-4
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
