"""LoRA and QLoRA in the port against the JAX package at the tiny config:
the same base (dense f32, or int8 through the weight bridge) and the same
adapters, made with numpy, go through both. f32 on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu.training import lora as jlora
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.models.layers import Linear, QLinear
from radvlm_tpu_torch.ops import quant as tquant
from radvlm_tpu_torch.training import lora as tlora
from radvlm_tpu_torch.training import loop as tloop
from radvlm_tpu_torch.training import optimizer as topt
from radvlm_tpu_torch.training import train_step as tts

from test_torch_train import ByteTok, VOCAB, _batches, _leaves, _np_tree, _write_llava_json

RANK = 4


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=VOCAB)
    params = _np_tree(jrad.init_params(cfg, jax.random.key(0)))
    qparams = _np_tree(jquant.quantize_params(jax.tree.map(jnp.asarray, params)))
    return cfg, tiny_test_config(vocab_size=VOCAB), {"dense": params, "int8": qparams}


def _adapters(jcfg, base):
    """Non-zero A and B for every target, as numpy, in the JAX layout."""
    lcfg = jlora.LoraConfig(rank=RANK, alpha=8.0)
    shapes = jlora.init_lora(jax.tree.map(jnp.asarray, base), lcfg, jax.random.key(1))
    rng = np.random.default_rng(5)
    return {p: {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in ad.items()}
            for p, ad in shapes.items()}


def _torch_adapters(ads):
    return {p: {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in ad.items()}
            for p, ad in ads.items()}


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_merge_lora_forward_matches_jax(tiny, base):
    """Logits of the adapted model (1e-4: f32 sums in another order)."""
    jcfg, tcfg, bases = tiny
    ads = _adapters(jcfg, bases[base])
    batch = _batches(jcfg, tcfg, packed=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lcfg = jlora.LoraConfig(rank=RANK, alpha=8.0)
    with jquant.training_mode():
        merged = jlora.merge_lora(jax.tree.map(jnp.asarray, bases[base]),
                                  jax.tree.map(jnp.asarray, ads), lcfg)
        ref, _ = jrad.forward(merged, jcfg, jb, attn_impl="xla")
    model = convert.radvlm_from_jax(bases[base], tcfg, device="cpu", dtype=torch.float32)
    kind = QLinear if base == "int8" else Linear
    assert isinstance(model.text.layers[0].q, kind)
    tlora.merge_lora(model, _torch_adapters(ads), tlora.LoraConfig(rank=RANK, alpha=8.0))
    with torch.no_grad(), tquant.training_mode():
        out, _ = radvlm.forward(model, tcfg, batch_to_device(batch, "cpu"))
        plain, _ = radvlm.forward(
            tlora.merge_lora(model, {}, tlora.LoraConfig(rank=RANK)), tcfg,
            batch_to_device(batch, "cpu"))
    live = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live], atol=1e-4, rtol=1e-4)
    assert float((out - plain).abs().max()) > 1e-3  # the adapters do something


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("base", ["dense", "int8"])
def test_lora_steps_match_jax(tiny, base, accum):
    """Three micro-steps of the LoRA step leave the adapters the JAX
    `make_lora_train_step` leaves (rtol 1e-4, atol 1e-6) and never touch the
    base; losses 1e-5 relative."""
    jcfg, tcfg, bases = tiny
    ads = _adapters(jcfg, bases[base])
    kw = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=0.3, warmup_ratio=0.0,
              total_steps=6, grad_accum_steps=accum, adam_eps=1e-5)
    batches = [_batches(jcfg, tcfg, packed=bool(i % 2), seed=3 * i) for i in range(3)]
    # JAX
    jtrain, lcfg = jopt.TrainConfig(**kw), jlora.LoraConfig(rank=RANK, alpha=8.0)
    tx = optax.chain(
        optax.clip_by_global_norm(jtrain.max_grad_norm),
        optax.adamw(jopt.make_schedule(jtrain, jtrain.learning_rate), b1=jtrain.adam_b1,
                    b2=jtrain.adam_b2, eps=jtrain.adam_eps, weight_decay=jtrain.weight_decay))
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    jads = jax.tree.map(jnp.asarray, ads)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jads, opt_state=tx.init(jads))
    jbase = jax.tree.map(jnp.asarray, bases[base])
    jstep = jts.make_lora_train_step(jcfg, lcfg, tx, remat=False, attn_impl="xla")
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jbase, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
    # the port
    model = convert.radvlm_from_jax(bases[base], tcfg, device="cpu", dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, model, step_fn = tts.setup_lora_training(
        tcfg, topt.TrainConfig(**kw), tlora.LoraConfig(rank=RANK, alpha=8.0), model,
        adapters=_torch_adapters(ads))
    norms = []
    for i, b in enumerate(batches):
        state, m = step_fn(state, model, batch_to_device(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), jlosses[i], rtol=1e-5)
        norms.append(float(m["grad_norm"]))
    assert all(n > 0 for n in norms)
    for path, ad in state.params.items():
        for k in ("a", "b"):
            np.testing.assert_allclose(ad[k].detach().numpy(), np.asarray(jstate.params[path][k]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{path}/{k}")
            assert not np.array_equal(ad[k].detach().numpy(), ads[path][k])
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) and p.grad is None, n


def test_training_mode_keeps_the_activation_gradient(tiny, monkeypatch):
    """Under `training_mode` a quantized matmul never takes a quantized
    kernel route and the activations keep their gradient; outside it the
    W8A8 route's rounding stops it."""
    _, tcfg, bases = tiny
    model = convert.radvlm_from_jax(bases["int8"], tcfg, device="cpu", dtype=torch.float32)
    lin = model.text.layers[0].q
    x = torch.randn(80, lin.weight.shape[1], requires_grad=True)  # > 64 rows: the W8A8 route
    assert tquant.qmm_route(80) == "w8a8" and tquant.qmm_route(8) == "int8"
    assert tquant.qmm_route(80, bits=4) == "dequant" and tquant.qmm_route(8, bits=4) == "int4"
    with tquant.training_mode():
        assert tquant.qmm_route(80) == tquant.qmm_route(8) == "dequant"
        assert tquant.qmm_route(8, bits=4) == "dequant"

        def refuse(*a, **k):
            raise AssertionError("a quantized kernel route was taken in training mode")

        for name in ("int8_matmul", "w8a8_matmul", "w8a8_matmul_fused", "int4_matmul",
                     "quantize_rows"):
            monkeypatch.setattr(tquant, name, refuse)
        (gx,) = torch.autograd.grad(lin(x).square().sum(), x)
        assert float((gx != 0).float().mean()) > 0.99
        ref = torch.nn.functional.linear(
            x, tquant.dequantize_array(lin.weight, lin.scale[:, None], torch.float32), lin.bias)
        np.testing.assert_allclose(lin(x).detach().numpy(), ref.detach().numpy(), atol=1e-6)
    assert tquant.qmm_route(80) == "w8a8"  # the flag is restored
    monkeypatch.undo()
    # W8A8: round() has a zero gradient; what is left reaches x only through
    # each row's scale, at the one element that holds the row's maximum.
    (gx,) = torch.autograd.grad(lin(x).square().sum(), x)
    assert float((gx != 0).float().mean()) <= 1.0 / x.shape[1] + 1e-6


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_merge_and_bake_matches_jax(tiny, base):
    jcfg, tcfg, bases = tiny
    ads = _adapters(jcfg, bases[base])
    baked = jlora.merge_and_bake(jax.tree.map(jnp.asarray, bases[base]),
                                 jax.tree.map(jnp.asarray, ads),
                                 jlora.LoraConfig(rank=RANK, alpha=8.0))
    model = convert.radvlm_from_jax(bases[base], tcfg, device="cpu", dtype=torch.float32)
    tlora.merge_and_bake(model, _torch_adapters(ads), tlora.LoraConfig(rank=RANK, alpha=8.0))
    assert all(m.lora is None for m in model.modules() if isinstance(m, (Linear, QLinear)))
    got, want = _leaves(convert.radvlm_to_tree(model)), _leaves(baked)
    assert got.keys() == want.keys()
    for k in want:
        if want[k].dtype == np.int8:
            # Requantized from dequant + delta: an f32 sum in another order
            # may move a value across a rounding boundary by one step.
            assert np.abs(got[k].astype(np.int32) - want[k].astype(np.int32)).max() <= 1, k
            assert (got[k] != want[k]).mean() < 1e-3, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_init_lora(tiny):
    _, tcfg, bases = tiny
    cfg = tlora.LoraConfig(rank=8)
    for base, dtype in (("dense", torch.float32), ("int8", torch.float32)):
        model = convert.radvlm_from_jax(bases[base], tcfg, device="cpu", dtype=torch.float32)
        ads = tlora.init_lora(model, cfg, torch.Generator().manual_seed(3))
        again = tlora.init_lora(model, cfg, torch.Generator().manual_seed(3))
        assert sorted(ads) == sorted(
            [f"text/layers/attn/{n}/kernel" for n in "qkvo"]
            + [f"text/layers/mlp/{n}/kernel" for n in ("gate", "up", "down")])
        for path, ad in ads.items():
            mods = tlora.stacked_kernels(model)[path]
            d_out, d_in = mods[0].weight.shape
            assert ad["a"].shape == (len(mods), d_in, 8) and ad["b"].shape == (len(mods), 8, d_out)
            assert ad["a"].dtype == ad["b"].dtype == dtype and ad["a"].requires_grad
            assert float(ad["b"].detach().abs().max()) == 0
            assert 0.005 < float(ad["a"].detach().std()) < 0.02
            assert torch.equal(ad["a"], again[path]["a"])
    # An int4 base raises, as in the JAX package.
    wide = dataclasses.replace(
        tcfg, text=dataclasses.replace(tcfg.text, hidden_size=128, intermediate_size=256,
                                       head_dim=32))
    q4 = convert.random_quantized_params(wide, torch.Generator().manual_seed(0), device="cpu",
                                         dtype=torch.float32, bits=4, fuse=False)
    with pytest.raises(NotImplementedError, match="int4"):
        tlora.init_lora(q4, cfg, torch.Generator().manual_seed(0))


def test_loop_qlora_on_cpu(tmp_path):
    """`loop.train` with `lora_rank` and `quantize_base`: the base is
    quantized, only the adapters move, and the run resumes."""
    data = _write_llava_json(str(tmp_path))
    cfg = tiny_test_config(vocab_size=VOCAB)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                dtype=torch.float32)
    run = tloop.RunConfig(
        model=cfg, train=topt.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0, total_steps=10,
                                          grad_accum_steps=1, lr_schedule="constant"),
        data_path=data, image_root=str(tmp_path), micro_batch_size=2, max_steps=3, log_every=1,
        checkpoint_dir=str(tmp_path / "ckpt"), save_steps=2, lora_rank=RANK, quantize_base=True,
        buckets=(tloop.DEFAULT_BUCKETS[0].__class__(512, 8),), loader_workers=2, device="cpu",
        num_epochs=4)
    seen = []
    state = tloop.train(run, ByteTok.encode, init_params=model,
                        metrics_callback=lambda s, m: seen.append((s, m)))
    assert state.step == 3 and [s for s, _ in seen] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and m["tokens_per_sec"] > 0 for _, m in seen)
    assert isinstance(model.text.layers[0].q, QLinear)  # quantized in place
    base_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert any(float(ad["b"].detach().abs().max()) > 0 for ad in state.params.values())
    b_before = {p: ad["b"].detach().clone() for p, ad in state.params.items()}
    resumed = tloop.train(dataclasses.replace(run, max_steps=5), ByteTok.encode, init_params=model)
    assert resumed.step == 5
    with open(os.path.join(str(tmp_path / "ckpt"), "data_state.json")) as f:
        assert json.load(f)["step"] == 5
    assert any(not torch.equal(ad["b"], b_before[p]) for p, ad in resumed.params.items())
    for n, p in model.named_parameters():
        assert torch.equal(p, base_before[n]), n
    with pytest.raises(ValueError, match="QLoRA"):
        tloop.train(dataclasses.replace(run, lora_rank=0), ByteTok.encode, init_params=model)
