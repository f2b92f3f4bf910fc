"""The port's training path against the JAX package at the tiny config:
`loss_fn` and its gradients, the schedules, N optimizer steps, checkpoints
and the CLI. Parameters cross as numpy through the weight bridge
(`convert.radvlm_from_jax` / `radvlm_to_tree`); the same numpy batch goes
through both. f32 on the CPU; the JAX side runs attn_impl="xla", the port
its plain attention forward and the hand-written backward formulas.
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
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch.config import IGNORE_INDEX, tiny_test_config
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.models.quant_io import _unflatten_tree
from radvlm_tpu_torch.models import safetensors_io
from radvlm_tpu_torch.training import checkpoint as ckpt
from radvlm_tpu_torch.training import cli as tcli
from radvlm_tpu_torch.training import optimizer as topt
from radvlm_tpu_torch.training import train_step as tts

VOCAB = 300


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=VOCAB)
    params = _np_tree(jrad.init_params(cfg, jax.random.key(0)))
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
               for k in p) else x,
        params,
    )
    return cfg, tiny_test_config(vocab_size=VOCAB), params


# A Gemma-shaped decoder at a narrow width: gemma_2b's head (MQA, head_dim
# 256, the D = 256 instances of K7 / K8 on the card), GeGLU, (1 + w)
# RMSNorm, sqrt(d)-scaled embeddings and a tied head, two layers.
GEMMA_TEXT = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
                  num_kv_heads=1, head_dim=256, attention_bias=False, tie_word_embeddings=True,
                  hidden_act="gelu_tanh", rms_norm_offset=True, embed_normalizer=True)


@pytest.fixture(scope="module")
def tiny_gemma(tiny):
    jcfg, tcfg, _ = tiny
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, **GEMMA_TEXT))
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, **GEMMA_TEXT))
    params = _np_tree(jrad.init_params(jcfg, jax.random.key(2)))
    noise = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
               for k in p) else x,
        params,
    )
    return jcfg, tcfg, params


def _sample(mod, cfg, seed, n_prompt, n_reply):
    r = np.random.default_rng(seed)
    img = r.integers(0, 255, (70, 90, 3), dtype=np.uint8)
    ids = ([int(t) for t in r.integers(2, VOCAB, n_prompt)] + [-200]
           + [int(t) for t in r.integers(2, VOCAB, n_reply)])
    labels = [IGNORE_INDEX] * (n_prompt + 1) + ids[n_prompt + 1:]
    return mod.build_sample(ids, [img], cfg, labels=labels)


def _batches(jcfg, tcfg, packed, seed=0):
    """The same batch from both packages' host code (asserted equal)."""
    out = []
    for mod, cfg in ((jmm, jcfg), (tmm, tcfg)):
        s = [_sample(mod, cfg, seed + i, 4 + 3 * i, 5 + i) for i in range(4)]
        rows = [mod.pack_samples(s[:2]), mod.pack_samples(s[2:])] if packed else s[:2]
        out.append(mod.collate(rows, pad_to_multiple=128))
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k
    return out[0]


def _torch_model(tcfg, params, parts="mm_vision_tower,mm_mlp_adapter,mm_language_model"):
    model = convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    topt.mark_trainable(model, topt.TrainConfig(mm_tunable_parts=parts))
    return model


def _grad_tree(model):
    """The gradients as a JAX-shaped tree (through the inverse bridge)."""
    saved = {n: p.data for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    tree = convert.radvlm_to_tree(model)
    for n, p in model.named_parameters():
        p.data = saved[n]
    return tree


LOSS_CASES = [
    ("remat_packed", True, 1024, True, False),
    ("noremat_unpacked", False, 1024, False, False),
    ("remat_chunked_packed", True, 50, True, False),
    ("noremat_chunked_unpacked", False, 37, False, False),
    ("remat_labels_next", True, 1024, True, True),
    ("chunked_labels_next", False, 64, False, True),
    # The Gemma-shaped decoder (`tiny_gemma`).
    ("gemma_d256_remat_packed", True, 1024, True, False),
]


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_and_gradients_match_jax(request, case):
    """Same loss (1e-5 relative) and the same gradient for every leaf as the
    JAX `loss_fn`. Gradients: atol 3e-5 (the attention backward's own
    tolerance; some leaves, the k biases, have a true gradient of 0 and hold
    only rounding noise) and rtol 1e-4."""
    name, remat, chunk, packed, labels_next = case
    jcfg, tcfg, params = request.getfixturevalue(
        "tiny_gemma" if name.startswith("gemma") else "tiny")
    batch = _batches(jcfg, tcfg, packed)
    if labels_next:
        nxt = np.full_like(batch["labels"], IGNORE_INDEX)
        nxt[:, :-1] = np.where(batch["segment_ids"][:, 1:] != 0, batch["labels"][:, 1:],
                               IGNORE_INDEX)
        batch = {k: v for k, v in batch.items() if k != "labels"}
        batch["labels_next"] = nxt
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jrad.loss_fn(p, jcfg, jbatch, remat=False, attn_impl="xla"), has_aux=True)(params)
    model = _torch_model(tcfg, params)
    tl, tm = radvlm.loss_fn(model, tcfg, batch_to_device(batch, "cpu"), remat=remat, chunk=chunk)
    tl.backward()
    assert int(tm["tokens"]) == int(jm["tokens"]) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got, want = _leaves(_grad_tree(model)), _leaves(jg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, rtol=1e-4, err_msg=k)


SCHEDULES = [
    ("cosine", 0.03, 200), ("cosine", 0.0, 20), ("cosine", 0.5, 7), ("linear", 0.1, 40),
    ("linear", 0.0, 10), ("constant", 0.2, 25), ("constant", 0.0, 10), ("cosine", 0.03, 10),
]


@pytest.mark.parametrize("kind,warmup,total", SCHEDULES)
def test_schedules_match_optax(kind, warmup, total):
    """Every step of a run (and past its end) against the optax schedule the
    JAX package builds. optax computes in f32, and near the end of a cosine
    its 1 + cos cancels: 2e-5 relative plus 1e-6 of the peak."""
    kw = dict(lr_schedule=kind, warmup_ratio=warmup, total_steps=total)
    want = jopt.make_schedule(jopt.TrainConfig(**kw), 3e-4)
    got = topt.make_schedule(topt.TrainConfig(**kw), 3e-4)
    for step in range(total + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-5, atol=3e-10,
                                   err_msg=f"step {step}")


def test_clip_matches_optax_not_clip_grad_norm():
    g = {"a": np.array([3.0, 4.0], np.float32), "b": np.array([12.0], np.float32)}  # norm 13
    for max_norm in (1.0, 20.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            jax.tree.map(jnp.asarray, g), optax.EmptyState())
        p = {k: torch.zeros(v.shape, requires_grad=True) for k, v in g.items()}
        cfg = topt.TrainConfig(max_grad_norm=max_norm, grad_accum_steps=1, lr_schedule="constant",
                               warmup_ratio=0.0, learning_rate=1.0, adam_b1=0.0, adam_b2=0.0,
                               adam_eps=1e30)
        opt = topt.Optimizer(p, dict.fromkeys(p, "g"), {"g": 1.0}, cfg)
        for k in p:
            p[k].grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        assert float(norm) == pytest.approx(13.0)
        # With b1 = b2 = 0 and a huge eps the update is -lr * clipped / eps.
        for k in p:
            np.testing.assert_allclose(-p[k].detach().numpy() * 1e30, np.asarray(want[k]),
                                       rtol=1e-6)


STEP_CASES = [
    ("accum1_all", 1, "mm_vision_tower,mm_mlp_adapter,mm_language_model", 4),
    ("accum2_all", 2, "mm_vision_tower,mm_mlp_adapter,mm_language_model", 5),
    ("accum2_frozen_tower", 2, "mm_mlp_adapter,mm_language_model", 4),
    ("accum1_projector_only", 1, "mm_mlp_adapter", 3),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_steps_match_jax(tiny, case):
    """N micro-steps of `make_train_step` leave the parameters the JAX
    `make_train_step` leaves (per-group rates, warmup + cosine, weight
    decay, an active clip). Losses 1e-5 relative. Parameters: rtol 1e-5 and
    atol 2e-5: Adam divides each gradient by its own running magnitude, so
    on the leaves whose true gradient is 0 (the k biases: softmax does not
    see a shift of every key) the two packages' rounding noise becomes
    updates of up to the learning rate (1e-3) times the noise's share of
    adam_eps (1e-5 here, raised from 1e-8 to bound exactly that)."""
    _, accum, parts, n_steps = case
    jcfg, tcfg, params = tiny
    kw = dict(learning_rate=1e-3, vision_tower_lr=5e-4, projector_lr=2e-3, weight_decay=0.01,
              max_grad_norm=0.5, warmup_ratio=0.25, total_steps=8, grad_accum_steps=accum,
              mm_tunable_parts=parts, adam_eps=1e-5)
    batches = [_batches(jcfg, tcfg, packed=bool(i % 2), seed=10 * i) for i in range(n_steps)]
    # JAX
    jtrain = jopt.TrainConfig(**kw)
    tx, labels = jopt.make_optimizer(params, jtrain)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                            opt_state=tx.init(jparams))
    jstep = jts.make_train_step(jcfg, tx, remat=False, attn_impl="xla", donate=False)
    jlosses, jnorm0 = [], None
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if i == 0:  # the norm over the trainable leaves only
            g = jax.grad(lambda p: jrad.loss_fn(p, jcfg, jb, remat=False, attn_impl="xla")[0])(
                jparams)
            g = jax.tree.map(lambda x, l: x if l != "frozen" else jnp.zeros_like(x), g, labels)
            jnorm0 = float(optax.global_norm(g))
        jstate, m = jstep(jstate, jb)
        jlosses.append(float(m["loss"]))
    # the port
    model = convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    state, step_fn, opt = tts.setup_training(tcfg, topt.TrainConfig(**kw), model, remat=True)
    for i, b in enumerate(batches):
        state, m = step_fn(state, batch_to_device(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), jlosses[i], rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), jnorm0, rtol=1e-4)
    assert state.step == n_steps and opt.count == n_steps // accum
    got, want = _leaves(convert.radvlm_to_tree(model)), _leaves(jstate.params)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(want[k], np.asarray(_leaves(params)[k])))
    assert moved > 0
    if "mm_vision_tower" not in parts:  # frozen leaves did not move at all
        for k in want:
            if k.startswith("['vision_tower']"):
                assert np.array_equal(got[k], _leaves(params)[k]), k


def _run_steps(tcfg, params, batches, train_cfg):
    model = convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    state, step_fn, _ = tts.setup_training(tcfg, train_cfg, model)
    for b in batches:
        state, _ = step_fn(state, batch_to_device(b, "cpu"))
    return state


def test_checkpoint_round_trip_and_jax_load(tiny, tmp_path):
    """Save in the middle of an accumulation window, restore into a fresh
    state, continue: the run equals an uninterrupted one (to 1e-6: two
    identical runs on the CPU differ by ~1e-8 already, its threaded
    reductions sum in varying order, and adam_eps = 1e-5 keeps Adam from
    blowing that noise up on leaves whose true gradient is 0; a lost moment
    or accumulator would move the parameters by the learning rate, 1e-3). The saved parameters load
    into the JAX package and give the port's loss."""
    jcfg, tcfg, params = tiny
    cfg = topt.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=8,
                           grad_accum_steps=2, weight_decay=0.01, adam_eps=1e-5)
    batches = [_batches(jcfg, tcfg, packed=True, seed=7 * i) for i in range(4)]
    straight = _run_steps(tcfg, params, batches, cfg)
    first = _run_steps(tcfg, params, batches[:3], cfg)
    manager = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=3)
    assert not ckpt.save_state(manager, 2, first)  # not a multiple of 3
    assert ckpt.save_state(manager, 3, first)
    assert not ckpt.save_state(manager, 3, first)  # saved already
    assert manager.latest_step() == 3
    ckpt.save_data_state(str(tmp_path), 3, 0, 3)
    assert ckpt.load_data_state(str(tmp_path), 3) == {"step": 3, "epoch": 0, "batch_in_epoch": 3}
    assert ckpt.load_data_state(str(tmp_path), 4) is None  # stale sidecar
    fresh = _run_steps(tcfg, params, [], cfg)
    resumed = ckpt.restore_state(manager, 3, fresh)
    assert resumed.step == 3 and resumed.opt_state.mini_step == 1 and resumed.opt_state.count == 1
    _, step_fn, _ = None, tts.make_train_step(tcfg, resumed.opt_state), None
    resumed, _ = step_fn(resumed, batch_to_device(batches[3], "cpu"))
    for (n, a), (_, b) in zip(straight.params.named_parameters(),
                              resumed.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    # max_to_keep: a third step drops the oldest.
    assert ckpt.save_state(manager, 4, resumed, force=True)
    assert ckpt.save_state(manager, 6, resumed)
    assert manager.all_steps() == [4, 6]
    # The saved parameters, read back as the JAX package's tree.
    flat = safetensors_io.read_file(os.path.join(str(tmp_path), "step_6", "state.safetensors"))
    tree = _unflatten_tree({k[len("params/"):]: jnp.asarray(v.numpy())
                            for k, v in flat.items() if k.startswith("params/")})
    assert _leaves(tree).keys() == _leaves(params).keys()
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jl, _ = jrad.loss_fn(tree, jcfg, jb, remat=False, attn_impl="xla")
    with torch.no_grad():
        tl, _ = radvlm.loss_fn(resumed.params, tcfg, batch_to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


class ByteTok:
    eos_token_ids, pad_token_id = (1,), 0

    @staticmethod
    def encode(text):
        return [2 + b for b in text.encode()]


def _write_llava_json(root, n=6):
    from PIL import Image

    rng = np.random.default_rng(0)
    cells = []
    for i in range(n):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (60 + 4 * i, 80, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        cells.append({"id": str(i), "image": name, "conversations": [
            {"from": "human", "value": "<image>\nAny effusion?"},
            {"from": "gpt", "value": "No effusion." if i % 2 else "Small left effusion."}]})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cells, f)
    return path


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    """`training.cli` end to end on a tiny llava-json with `--device cpu`:
    trains, checkpoints, and a second call resumes from the checkpoint."""
    data = _write_llava_json(str(tmp_path))
    out = str(tmp_path / "ckpt")
    argv = ["--model-size", "tiny", "--data-path", data, "--image-folder", str(tmp_path),
            "--output-dir", out, "--device", "cpu", "--micro-batch-size", "1",
            "--pack-factor", "2", "--buckets", "256:4,512:8", "--grad-accum-steps", "2",
            "--save-steps", "2", "--log-every", "1",
            "--num-epochs", "3", "--learning-rate", "1e-3"]
    tcli.main(argv + ["--max-steps", "2"], tokenizer=ByteTok())
    assert "training finished at step 2" in capsys.readouterr().out
    assert ckpt.CheckpointManager(out).latest_step() == 2
    with open(os.path.join(out, "data_state.json")) as f:
        assert json.load(f) == {"step": 2, "epoch": 0, "batch_in_epoch": 2}
    tcli.main(argv + ["--max-steps", "5"], tokenizer=ByteTok())
    assert "training finished at step 5" in capsys.readouterr().out
    assert ckpt.CheckpointManager(out).latest_step() == 5


@pytest.mark.parametrize("flag", ["--mesh-seq", "--mesh-stage", "--mesh-tensor", "--mesh-data"])
def test_cli_mesh_flags_raise(tmp_path, flag):
    """In one process without a process group, a mesh of two ranks raises
    `make_mesh`'s ValueError naming torchrun (the runs over two ranks are
    tests/test_torch_mesh_train.py's and, for `--mesh-stage`,
    tests/test_torch_pp.py's)."""
    data = _write_llava_json(str(tmp_path), n=2)
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main(["--model-size", "tiny", "--data-path", data, "--image-folder", str(tmp_path),
                   "--device", "cpu", flag, "2"], tokenizer=ByteTok())


def test_cli_multihost_raises(tmp_path):
    """`--multihost` outside torchrun's environment raises, naming it."""
    with pytest.raises(ValueError, match="torchrun"):
        tcli.main(["--data-path", "x.json", "--multihost"], tokenizer=ByteTok())


def test_loop_trains_from_an_hf_directory(tiny, tmp_path):
    """`loop.train(hf_checkpoint=...)`: the HF directory (written by the JAX
    package) loads as f32 master weights, the tunable groups get gradients
    and move, the frozen tower does not, and the trained parameters come
    back as the JAX package's tree."""
    from radvlm_tpu.models.hf_export import save_radvlm_hf
    from radvlm_tpu_torch.training import loop as tloop

    jcfg, tcfg, params = tiny
    hf = str(tmp_path / "hf")
    save_radvlm_hf(jax.tree.map(jnp.asarray, params), jcfg, hf)
    data = _write_llava_json(str(tmp_path))
    run = tloop.RunConfig(
        model=tcfg, train=topt.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=4,
                                           grad_accum_steps=1,
                                           mm_tunable_parts="mm_mlp_adapter,mm_language_model"),
        data_path=data, image_root=str(tmp_path), micro_batch_size=2, max_steps=2,
        buckets=(tloop.DEFAULT_BUCKETS[0].__class__(512, 8),), loader_workers=2, device="cpu")
    state = tloop.train(run, ByteTok.encode, hf_checkpoint=hf)
    model = state.params
    assert state.step == 2 and all(p.dtype == torch.float32 for p in model.parameters())
    assert not any(p.requires_grad for p in model.vision_tower.parameters())
    assert all(p.requires_grad for p in model.text.parameters())
    got, want = _leaves(convert.radvlm_to_tree(model)), _leaves(params)
    assert got.keys() == want.keys()
    for k in want:
        if k.startswith("['vision_tower']"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not np.array_equal(got["['text']['norm']"], want["['text']['norm']"])
    assert not np.array_equal(got["['projector']['fc0']['kernel']"],
                              want["['projector']['fc0']['kernel']"])
