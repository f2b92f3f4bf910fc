"""The port's GRPO (`radvlm_tpu_torch/training/grpo.py`) against the JAX
package at the tiny config: rewards and advantages exactly, rollouts through
one duck-typed engine stub with fixed emitted tokens passed to both
packages, the update batch, the loss on- and off-policy, and two updates of
a mu = 2 wave (f32 on the CPU; the JAX side runs attn_impl="xla"). Then the
driver and the CLI end to end on the CPU, where the rollouts are sampled
(the two packages' samplers draw differently, so no sampled token is
compared across them).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.training import grpo as jgrpo
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch.config import tiny_test_config
from radvlm_tpu_torch.data.chat import QWEN_CHATML
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
from radvlm_tpu_torch.generation.engine import GenerationConfig
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.training import grpo, grpo_cli
from radvlm_tpu_torch.training import loop as tloop
from radvlm_tpu_torch.training import optimizer as topt
from radvlm_tpu_torch.training import train_step as tts

VOCAB = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models' small ops: several test
    workers share the cores, and PyTorch's thread pools contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=VOCAB)
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
               for k in p) else x,
        jax.tree.map(np.asarray,
                     jax.jit(jrad.init_params, static_argnums=0)(cfg, jax.random.key(0))),
    )
    return cfg, tiny_test_config(vocab_size=VOCAB), params


TEXTS = ["box: [0.10, 0.10, 0.50, 0.50]", "somewhere upper left", "[0.80, 0.80, 0.90, 0.90]",
         "[0.10, 0.10, 0.30, 0.50] and [0.2, 0.1, 0.5, 0.45]", "",
         "There is a small left pleural effusion. No pneumothorax.",
         "pleural effusion and cardiomegaly", "cardiomegaly, pneumonia", "no findings",
         "Small left pleural effusion present.", "The weather is sunny today."]
SOLUTIONS = ['{"bbox": [[0.1, 0.1, 0.5, 0.5]]}', '{"bbox_2d": [0.1, 0.2, 0.5, 0.6], "label": "x"}',
             "[0.1, 0.2, 0.5, 0.6]", "at [0.10, 0.20, 0.50, 0.60] maybe", "no boxes here",
             "Findings: Pleural Effusion, Cardiomegaly.", "No Finding",
             "There is a small left pleural effusion. No pneumothorax."]


@pytest.mark.parametrize("reward", ["rec", "report", "classification", "ciderdrl"])
def test_rewards_equal_jax(tmp_path, reward):
    """Every reward of the registry, and the solution parser, give the JAX
    package's values (to 1e-12) on the same texts and solutions."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(SOLUTIONS[5:] + TEXTS[5:]))
    kw = dict(reward=reward, cider_corpus=str(corpus), format_weight=0.2, acc_weight=0.7)
    jgc, tgc = jgrpo.GRPOConfig(**kw), grpo.GRPOConfig(**kw)
    for sol in SOLUTIONS:
        assert grpo.parse_solution_boxes(sol) == jgrpo.parse_solution_boxes(sol)
        jcell = jgrpo.GRPOCell([1], [], jgrpo.parse_solution_boxes(sol), sol)
        tcell = grpo.GRPOCell([1], [], grpo.parse_solution_boxes(sol), sol)
        for text in TEXTS:
            want = jgrpo.REWARD_FNS[reward](text, jcell, jgc)
            got = grpo.REWARD_FNS[reward](text, tcell, tgc)
            assert abs(got - want) <= 1e-12, (reward, text, sol, got, want)


def test_group_advantages_equal_jax():
    rewards = np.random.default_rng(0).random(24).astype(np.float32)
    rewards[8:12] = 0.5  # a constant group: zero advantage, no NaN
    for g in (4, 8):
        want = jgrpo.group_advantages(rewards, g, 1e-4)
        got = grpo.group_advantages(rewards, g, 1e-4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.all(grpo.group_advantages(rewards, 4, 1e-4)[8:12] == 0)


class StubBatcher:
    """The engine surface rollout_wave calls (submit, run), emitting fixed
    tokens in submission order."""

    def __init__(self, emitted):
        self.emitted, self.samples = iter(emitted), []

    def submit(self, sample, max_new_tokens=None, temperature=None, top_p=None):
        self.samples.append((sample, max_new_tokens, temperature, top_p))
        return types.SimpleNamespace(emitted=next(self.emitted), error=None)

    def run(self):
        return iter(())


P, G = 2, 3  # prompts and completions a prompt of the parity wave


def _cells(mod):
    rng = np.random.default_rng(5)
    cells = []
    for i in range(P):
        img = rng.integers(0, 255, (60 + 8 * i, 50, 3), dtype=np.uint8)
        ids = [int(t) for t in rng.integers(2, VOCAB, 4 + i)] + [-200] + [7, 8, 9]
        cells.append(mod.GRPOCell(ids, [img], [[0.1, 0.1, 0.5, 0.5]],
                                  '{"bbox": [[0.1, 0.1, 0.5, 0.5]]}'))
    return cells


def _decode(ids):
    return "".join(chr(0x20 + i % 90) for i in ids)


@pytest.fixture(scope="module")
def wave(tiny):
    """One wave through a stub engine in both packages: rollouts, rewards,
    advantages and the update batch (asserted equal here)."""
    jcfg, tcfg, _ = tiny
    rng = np.random.default_rng(7)
    emitted = [[int(t) for t in rng.integers(2, VOCAB, n)] for n in (3, 6, 1, 5, 4, 2)]
    out = {}
    for name, mod, cfg in (("jax", jgrpo, jcfg), ("torch", grpo, tcfg)):
        stub = StubBatcher(emitted)
        gc = mod.GRPOConfig(group_size=G, max_new_tokens=8, temperature=0.7, top_p=0.9)
        rollouts, rewards = mod.rollout_wave(stub, _cells(mod), cfg, gc, _decode)
        batch = mod.rollouts_to_batch(rollouts, cfg, pad_len=128, pad_tiles=4)
        out[name] = (stub, rollouts, rewards, batch)
    (js, jr, jrew, jb), (ts, tr, trew, tb) = out["jax"], out["torch"]
    assert [(s[1:], s[0].length) for s in js.samples] == \
        [(s[1:], s[0].length) for s in ts.samples]
    for (a, _, _, _), (b, _, _, _) in zip(js.samples, ts.samples):
        assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.tiles, b.tiles)
    assert [(r["ids"], r["emitted"], r["text"]) for r in jr] == \
        [(r["ids"], r["emitted"], r["text"]) for r in tr]
    np.testing.assert_array_equal(trew, jrew)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert np.array_equal(jb[k], tb[k]), k
    adv = np.asarray([1.5, -0.5, 0.25, -1.0, 0.75, 0.0], np.float32)
    return tb, adv


def _torch_model(tcfg, params):
    return convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("policy", ["on", "off"])
def test_grpo_loss_matches_jax(tiny, wave, policy):
    """`grpo_loss` and its metrics equal the JAX package's (1e-5) on-policy
    (ratio 1) and off-policy (stale old_logp: some ratios clip), with a
    reference that differs from the policy."""
    jcfg, tcfg, params = tiny
    batch, adv = wave
    noise = np.random.default_rng(3)
    ref = jax.tree.map(lambda x: (x + 0.01 * noise.normal(size=x.shape)).astype(x.dtype), params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    old = None
    if policy == "off":
        logits, _ = jrad.forward(params, jcfg, jb, remat=False, attn_impl="xla")
        tok, _ = jgrpo.token_logprobs(logits, jb["labels"], jb["segment_ids"])
        old = np.asarray(tok) + noise.normal(scale=0.3, size=tok.shape).astype(np.float32)
    gkw = dict(clip_eps=0.2, kl_beta=0.3)
    jl, jm = jgrpo.grpo_loss(params, ref, jcfg, jgrpo.GRPOConfig(**gkw), jb, jnp.asarray(adv),
                             None if old is None else jnp.asarray(old), remat=False,
                             attn_impl="xla")
    tl, tm = grpo.grpo_loss(_torch_model(tcfg, params), _torch_model(tcfg, ref), tcfg,
                            grpo.GRPOConfig(**gkw), batch_to_device(batch, "cpu"),
                            torch.as_tensor(adv), None if old is None else torch.as_tensor(old))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(jm["kl"]) > 0
    assert (float(jm["clip_frac"]) > 0) == (policy == "off")


GRPO_TRAIN = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=8, grad_accum_steps=1,
                  max_grad_norm=0.5, mm_tunable_parts="mm_mlp_adapter,mm_language_model",
                  adam_eps=1e-5)


def test_mu2_updates_match_jax(tiny, wave):
    """A mu = 2 wave: the score function's old_logp, then two
    `make_grpo_step` updates against it; each update's metrics (1e-5) and
    the parameters after (rtol 1e-5, atol 2e-5, the SFT steps' tolerance)
    equal the JAX package's; the first update is on the reference (KL 0) at
    ratio 1 (no clipping), the second is not."""
    jcfg, tcfg, params = tiny
    batch, adv = wave
    gkw = dict(kl_beta=0.1, mu=2)
    # JAX
    tx, _ = jopt.make_optimizer(params, jopt.TrainConfig(**GRPO_TRAIN))
    jparams = jax.tree.map(jnp.asarray, params)
    ref = jax.tree.map(jnp.copy, jparams)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                            opt_state=tx.init(jparams))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jold = jgrpo.make_score_fn(jcfg, remat=False, attn_impl="xla")(jstate.params, jb)
    jstep = jgrpo.make_grpo_step(jcfg, jgrpo.GRPOConfig(**gkw), tx, remat=False, attn_impl="xla")
    jmetrics = []
    for _ in range(2):
        jstate, m = jstep(jstate, ref, jb, jnp.asarray(adv), jold)
        jmetrics.append({k: float(v) for k, v in m.items()})
    # the port
    model = _torch_model(tcfg, params)
    opt = topt.make_optimizer(model, topt.TrainConfig(**GRPO_TRAIN))
    state = tts.TrainState(step=0, params=model, opt_state=opt)
    tref = grpo.frozen_copy(model)
    tb = batch_to_device(batch, "cpu")
    told = grpo.make_score_fn(tcfg)(model, tb)
    assert not told.requires_grad
    sup = batch["labels"][:, 1:] != -100
    np.testing.assert_allclose(told.numpy()[sup], np.asarray(jold)[sup], rtol=1e-5, atol=1e-5)
    step_fn = grpo.make_grpo_step(tcfg, grpo.GRPOConfig(**gkw), opt)
    for jm in jmetrics:
        state, m = step_fn(state, tref, tb, torch.as_tensor(adv), told)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert jmetrics[0]["kl"] < 1e-10 and jmetrics[0]["clip_frac"] == 0
    assert jmetrics[1]["kl"] > 0
    got, want, start = (_leaves(convert.radvlm_to_tree(model)), _leaves(jstate.params),
                        _leaves(params))
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(got[k], start[k]))
    assert moved > 0 and state.step == 2


class ByteTok:
    eos_token_ids, pad_token_id = (1,), 0

    @staticmethod
    def encode(text):
        return [2 + b for b in text.encode()][:24]

    @staticmethod
    def decode(ids):
        return bytes(min(255, max(0, i - 2)) for i in ids if i >= 2).decode(errors="ignore")


def _write_rec(root, n=3):
    from PIL import Image

    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        lines.append(json.dumps({"id": i, "image": name, "problem": "<image>find the left lung",
                                 "solution": '{"bbox": [[0.1, 0.2, 0.5, 0.6]]}'}))
    path = os.path.join(root, "rec.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _run(tcfg, data, root, **kw):
    return tloop.RunConfig(
        model=tcfg, train=topt.TrainConfig(learning_rate=1e-3, warmup_ratio=0.0,
                                           grad_accum_steps=1, total_steps=4,
                                           lr_schedule="constant",
                                           mm_tunable_parts="mm_language_model"),
        data_path=data, image_root=root, log_every=1, device="cpu", **kw)


def _same_as_fresh_copy(engine_model, policy, cfg):
    """Every parameter of the engine's copy equals a fresh `rollout_model`
    of the policy, whose fused weights are `fuse_linears`' cat of the parts."""
    fresh = dict(grpo.rollout_model(policy, cfg).named_parameters())
    got = dict(engine_model.named_parameters())
    assert got.keys() == fresh.keys() and any(".qkv." in n for n in got)
    return all(torch.equal(got[n], fresh[n]) for n in got)


def test_train_grpo_end_to_end(tiny, tmp_path, monkeypatch):
    """`train_grpo` on a GRPO-REC jsonl on the CPU: rollouts sampled through
    the continuous engine over its own copy, finite metrics each wave, the
    first update on the reference (KL 0, no clipping), the engine's copy
    equal to the policy after every sync (and stale without the sync), and
    a checkpoint; a mu = 2 run takes two updates a wave."""
    jcfg, tcfg, params = tiny
    # A reward that differs between random completions (one per group would
    # give zero advantages and no update).
    monkeypatch.setitem(grpo.REWARD_FNS, "bytes", lambda text, cell, gc: float(
        sum(text.encode()) % 7))
    data = _write_rec(str(tmp_path))
    policy = _torch_model(tcfg, params)
    engines = []

    class RecordingBatcher(ContinuousBatcher):  # the engine train_grpo builds
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            engines.append(self)

    monkeypatch.setattr(grpo, "ContinuousBatcher", RecordingBatcher)
    start = {n: p.clone() for n, p in grpo.rollout_model(policy, tcfg).named_parameters()}
    seen = []

    def on_wave(step, m):
        seen.append((step, m))
        assert _same_as_fresh_copy(engines[0].model, policy, tcfg)

    gc = grpo.GRPOConfig(group_size=4, prompts_per_wave=2, max_new_tokens=4, reward="bytes")
    out = str(tmp_path / "ckpt")
    state = grpo.train_grpo(_run(tcfg, data, str(tmp_path), max_steps=2, checkpoint_dir=out,
                                 save_steps=1),
                            ByteTok.encode, ByteTok.decode, QWEN_CHATML, grpo_cfg=gc,
                            init_params=policy, metrics_callback=on_wave, num_slots=4,
                            rollout_max_len=256, prompt_buckets=(128,), pad_tiles=2,
                            eos_token_ids=(1,))
    (engine,) = engines
    assert (engine.num_slots, engine.max_len, engine.prompt_buckets, engine.pad_tiles,
            engine.gen.eos_token_ids) == (4, 256, [128], 2, (1,))
    assert state.step == 2 and [s for s, _ in seen] == [1, 2]
    for _, m in seen:
        assert all(np.isfinite(v) for v in m.values())
        assert m["first_clip_frac"] == 0.0 and m["completion_tokens"] > 0
    assert seen[0][1]["first_kl"] < 1e-10 and seen[1][1]["first_kl"] > 0
    assert any(not torch.equal(p, start[n]) for n, p in engine.model.named_parameters())
    assert tloop.ckpt_lib.CheckpointManager(out).latest_step() == 2
    # mu = 2: one wave of two updates.
    state = grpo.train_grpo(_run(tcfg, data, str(tmp_path), max_steps=2), ByteTok.encode,
                            ByteTok.decode, QWEN_CHATML,
                            grpo_cfg=grpo.GRPOConfig(group_size=2, prompts_per_wave=1,
                                                     max_new_tokens=3, reward="bytes", mu=2),
                            init_params=_torch_model(tcfg, params), num_slots=2,
                            rollout_max_len=256, prompt_buckets=(128,), pad_tiles=2,
                            metrics_callback=lambda s, m: seen.append((s, m)))
    assert state.step == 2 and seen[-1][0] == 2 and seen[-1][1]["first_clip_frac"] == 0


def test_grpo_cli_runs_on_cpu(tmp_path, capsys):
    data = _write_rec(str(tmp_path), n=2)
    state = grpo_cli.main(["--model-size", "tiny", "--data-path", data, "--image-folder",
                           str(tmp_path), "--output-dir", str(tmp_path / "out"), "--device",
                           "cpu", "--group-size", "2", "--prompts-per-wave", "2",
                           "--max-new-tokens", "3", "--num-slots", "4", "--rollout-max-len",
                           "256", "--prompt-bucket", "128", "--pad-tiles", "2", "--max-steps",
                           "1", "--warmup-ratio", "0"], tokenizer=ByteTok())
    assert state.step == 1 and "grpo finished at step 1" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--mesh-tensor", "2"], ["--mesh-fsdp", "4"], ["--multihost"]])
def test_grpo_cli_mesh_and_multihost_raise(tmp_path, argv):
    """In one process a mesh of more than one rank, or `--multihost`
    outside torchrun, raises naming torchrun (the GRPO run over two ranks
    is tests/test_torch_mesh_train.py's)."""
    data = _write_rec(str(tmp_path), n=1)
    with pytest.raises(ValueError, match="torchrun"):
        grpo_cli.main(["--model-size", "tiny", "--data-path", data, "--image-folder",
                       str(tmp_path), "--device", "cpu", "--output-dir", str(tmp_path / "o")]
                      + argv, tokenizer=ByteTok())
