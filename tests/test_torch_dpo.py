"""The port's DPO (`radvlm_tpu_torch/training/dpo.py`) and its per-token
log-probabilities (`models/radvlm.py::token_logprobs`) against the JAX
package at the tiny config: the same weights (moved through
`convert.radvlm_from_jax`) and the same numpy batches through both, f32 on
the CPU; the JAX side runs attn_impl="xla", the port its plain attention.
Then the driver and the CLI end to end on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.training import dpo as jdpo
from radvlm_tpu.training import grpo as jgrpo
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from radvlm_tpu_torch.config import IGNORE_INDEX, tiny_test_config
from radvlm_tpu_torch.data.loader import Bucket
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.models import convert, radvlm
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.training import checkpoint as ckpt
from radvlm_tpu_torch.training import dpo, dpo_cli
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


def _noisy(params, seed, scale, every=False):
    noise = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + scale * noise.normal(size=x.shape)).astype(x.dtype)
        if every or any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
                        for k in p) else x,
        params,
    )


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=VOCAB)
    init = jax.jit(jrad.init_params, static_argnums=0)
    params = _noisy(jax.tree.map(np.asarray, init(cfg, jax.random.key(0))), 1, 0.05)
    return cfg, tiny_test_config(vocab_size=VOCAB), params


def _sample(mod, cfg, seed, n_prompt, reply):
    r = np.random.default_rng(seed)
    img = r.integers(0, 255, (70, 90, 3), dtype=np.uint8)
    ids = [int(t) for t in r.integers(2, VOCAB, n_prompt)] + [-200] + list(reply)
    labels = [IGNORE_INDEX] * (n_prompt + 1) + list(reply)
    return mod.build_sample(ids, [img], cfg, labels=labels)


def _pair(jcfg, tcfg, seed):
    """(chosen, rejected) numpy batches of 2 rows, built by both packages'
    host code (asserted equal): one prompt each, two replies."""
    out = []
    for mod, cfg in ((jmm, jcfg), (tmm, tcfg)):
        sides = []
        for shift in (0, 1):
            rows = [_sample(mod, cfg, seed + i, 4 + 3 * i,
                            [int(t) for t in np.random.default_rng(10 * seed + i + 50 * shift)
                             .integers(2, VOCAB, 5 + 2 * i + shift)]) for i in range(2)]
            sides.append(mod.collate(rows, pad_len=128, pad_to_multiple=128))
        out.append(sides)
    for side_j, side_t in zip(*out):
        for k in side_j:
            assert np.array_equal(side_j[k], side_t[k]), k
    return out[0]


def _model(tcfg, params, parts=None):
    model = convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    if parts:
        topt.mark_trainable(model, topt.TrainConfig(mm_tunable_parts=parts))
    return model


@pytest.mark.parametrize("chunk", [1024, 37])
def test_token_logprobs_match_jax(tiny, chunk):
    """`token_logprobs` equals the JAX package's `grpo.token_logprobs` over
    `radvlm.forward`'s logits (1e-5) at the supervised positions, the masks
    equal; `sequence_logprob` equals the JAX one; a chunk smaller than the
    sequence gives the unchunked values and gradients."""
    jcfg, tcfg, params = tiny
    chosen, _ = _pair(jcfg, tcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in chosen.items()}
    logits, _ = jrad.forward(params, jcfg, jb, remat=False, attn_impl="xla")
    jtok, jmask = jgrpo.token_logprobs(logits, jb["labels"], jb["segment_ids"])
    jseq = jdpo.sequence_logprob(params, jcfg, jb, remat=False, attn_impl="xla")
    model = _model(tcfg, params, "mm_mlp_adapter,mm_language_model")
    batch = batch_to_device(chosen, "cpu")
    ttok, tmask = radvlm.token_logprobs(model, tcfg, batch, chunk=chunk)
    assert ttok.shape == tmask.shape == (2, chosen["tokens"].shape[1] - 1)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    m = np.asarray(jmask) > 0
    np.testing.assert_allclose(ttok.detach().numpy()[m], np.asarray(jtok)[m], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dpo.sequence_logprob(model, tcfg, batch, chunk=chunk).detach().numpy(), np.asarray(jseq),
        rtol=1e-5)
    # The chunked form against the unchunked one: values and gradients.
    grads = []
    for c in (chunk, 4096):
        tok, mask = radvlm.token_logprobs(model, tcfg, batch, chunk=c)
        (tok * mask).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
        model.zero_grad(set_to_none=True)
        if c == chunk:
            first = tok.detach()
    np.testing.assert_allclose(first.numpy(), tok.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n in grads[0]:
        np.testing.assert_allclose(grads[0][n].numpy(), grads[1][n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_dpo_loss_matches_jax(tiny, ls):
    """`dpo_loss` and its five metrics equal the JAX package's (1e-5) with a
    reference that differs from the policy."""
    jcfg, tcfg, params = tiny
    ref = _noisy(params, 2, 0.01, every=True)
    chosen, rejected = _pair(jcfg, tcfg, 1)
    cfg = jdpo.DPOConfig(beta=0.5, label_smoothing=ls)
    jl, jm = jdpo.dpo_loss(params, ref, jcfg, cfg, *({k: jnp.asarray(v) for k, v in b.items()}
                                                      for b in (chosen, rejected)),
                           remat=False, attn_impl="xla")
    tl, tm = dpo.dpo_loss(_model(tcfg, params), _model(tcfg, ref), tcfg,
                          dpo.DPOConfig(beta=0.5, label_smoothing=ls),
                          batch_to_device(chosen, "cpu"), batch_to_device(rejected, "cpu"))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert abs(float(jm["reward_margin"])) > 1e-3  # the reference really differs


DPO_STEPS = 3
DPO_TRAIN = dict(learning_rate=1e-3, projector_lr=2e-3, warmup_ratio=0.0, total_steps=8,
                 grad_accum_steps=1, max_grad_norm=0.5,
                 mm_tunable_parts="mm_mlp_adapter,mm_language_model", adam_eps=1e-5)


@pytest.fixture(scope="module")
def jax_dpo_run(tiny):
    """The JAX package's DPO steps over DPO_STEPS pairs (one compile)."""
    jcfg, tcfg, params = tiny
    pairs = [_pair(jcfg, tcfg, 10 + i) for i in range(DPO_STEPS)]
    tx, _ = jopt.make_optimizer(params, jopt.TrainConfig(**DPO_TRAIN))
    jparams = jax.tree.map(jnp.asarray, params)
    ref = jax.tree.map(jnp.copy, jparams)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams))
    step = jdpo.make_dpo_step(jcfg, jdpo.DPOConfig(beta=0.1), tx, remat=False, attn_impl="xla")
    metrics = []
    for c, r in pairs:
        state, m = step(state, ref, {k: jnp.asarray(v) for k, v in c.items()},
                        {k: jnp.asarray(v) for k, v in r.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return pairs, metrics, _leaves(jax.device_get(state.params))


def test_dpo_steps_match_jax(tiny, jax_dpo_run):
    """DPO_STEPS `make_dpo_step` updates: each step's loss and metrics (1e-5)
    and the parameters after (rtol 1e-5, atol 2e-5, as the SFT steps' test:
    Adam turns the rounding noise of zero-gradient leaves into updates up to
    lr x noise / adam_eps) equal the JAX package's; the first loss is ln 2
    (policy = reference); the reference does not move; frozen leaves do
    not move."""
    jcfg, tcfg, params = tiny
    pairs, jmetrics, jparams = jax_dpo_run
    model = convert.radvlm_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    opt = topt.make_optimizer(model, topt.TrainConfig(**DPO_TRAIN))
    state = tts.TrainState(step=0, params=model, opt_state=opt)
    ref = dpo.frozen_copy(model)
    step_fn = dpo.make_dpo_step(tcfg, dpo.DPOConfig(beta=0.1), opt, remat=True)
    for (c, r), jm in zip(pairs, jmetrics):
        state, m = step_fn(state, ref, batch_to_device(c, "cpu"), batch_to_device(r, "cpu"))
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(jmetrics[0]["loss"], np.log(2.0), rtol=1e-6)
    assert state.step == DPO_STEPS and opt.count == DPO_STEPS
    got = _leaves(convert.radvlm_to_tree(model))
    start = _leaves(params)
    moved = 0
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=1e-5, atol=2e-5, err_msg=k)
        moved += int(not np.array_equal(got[k], start[k]))
        if k.startswith("['vision_tower']"):
            assert np.array_equal(got[k], start[k]), k
    assert moved > 0
    for k, v in _leaves(convert.radvlm_to_tree(ref)).items():
        assert np.array_equal(v, start[k]), k


def _write_prefs(root, n, *, missing=()):
    from PIL import Image

    rng = np.random.default_rng(0)
    cells = []
    for i in range(n):
        name = f"img{i}.png"
        if i not in missing:
            Image.fromarray(rng.integers(0, 255, (60 + 4 * i, 56, 3), dtype=np.uint8)).save(
                os.path.join(root, name))
        cells.append({"image": name, "prompt": f"<image>\nDescribe scan {i}.",
                      "chosen": f"A precise report for study {i}.",
                      "rejected": f"Vague text {i}."})
    path = os.path.join(root, "prefs.json")
    with open(path, "w") as f:
        json.dump(cells, f)
    return path, cells


def _tok(s):
    return [2 + (b % 200) for b in s.encode()][:64]


def test_build_pair_batch_with_a_failing_pair(tiny, tmp_path):
    """A pair whose image is missing is skipped by both packages alike: the
    filler is the last good pair with every label erased, and the batches
    equal the JAX package's array for array, cut to the bucket."""
    from radvlm_tpu.data.loader import Bucket as JBucket

    jcfg, tcfg, _ = tiny
    _, cells = _write_prefs(str(tmp_path), 3, missing=(1,))
    kw = dict(cells=cells, image_root=str(tmp_path), tokenize_fn=_tok, max_len=256)
    jset = jdpo.DPOPairDataset(cfg=jcfg, **kw)
    tset = dpo.DPOPairDataset(cfg=tcfg, **kw)
    assert [jset.estimated_length(i) for i in range(3)] == \
        [tset.estimated_length(i) for i in range(3)]
    for n in (128, 512):  # cut to the bucket, and padded to it
        jb = jdpo._build_pair_batch(jset, [0, 1, 2], JBucket(n, 4))
        tb = dpo._build_pair_batch(tset, [0, 1, 2], Bucket(n, 4))
        for js, ts in zip(jb, tb):
            assert js.keys() == ts.keys()
            for k in js:
                assert np.array_equal(js[k], ts[k]), k
            assert ts["tokens"].shape[1] == n
    assert all((ts["labels"][2] == IGNORE_INDEX).all() and (ts["labels"][1] != IGNORE_INDEX).any()
               for ts in tb)
    with pytest.raises(RuntimeError, match="entire dpo batch"):
        dpo._build_pair_batch(tset, [1], Bucket(128, 4))


def _run(tcfg, data, root, **kw):
    return tloop.RunConfig(
        model=tcfg,
        train=topt.TrainConfig(total_steps=6, grad_accum_steps=1, warmup_ratio=0.0,
                               learning_rate=1e-3, lr_schedule="constant",
                               mm_tunable_parts="mm_language_model"),
        data_path=data, image_root=root, micro_batch_size=2, num_epochs=2, log_every=1,
        save_steps=2, buckets=(Bucket(512, 6),), device="cpu", **kw)


def test_train_dpo_end_to_end_with_resume(tiny, tmp_path):
    """`train_dpo` on a preference json on the CPU: finite metrics every
    step, ln 2 at the first (policy = reference), checkpoints with the data
    position, and a resume that continues the plan; the resumed run's
    reference is the starting model, not the restored policy."""
    _, tcfg, params = tiny
    data, _ = _write_prefs(str(tmp_path), 6)
    out = str(tmp_path / "ckpt")
    run = _run(tcfg, data, str(tmp_path), max_steps=2, checkpoint_dir=out)
    seen = {}
    state = dpo.train_dpo(run, _tok, init_params=_model(tcfg, params),
                          metrics_callback=lambda s, m: seen.setdefault(s, m))
    assert state.step == 2 and sorted(seen) == [1, 2]
    assert all(np.isfinite(v) for m in seen.values() for v in m.values())
    assert seen[1]["loss"] == pytest.approx(np.log(2.0), abs=1e-6)
    assert seen[2]["reward_margin"] != 0.0
    assert ckpt.CheckpointManager(out).latest_step() == 2
    with open(os.path.join(out, "data_state.json")) as f:
        assert json.load(f) == {"step": 2, "epoch": 0, "batch_in_epoch": 2}
    resumed = {}
    fresh = _model(tcfg, params)
    state2 = dpo.train_dpo(_run(tcfg, data, str(tmp_path), max_steps=4, checkpoint_dir=out),
                           _tok, init_params=fresh,
                           metrics_callback=lambda s, m: resumed.setdefault(s, m))
    assert state2.step == 4 and sorted(resumed) == [3, 4]
    assert state2.opt_state.count == 4
    # The restored policy is step 2's, its reference the starting model:
    # the first resumed step is off ln 2.
    assert abs(resumed[3]["loss"] - np.log(2.0)) > 1e-6
    with open(os.path.join(out, "data_state.json")) as f:
        assert json.load(f) == {"step": 4, "epoch": 1, "batch_in_epoch": 1}


class ByteTok:
    eos_token_ids, pad_token_id = (1,), 0
    encode = staticmethod(_tok)


def test_dpo_cli_runs_on_cpu(tmp_path, capsys):
    data, _ = _write_prefs(str(tmp_path), 4)
    state = dpo_cli.main(["--model-size", "tiny", "--data-path", data, "--image-folder",
                          str(tmp_path), "--output-dir", str(tmp_path / "out"), "--device", "cpu",
                          "--micro-batch-size", "2", "--max-steps", "2", "--log-every", "1",
                          "--learning-rate", "1e-4", "--warmup-ratio", "0"], tokenizer=ByteTok())
    assert state.step == 2 and "dpo finished at step 2" in capsys.readouterr().out
    assert ckpt.CheckpointManager(str(tmp_path / "out")).latest_step() == 2


@pytest.mark.parametrize("argv", [["--mesh-tensor", "2"], ["--mesh-data", "2"], ["--multihost"]])
def test_dpo_cli_mesh_and_multihost_raise(tmp_path, argv):
    data, _ = _write_prefs(str(tmp_path), 2)
    with pytest.raises(NotImplementedError, match="M12"):
        dpo_cli.main(["--model-size", "tiny", "--data-path", data, "--image-folder",
                      str(tmp_path), "--device", "cpu", "--output-dir", str(tmp_path / "o")]
                     + argv, tokenizer=ByteTok())
