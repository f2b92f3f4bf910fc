"""DPO and GRPO over a mesh, and the drivers' mesh flags, on spawned gloo
ranks: three DPO steps and a mu = 2 GRPO wave under `{fsdp: 2}` (each
rank holding half the pairs / rows, the policy and the frozen reference
sharded) against the JAX package's one-device steps (metrics 1e-5, the
parameters rtol 1e-5 / atol 2e-5, as `test_torch_dpo.py` and
`test_torch_grpo.py` hold the one-card steps); then the SFT CLI under
`--mesh-fsdp 2`, `--mesh-tensor 2` and `--mesh-seq 2` and the DPO and GRPO
CLIs under `--mesh-fsdp 2`, each rank writing its checkpoint file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
from radvlm_tpu.training import grpo as jgrpo
from radvlm_tpu.training import optimizer as jopt
from radvlm_tpu.training import train_step as jts
from test_torch_dpo import DPO_STEPS, DPO_TRAIN, _write_prefs, jax_dpo_run  # noqa: F401
from test_torch_grpo import GRPO_TRAIN, _write_rec, wave  # noqa: F401
from test_torch_sharding import _leaves, check_against, tiny  # noqa: F401
from test_torch_train import _write_llava_json


@pytest.fixture(scope="module")
def jax_grpo_run(tiny, wave):  # noqa: F811
    """The JAX package's mu = 2 GRPO updates on the parity wave."""
    jcfg, _, params = tiny
    batch, adv = wave
    tx, _ = jopt.make_optimizer(params, jopt.TrainConfig(**GRPO_TRAIN))
    jparams = jax.tree.map(jnp.asarray, params)
    ref = jax.tree.map(jnp.copy, jparams)
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    old = jgrpo.make_score_fn(jcfg, remat=False, attn_impl="xla")(state.params, jb)
    step = jgrpo.make_grpo_step(jcfg, jgrpo.GRPOConfig(kl_beta=0.1, mu=2), tx, remat=False,
                                attn_impl="xla")
    metrics = []
    for _ in range(2):
        state, m = step(state, ref, jb, jnp.asarray(adv), old)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _leaves(state.params)


@pytest.fixture(scope="module")
def mesh_runs(tiny, wave, jax_dpo_run, tmp_path_factory):  # noqa: F811
    _, tcfg, params = tiny
    pairs, _, _ = jax_dpo_run
    batch, adv = wave
    payload = dict(cfg=tcfg, params=params, shape={"fsdp": 2},
                   dpo=dict(train=DPO_TRAIN, pairs=pairs),
                   grpo=dict(train=GRPO_TRAIN, batch=batch, adv=adv,
                             gc=dict(kl_beta=0.1, mu=2)))
    return torch_dist.run(torch_dist.mesh_preference, 2, payload,
                          tmp_path_factory.mktemp("pref"))


@pytest.mark.parametrize("name", ["dpo", "grpo"])
def test_preference_updates_under_fsdp_match_jax(tiny, mesh_runs, jax_dpo_run, jax_grpo_run,  # noqa: F811
                                                 name):
    """Each update's metrics (global over the ranks' halves) and the
    parameters after equal the JAX one-device run's."""
    _, _, params = tiny
    if name == "dpo":
        _, jmetrics, jparams = jax_dpo_run
        assert len(jmetrics) == DPO_STEPS
    else:
        jmetrics, jparams = jax_grpo_run
    for rank in mesh_runs:
        metrics, tree = rank[name]
        for m, jm in zip(metrics, jmetrics):
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
        check_against(_leaves(tree), jparams, _leaves(params))


def test_clis_run_over_the_mesh(tmp_path):
    """The SFT CLI under `--mesh-fsdp 2`, `--mesh-tensor 2` and `--mesh-seq
    2` (ring attention, zigzag), the DPO and GRPO CLIs under `--mesh-fsdp
    2`, on two ranks: each run reaches its step and every rank wrote its
    own checkpoint file."""
    root = str(tmp_path)
    sft = _write_llava_json(root, n=4)
    prefs, _ = _write_prefs(root, 4)
    rec = _write_rec(root, n=2)
    common = ["--model-size", "tiny", "--image-folder", root, "--device", "cpu", "--log-every",
              "1", "--warmup-ratio", "0"]
    sft_argv = common + ["--data-path", sft, "--micro-batch-size", "2", "--pack-factor", "2",
                         "--buckets", "256:4", "--grad-accum-steps", "1", "--save-steps", "2",
                         "--num-epochs", "3"]
    runs = []
    for flag, steps in (("--mesh-fsdp", 2), ("--mesh-tensor", 1), ("--mesh-seq", 1)):
        out = os.path.join(root, flag.strip("-"))
        runs.append(("radvlm_tpu_torch.training.cli", sft_argv + [
            flag, "2", "--mesh-fsdp", "2" if flag == "--mesh-fsdp" else "1",
            "--max-steps", str(steps), "--output-dir", out], out))
    out = os.path.join(root, "dpo")
    runs.append(("radvlm_tpu_torch.training.dpo_cli", common + [
        "--data-path", prefs, "--mesh-fsdp", "2", "--micro-batch-size", "2", "--max-steps", "1",
        "--output-dir", out], out))
    out = os.path.join(root, "grpo")
    runs.append(("radvlm_tpu_torch.training.grpo_cli", common + [
        "--data-path", rec, "--mesh-fsdp", "2", "--group-size", "2", "--prompts-per-wave", "2",
        "--max-new-tokens", "3", "--num-slots", "4", "--rollout-max-len", "256",
        "--prompt-bucket", "128", "--pad-tiles", "2", "--max-steps", "1", "--output-dir", out],
        out))
    ranks = torch_dist.run(torch_dist.mesh_clis, 2, dict(runs=runs), tmp_path / "ranks")
    want_steps = [2, 1, 1, 1, 1]
    for rank in ranks:
        for (step, dirs, files), want in zip(rank, want_steps):
            assert step == want and dirs == [f"step_{want}"]
            assert files == ["meta.json", "state.rank0.safetensors", "state.rank1.safetensors"]
    with open(os.path.join(root, "mesh-fsdp", "data_state.json")) as f:
        assert '"step": 2' in f.read()
