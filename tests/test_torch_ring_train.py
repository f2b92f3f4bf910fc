"""Ring attention's training half (`parallel/ring.py`) on spawned gloo
ranks against the JAX package: the zigzag schedule's forward against JAX
`_ring_attention_zigzag` (shard_map over the virtual CPU mesh) and full
attention, its gradients (through the differentiable `_Rotate`, `_merge`
and each pair's lse) against `jax.grad` of the JAX ring, the contiguous
schedule's gradients too, at 2 and 4 ranks with packed segments and a
padding row; and the zigzag layout helpers equal JAX's exactly (the
`{fsdp: 2, seq: 2}` SFT step is `test_torch_sharding.py`'s). f32: forward
2e-5, gradients 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist
from radvlm_tpu.ops.attention import make_attention_mask, mha_reference
from radvlm_tpu.parallel import ring as jring
from radvlm_tpu_torch.parallel import ring

FWD, GRAD = 2e-5, 3e-5


def _cases(world):
    rng = np.random.default_rng(10 + world)
    out = []
    for schedule, impl, gqa in (("zigzag", "xla", 1), ("zigzag", "flash", 2),
                                ("contiguous", "flash", 2)):
        b, s, h, d = 2, world * 16, 4, 8
        seg = np.ones((b, s), np.int32)
        seg[0, : s // 2 - 3] = 1
        seg[0, s // 2 - 3: s - 5] = 2  # two packed segments that cross blocks
        seg[0, s - 5:] = 0
        seg[1] = 0  # a padding row: nothing to attend anywhere
        out.append(dict(
            q=rng.normal(size=(b, s, h, d)).astype(np.float32),
            k=rng.normal(size=(b, s, h // gqa, d)).astype(np.float32),
            v=rng.normal(size=(b, s, h // gqa, d)).astype(np.float32),
            do=rng.normal(size=(b, s, h, d)).astype(np.float32),
            seg=seg, schedule=schedule, impl=impl))
    for c in out:  # the inputs enter in the schedule's layout
        if c["schedule"] == "zigzag":
            perm = jring.zigzag_indices(c["q"].shape[1], world)
            for n in ("q", "k", "v", "do", "seg"):
                c[n] = np.ascontiguousarray(c[n][:, perm])
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    cases = _cases(n)
    ranks = torch_dist.run(torch_dist.ring_grads, n, cases, tmp_path_factory.mktemp(f"rg{n}"))
    got = [tuple(np.concatenate([r[i][j] for r in ranks], axis=1) for j in range(4))
           for i in range(len(cases))]
    return n, cases, got


def _jax_ring(n, case):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    fn = jring.make_ring_attention(mesh, axis_name="seq", impl="xla", schedule=case["schedule"])

    def loss(q, k, v, seg, do):
        o = fn(q, k, v, seg, seg)
        return jnp.sum(o * do), o

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    (_, o), grads = step(*(jnp.asarray(case[x]) for x in ("q", "k", "v", "seg", "do")))
    return np.asarray(o), [np.asarray(g) for g in grads]


def test_ring_forward_and_grads_match_jax(world):
    """Every case's output and q / k / v gradients, gathered over the
    ranks, equal the JAX ring's (padding rows included: both give 0 there)
    and no gradient is NaN."""
    n, cases, got = world
    for c, (o, dq, dk, dv) in zip(cases, got):
        jo, jgrads = _jax_ring(n, c)
        np.testing.assert_allclose(o, jo, atol=FWD, rtol=FWD, err_msg=c["schedule"])
        for name, g, jg in zip("qkv", (dq, dk, dv), jgrads):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, jg, atol=GRAD, rtol=GRAD,
                                       err_msg=f"{c['schedule']} d{name}")
        assert not dq[1].any() and not dk[1].any()  # the padding row takes no gradient


def test_zigzag_equals_full_attention(world):
    """Put back in order, the zigzag ring's output is full causal attention
    (JAX `mha_reference`) on the rows that attend something."""
    n, cases, got = world
    for c, (o, *_) in zip(cases, got):
        if c["schedule"] != "zigzag":
            continue
        inv = jring.inverse_zigzag_indices(c["q"].shape[1], n)
        q, k, v, seg = (c[x][:, inv] for x in ("q", "k", "v", "seg"))
        hq, hkv = q.shape[2], k.shape[2]
        k, v = (np.repeat(t, hq // hkv, axis=2) for t in (k, v))
        mask = make_attention_mask(jnp.asarray(seg), jnp.asarray(seg), True)
        want = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        mask=mask))
        real = (seg != 0)[..., None, None]
        np.testing.assert_allclose(np.where(real, o[:, inv], 0), np.where(real, want, 0),
                                   atol=FWD, rtol=FWD)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zigzag_helpers_equal_jax(n):
    """`zigzag_indices`, its inverse and `zigzag_shift_batch` equal the JAX
    package's exactly; an odd chunk count raises as there."""
    s = 32
    np.testing.assert_array_equal(ring.zigzag_indices(s, n), jring.zigzag_indices(s, n))
    np.testing.assert_array_equal(ring.inverse_zigzag_indices(s, n),
                                  jring.inverse_zigzag_indices(s, n))
    rng = np.random.default_rng(n)
    seg = np.ones((2, s), np.int32)
    seg[1, 20:] = 0
    batch = {"tokens": rng.integers(0, 99, (2, s)).astype(np.int32),
             "img_src": rng.integers(-1, 3, (2, s)).astype(np.int32),
             "positions": np.tile(np.arange(s, dtype=np.int32), (2, 1)),
             "segment_ids": seg, "labels": rng.integers(-100, 99, (2, s)).astype(np.int32),
             "tiles": rng.integers(0, 255, (2, 1, 4, 4, 3)).astype(np.uint8)}
    got, want = ring.zigzag_shift_batch(batch, n), jring.zigzag_shift_batch(batch, n)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="not divisible"):
        ring.zigzag_indices(30, 4)
