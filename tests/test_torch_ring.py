"""Ring attention (`parallel/ring.py`) on spawned gloo ranks against the
JAX package's `ring_attention` (the contiguous schedule, shard_map over a
virtual CPU mesh) and `mha_reference`, at 2 and 4 ranks: MHA and GQA with a
padding tail that crosses the blocks, packed segments, and the K2-lse route
(its plain version on the CPU). f32, within 2e-5 on the non-padding rows
(a padding row attends nothing: the ring gives 0, `mha_reference` the mean
of v). The online-softmax merge of two chunks' (out, lse) equals attention
over both, and the JAX `_merge`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist
from radvlm_tpu.ops.attention import make_attention_mask, mha_reference
from radvlm_tpu.parallel import ring as jring
from radvlm_tpu_torch.ops.flash_attention import attention_plain
from radvlm_tpu_torch.parallel import ring

TOL = 2e-5


def _cases(world):
    rng = np.random.default_rng(world)
    out = []
    for gqa, impl in ((1, "xla"), (2, "xla"), (2, "flash")):
        b, s, h, d = 2, world * 32, 4, 16
        seg = np.ones((b, s), np.int32)
        seg[0, s - 37:] = 0  # a padding tail that crosses blocks
        out.append(dict(q=rng.normal(size=(b, s, h, d)).astype(np.float32),
                        k=rng.normal(size=(b, s, h // gqa, d)).astype(np.float32),
                        v=rng.normal(size=(b, s, h // gqa, d)).astype(np.float32),
                        seg=seg, impl=impl))
    s = world * 16
    seg = np.zeros((1, s), np.int32)
    seg[0, :s // 2 - 3] = 1
    seg[0, s // 2 - 3:s - 5] = 2  # a second packed segment spanning blocks
    out.append(dict(q=rng.normal(size=(1, s, 2, 8)).astype(np.float32),
                    k=rng.normal(size=(1, s, 2, 8)).astype(np.float32),
                    v=rng.normal(size=(1, s, 2, 8)).astype(np.float32), seg=seg))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    cases = _cases(n)
    ranks = torch_dist.run(torch_dist.ring_cases, n, cases, tmp_path_factory.mktemp(f"ring{n}"))
    return n, cases, ranks


def test_ring_matches_jax_ring_and_reference(world):
    n, cases, ranks = world
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    jfn = jring.make_ring_attention(mesh, axis_name="seq", impl="xla")
    for i, c in enumerate(cases):
        got = np.concatenate([r[i] for r in ranks], axis=1)
        q, k, v, seg = (jnp.asarray(c[x]) for x in ("q", "k", "v", "seg"))
        want = np.asarray(jfn(q, k, v, seg, seg))
        ref = np.asarray(mha_reference(q, k, v, mask=make_attention_mask(seg, seg, True)))
        valid = c["seg"][:, :, None, None] != 0
        np.testing.assert_allclose(got * valid, want * valid, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got * valid, ref * valid, atol=TOL, rtol=TOL)
        assert np.all(got[~np.broadcast_to(valid, got.shape)] == 0)


def test_merge_identity():
    """Two key chunks' (out, lse) merged equal attention over all keys, and
    the port's merge equals the JAX one step for step."""
    rng = np.random.default_rng(0)
    b, s, h, d = 1, 24, 2, 8
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
               for _ in range(3))
    full = attention_plain(q, k, v, None, None, False, d ** -0.5)
    o = torch.zeros((b, s, h, d))
    m = torch.full((b, h, s), float("-inf"))
    l = torch.zeros((b, h, s))
    jo, jm, jl = jnp.zeros((b, s, h, d)), jnp.full((b, h, s), -jnp.inf), jnp.zeros((b, h, s))
    for part in (slice(0, 10), slice(10, 24)):
        o_t, lse_t = attention_plain(q, k[:, part], v[:, part], None, None, False, d ** -0.5,
                                     with_lse=True)
        o, m, l = ring._merge(o, m, l, o_t, lse_t)
        jo, jm, jl = jring._merge(jo, jm, jl, jnp.asarray(o_t.numpy()), jnp.asarray(lse_t.numpy()))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-6, rtol=1e-6)
    merged = o / l.transpose(1, 2)[..., None]
    np.testing.assert_allclose(merged.numpy(), full.numpy(), atol=1e-6, rtol=1e-5)


def test_ring_route_and_refusals():
    """mha(impl="ring") needs a registered group, refuses a gradient (the
    backward is training work) and the zigzag schedule."""
    from radvlm_tpu_torch.ops import attention as tatt

    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(RuntimeError, match="enable_ring_attention"):
        tatt.mha(q, q, q, causal=True, impl="ring")
    with pytest.raises(NotImplementedError, match="M12"):
        tatt.mha(q.clone().requires_grad_(True), q, q, causal=True, impl="ring")
    with pytest.raises(NotImplementedError, match="zigzag"):
        ring.enable_ring_attention(object(), schedule="zigzag")
