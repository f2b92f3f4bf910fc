"""qgZ (`parallel/compression.py`) against the JAX package: the blockwise
int8 quantization bit for bit (payloads and scales, round half to even),
and `quantized_psum` / `quantized_pmean` over 2 and 4 spawned gloo ranks
against the JAX `quantized_psum` under shard_map on the virtual CPU mesh
and against the exact sum (within 1.6e-2 of the largest magnitude, the two
int8 stages' bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist
from radvlm_tpu.parallel import compression as jcomp
from radvlm_tpu_torch.parallel import compression as tcomp


def _data(world, seed=0):
    """Per rank a row of 200 values (padded to whole blocks inside), one
    with ties at half steps, and an all-zero block."""
    rng = np.random.default_rng(seed + world)
    x = rng.normal(size=(world, 200)).astype(np.float32) * np.float32(3.0)
    x[0, :64] = np.float32(127.0) * np.arange(-32, 32, dtype=np.float32) / np.float32(64.0)
    x[-1, 64:128] = 0.0
    return [x, (x * np.float32(1e-3)).reshape(world, 10, 20)]


def test_quantize_blocks_bit_for_bit():
    """int8 payloads and f32 scales equal the JAX package's exactly, half
    steps rounded to even, and the dequantized blocks too."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    x[1, :64] = np.arange(-32, 32, dtype=np.float32) * np.float32(0.5)  # max 16: 127/32 steps
    x[2, 64:128] = 0.0
    q, s = tcomp._quantize_blocks(torch.from_numpy(x), 64)
    jq, js = jcomp._quantize_blocks(jnp.asarray(x), 64)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp._dequantize_blocks(q, s, 64).numpy(),
                                  np.asarray(jcomp._dequantize_blocks(jq, js, 64)))


@pytest.mark.parametrize("world", [2, 4])
def test_quantized_psum_matches_jax_and_the_exact_sum(world, tmp_path):
    cases = _data(world)
    ranks = torch_dist.run(torch_dist.qgz, world, cases, tmp_path)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("r",))
    for i, x in enumerate(cases):
        fn = jax.jit(jax.shard_map(lambda v: jcomp.quantized_psum(v[0], "r", block=64)[None],
                                   mesh=mesh, in_specs=P("r"), out_specs=P("r")))
        want = np.asarray(fn(jnp.asarray(x)))
        exact = x.sum(0)
        bound = 1.6e-2 * np.abs(exact).max()
        for r, outs in enumerate(ranks):
            psum, pmean = outs[i]
            assert psum.dtype == x.dtype and psum.shape == x.shape[1:]
            np.testing.assert_array_equal(psum, ranks[0][i][0])  # every rank alike
            np.testing.assert_allclose(psum, want[r], rtol=1e-6, atol=1e-6 * np.abs(exact).max())
            assert np.abs(psum - exact).max() <= bound
            np.testing.assert_allclose(pmean, psum / world, rtol=1e-6)
