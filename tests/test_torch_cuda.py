"""The port's hand-written CUDA kernels (K1, K2, K9) against their plain
PyTorch versions on the card, at shapes beyond the main path's: other head
dims and GQA ratios, ragged sequence tails, Sq < Sk, rows with nothing to
attend.

Needs a CUDA card and nvcc; skips elsewhere. The repo's conftest imports
jax, which the card's machine does not have, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance, per output row (one query and head), as in chip_smoke.py
(`kernels.error_ratio`): |kernel - plain| <= 2^-7 max_row|plain| + atol,
one bf16 ulp of the row's largest value plus 1e-3 for K1/K2 (p rounded to
bf16 after exp2 in the kernel, after exp in the plain version) and 1e-4
for K9 (f32 p, summed in another order).
"""

import pytest
import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)


def _assert_close(name, out, ref, rows=None):
    err, ratio = kernels.error_ratio(name, out, ref, rows)
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.parametrize("shape", [(10, 729, 16, 72), (2, 200, 2, 64), (1, 77, 4, 128),
                                   (3, 64, 1, 16)])
def test_k1_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(gen, dev, *shape) for _ in range(3))
    before = kernels.launch_counts()["tower_attention"]
    out = tfa.tower_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tower_attention"] == before + 1
    _assert_close("tower_attention", out,
                  tfa.attention_plain(q, k, v, None, None, False, shape[-1] ** -0.5))


# (B, Sq, Sk, H, Hkv, D, causal, segments)
K2_CASES = [
    (2, 1024, 1024, 28, 4, 128, True, "left_pad"),  # Qwen2-7B prefill
    (2, 700, 700, 14, 2, 64, True, "left_pad"),  # Qwen2-0.5B, ragged tail
    (1, 333, 333, 4, 4, 128, True, None),  # causal, no segment ids
    (2, 256, 256, 8, 2, 72, False, "packed"),  # non-causal, packed segments
    (2, 192, 512, 8, 8, 64, True, "cache"),  # prefill into a longer cache
]


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_matches_plain(dev, case):
    b, sq, sk, h, hkv, d, causal, segs = case
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, dev, b, sq, h, d)
    k, v = _randn(gen, dev, b, sk, hkv, d), _randn(gen, dev, b, sk, hkv, d)
    qseg = kseg = None
    if segs is not None:
        qseg = torch.ones((b, sq), dtype=torch.int32, device=dev)
        if segs == "packed":
            qseg[:, sq // 3:] = 2
            qseg[0, -17:] = 0
        else:
            qseg[0, :sq // 3 + 5] = 0  # left padding: rows that attend nothing
        kseg = torch.zeros((b, sk), dtype=torch.int32, device=dev)
        kseg[:, :sq] = qseg
    out = tfa.prefill_attention(q, k, v, q_segment_ids=qseg, kv_segment_ids=kseg,
                                causal=causal)
    torch.cuda.synchronize()
    ref = tfa.attention_plain(q, k, v, qseg, kseg, causal, d ** -0.5)
    real = None if qseg is None else qseg != 0
    _assert_close("prefill_attention", out, ref, rows=real)
    if real is not None:
        assert torch.all(out[~real] == 0)


# (B, S, H, Hkv, D, layer)
K9_CASES = [
    (4, 4096, 28, 4, 128, 27),  # Qwen2-7B
    (2, 1000, 14, 2, 64, 0),  # Qwen2-0.5B, S not a multiple of 64
    (1, 77, 8, 1, 128, 1),  # one kv head for eight query heads
    (3, 300, 4, 4, 32, 2),  # no GQA
]


@pytest.mark.parametrize("case", K9_CASES)
def test_k9_matches_plain(dev, case):
    b, s, h, hkv, d, layer = case
    gen = torch.Generator(device=dev).manual_seed(2)
    ck, cv = _randn(gen, dev, layer + 1, b, s, hkv * d), _randn(gen, dev, layer + 1, b, s, hkv * d)
    q = _randn(gen, dev, b, h, d)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i in range(b):  # left padding, then an unwritten tail; row 1 has a hole
        seg[i, (7 * i) % (s // 3): s - 11 * i] = 1
    if b > 1:
        seg[1, s // 2: s // 2 + 9] = 0
    out = tdec.decode_attention_stacked(q, ck, cv, seg, layer, num_kv_heads=hkv)
    torch.cuda.synchronize()
    ref = tdec.decode_attention_plain(q, ck[layer], cv[layer], seg, num_kv_heads=hkv,
                                      scale=d ** -0.5)
    _assert_close("decode_attention", out, ref)


def test_k9_empty_row_is_zero(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    ck = _randn(gen, dev, 1, 2, 256, 2 * 64)
    q = _randn(gen, dev, 2, 4, 64)
    seg = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    seg[1, 100:] = 1
    out = tdec.decode_attention_stacked(q, ck, ck, seg, 0, num_kv_heads=2)
    torch.cuda.synchronize()
    assert torch.all(out[0] == 0)
    _assert_close("decode_attention", out[1],
                  tdec.decode_attention_plain(q, ck[0], ck[0], seg, num_kv_heads=2,
                                              scale=64 ** -0.5)[1])


def test_mha_on_the_card_launches_the_kernels(dev):
    """The dispatch sends tower and prefill attention to K1 and K2 on a CUDA
    tensor, and what the JAX package routes to XLA to the plain path."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _randn(gen, dev, 1, 64, 2, 64)
    kv = _randn(gen, dev, 1, 64, 1, 64)
    kernels.reset_launch_counts()
    tatt.mha(x, x, x)
    tatt.mha(x, kv, kv, causal=True)
    tatt.mha(x, kv, kv, causal=True, window=8)
    tatt.mha(x, kv, kv, causal=True, q_offset=3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "tower_attention": 1, "prefill_attention": 1, "decode_attention": 0}


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 8, 2, 8), device=dev, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        tfa.tower_attention(x, x, x)
    y = torch.zeros((1, 8, 2, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.prefill_attention(y, y, y, causal=True)
    q = torch.zeros((1, 16, 64), device=dev, dtype=torch.bfloat16)
    c = torch.zeros((1, 1, 32, 64), device=dev, dtype=torch.bfloat16)
    seg = torch.ones((1, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tdec.decode_attention_stacked(q, c, c, seg, 0, num_kv_heads=1)
