"""The port's hand-written CUDA kernels (K1, K2, K9, K3, K4, K5/K6) against
their plain PyTorch versions on the card, at shapes beyond the main path's:
other head dims and GQA ratios, ragged sequence tails, Sq < Sk, rows with
nothing to attend, K and N tails of the int8 matmuls, 1-64 decode rows.

Needs a CUDA card and nvcc; skips elsewhere. The repo's conftest imports
jax, which the card's machine does not have, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance, per output row (one query and head), as in chip_smoke.py
(`kernels.error_ratio`): |kernel - plain| <= 2^-7 max_row|plain| + atol,
one bf16 ulp of the row's largest value plus 1e-3 for K1/K2 (p rounded to
bf16 after exp2 in the kernel, after exp in the plain version) and 1e-4
for K9 and K4 (f32 p, summed in another order), 1e-4 for K5/K6 (exact
products, f32 sums in another order). K3 sums exactly in int32 and must
equal its plain version (f64 sums) bit for bit.
"""

import pytest
import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import flash_attention as tfa
from radvlm_tpu_torch.ops import int8_matmul as ti8
from radvlm_tpu_torch.ops import kv_quant as tkv
from radvlm_tpu_torch.ops import quant as tq
from radvlm_tpu_torch.ops import w8a8_matmul as tw8
from radvlm_tpu_torch.models.layers import QLinear

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
        "tower_attention": 1, "prefill_attention": 1, "decode_attention": 0,
        "w8a8_matmul": 0, "decode_attention_q8": 0, "int8_matmul": 0}


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


def _int8(gen, dev, *shape):
    """Uniform over the whole byte range: -128 occurs."""
    return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)


# (M, K, N): K = 4304 is no multiple of 32 and fc1 has 4304 columns (the
# SigLIP MLP); M = 729 x 5 tower rows; a Qwen2-7B prefill shape; odd N.
K3_CASES = [(1, 4304, 1152), (65, 1152, 4304), (729 * 5, 4304, 1152),
            (3456, 3584, 4608), (200, 64, 129)]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_matches_plain_bit_for_bit(dev, case):
    m, k, n = case
    gen = torch.Generator(device=dev).manual_seed(5)
    xq, xs = tw8.quantize_rows(_randn(gen, dev, m, k))
    wq = _int8(gen, dev, n, k)
    ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    before = kernels.launch_counts()["w8a8_matmul"]
    out = tw8.w8a8_matmul(xq, xs, wq, ws)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["w8a8_matmul"] == before + 1
    ref = tw8.w8a8_matmul_plain(xq, xs[:, 0], wq, ws, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


# (B, S, H, Hkv, D, layer): groups 1-8, the Qwen2-7B decode shape.
K4_CASES = [
    (8, 4224, 28, 4, 128, 27),  # Qwen2-7B, 8 slots
    (2, 1000, 14, 2, 64, 0),  # Qwen2-0.5B, S not a multiple of 64
    (1, 77, 8, 1, 128, 1),  # eight query heads per kv head
    (3, 300, 4, 4, 32, 2),  # no GQA
    (2, 130, 6, 2, 16, 0),  # three per kv head, D = 16
]


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_matches_plain(dev, case):
    b, s, h, hkv, d, layer = case
    gen = torch.Generator(device=dev).manual_seed(6)
    ck, ks = tkv.quantize_kv(_randn(gen, dev, layer + 1, b, s, hkv * d), hkv)
    cv, vs = tkv.quantize_kv(_randn(gen, dev, layer + 1, b, s, hkv * d), hkv)
    q = _randn(gen, dev, b, h, d)
    # Per-row write indices: row i holds left padding, then keys up to its
    # own write index; nothing after it is attended.
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i in range(b):
        seg[i, (5 * i) % (s // 4): s - 1 - 13 * i] = 1
    before = kernels.launch_counts()["decode_attention_q8"]
    out = tdec.decode_attention_stacked_q8(q, ck, cv, ks, vs, seg, layer, num_kv_heads=hkv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention_q8"] == before + 1
    ref = tdec.decode_attention_q8_plain(q, ck[layer], cv[layer], ks[layer], vs[layer], seg,
                                         num_kv_heads=hkv, scale=d ** -0.5)
    _assert_close("decode_attention_q8", out, ref)


def test_k4_empty_row_is_zero(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    ck, ks = tkv.quantize_kv(_randn(gen, dev, 1, 2, 256, 2 * 64), 2)
    q = _randn(gen, dev, 2, 4, 64)
    seg = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    seg[1, 100:] = 1
    out = tdec.decode_attention_stacked_q8(q, ck, ck, ks, ks, seg, 0, num_kv_heads=2)
    torch.cuda.synchronize()
    assert torch.all(out[0] == 0)
    _assert_close("decode_attention_q8", out[1], tdec.decode_attention_q8_plain(
        q, ck[0], ck[0], ks[0], ks[0], seg, num_kv_heads=2, scale=64 ** -0.5)[1])


# (rows, K, N): 1-64 rows; the Qwen2-7B qkv / down / gateup / lm_head
# shapes; an odd N and a K that is no multiple of 64.
K5_CASES = [(1, 3584, 4608), (8, 18944, 3584), (33, 3584, 37888), (64, 3584, 4608),
            (8, 3584, 152064), (5, 112, 131), (64, 48, 3), (17, 4864, 896)]


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_matches_plain(dev, case):
    m, k, n = case
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _randn(gen, dev, m, k)
    w = _int8(gen, dev, n, k)
    scale = torch.rand(n, generator=gen, device=dev) * 2e-4 + 1e-5
    before = kernels.launch_counts()["int8_matmul"]
    out = ti8.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int8_matmul"] == before + 1
    _assert_close("int8_matmul", out, ti8.int8_matmul_plain(x, w, scale))


def test_qlinear_routes_by_row_count_on_the_card(dev):
    """qmm sends more than 64 rows to K3, 64 or fewer to K5/K6, and the
    lm_head's w8a8=False above 64 rows to the plain dequantized matmul."""
    gen = torch.Generator(device=dev).manual_seed(9)
    lin = QLinear(_int8(gen, dev, 96, 64), torch.full((96,), 1e-3, device=dev),
                  _randn(gen, dev, 96))
    kernels.reset_launch_counts()
    lin(_randn(gen, dev, 65, 64))
    lin(_randn(gen, dev, 2, 32, 64))
    lin(_randn(gen, dev, 2, 40, 64), w8a8=False)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["w8a8_matmul"], counts["int8_matmul"]) == (1, 1)
    assert tq.qmm_route(65, False) == "dequant"


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    w = torch.zeros((32, 64), device=dev, dtype=torch.int8)
    s = torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        ti8.int8_matmul(torch.zeros((2, 64), device=dev), w, s)
    with pytest.raises(ValueError, match="rows"):
        ti8.int8_matmul(torch.zeros((65, 64), device=dev, dtype=torch.bfloat16), w, s)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_matmul(torch.zeros((2, 64), device=dev, dtype=torch.bfloat16), w.cpu(), s)
    xq = torch.zeros((80, 64), device=dev, dtype=torch.int8)
    xs = torch.ones((80, 1), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        tw8.w8a8_matmul(xq, xs, w, s, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="int8"):
        tw8.w8a8_matmul(xq.float(), xs, w, s)
    with pytest.raises(ValueError, match="multiple of 16"):
        tw8.w8a8_matmul(xq[:, :40].contiguous(), xs, w[:, :40].contiguous(), s)
    q = torch.zeros((1, 4, 64), device=dev, dtype=torch.bfloat16)
    c = torch.zeros((1, 1, 32, 128), device=dev, dtype=torch.bfloat16)
    sc = torch.ones((1, 1, 2, 32), device=dev)
    seg = torch.ones((1, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8"):
        tdec.decode_attention_stacked_q8(q, c, c, sc, sc, seg, 0, num_kv_heads=2)
