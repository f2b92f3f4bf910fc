"""The port's hand-written CUDA kernels (K1-K13) against
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
for K9 and K4 (f32 p, summed in another order) and for their windowed
variants K10 and K11, 1e-4 for K5/K6 (exact products, f32 sums in another
order; a row's result must not depend on how many rows it comes with). A
row of a K10 / K11 window must also equal, bit for bit, what K9 / K4 gives
for the same visible keys. K3 sums exactly in int32 and must
equal its plain version (f64 sums) bit for bit. K12 rounds each weight to
bf16 after its group scale, as its plain version does, so products are
exact and only the order of the f32 sums differs (1e-4); a row's result must
not depend on how many rows it comes with. K13 must equal `quantize_rows`
followed by K3 bit for bit.
"""

import copy
import dataclasses

import pytest
import torch

from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import flash_attention as tfa
from radvlm_tpu_torch.ops import int4_matmul as ti4
from radvlm_tpu_torch.ops import int8_matmul as ti8
from radvlm_tpu_torch.ops import kv_quant as tkv
from radvlm_tpu_torch.ops import quant as tq
from radvlm_tpu_torch.ops import w8a8_matmul as tw8
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import qwen2 as tqwen
from radvlm_tpu_torch.models.layers import Q4Linear, QLinear

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
                                   (3, 64, 1, 16), (1, 1000, 2, 128), (2, 129, 3, 30)])
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
    # Around the 128-row query tiles and 128-key K/V tiles of the kernel:
    (1, 1000, 1000, 7, 1, 64, True, "packed"),  # GQA 7:1; uniform kv tiles, then a mixed one
    (2, 1000, 1000, 14, 2, 64, True, "wide_pad"),  # whole query tiles of segment 0
    (1, 729, 729, 16, 16, 72, False, "packed"),  # D = 72, both sides of the clean/masked split
    (1, 129, 1000, 4, 1, 128, True, "cache"),  # Sk > Sq, one row past a tile
    (2, 200, 200, 4, 4, 16, False, None),  # D = 16
    (1, 129, 129, 6, 3, 30, True, "packed"),  # D % 8 != 0: 4-byte staging
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
        elif segs == "wide_pad":
            qseg[0, :600] = 0  # rows 0-511: four query tiles that attend nothing
        else:
            qseg[0, :sq // 3 + 5] = 0  # left padding: rows that attend nothing
        kseg = torch.zeros((b, sk), dtype=torch.int32, device=dev)
        kseg[:, :sq] = qseg
    kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg, causal=causal)
    out = tfa.prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = tfa.attention_plain(q, k, v, qseg, kseg, causal, d ** -0.5)
    real = None if qseg is None else qseg != 0
    _assert_close("prefill_attention", out, ref, rows=real)
    if real is not None:
        assert torch.all(out[~real] == 0)
    # The same launch gives the same bits (no atomics).
    assert torch.equal(out, tfa.prefill_attention(q, k, v, **kw))


@pytest.mark.parametrize("d", [64, 72, 128])
def test_k2_unaligned_views_give_the_aligned_bits(dev, d):
    """q / k / v that start 4 bytes past a 16-byte boundary take the 4-byte
    staging into the same shared-memory layout: the aligned copies' bits."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, h, hkv = 1, 300, 4, 2

    def unaligned(*shape):
        n = 1
        for x in shape:
            n *= x
        buf = _randn(gen, dev, n + 2)
        view = buf[2:].view(*shape)
        assert view.data_ptr() % 16 == 4
        return view

    q, k, v = unaligned(b, s, h, d), unaligned(b, s, hkv, d), unaligned(b, s, hkv, d)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    seg[0, :40] = 0
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=True)
    out = tfa.prefill_attention(q, k, v, **kw)
    aligned = tfa.prefill_attention(q.clone(), k.clone(), v.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, aligned)
    _assert_close("prefill_attention", out, tfa.attention_plain(q, k, v, seg, seg, True, d ** -0.5),
                  rows=seg.bool())


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


# (B, S, H, Hkv, D, layout): a chunk of several 64-key tiles a split (B x
# Hkv = 32 CTAs a split, so few splits), with visible islands apart by holes
# of 64 keys or more (whole tiles to skip inside a chunk); a hole that
# covers a whole split's chunk; a row whose only visible keys lie in its
# last, partial tile; D % 8 != 0 (4-byte staging).
K9_SKIP_CASES = [
    (8, 4096, 28, 4, 128, "islands"),
    (8, 4096, 28, 4, 128, "empty_chunk"),
    (4, 4000, 14, 2, 64, "last_tile"),
    (4, 1000, 6, 3, 30, "islands"),
]


@pytest.mark.parametrize("case", K9_SKIP_CASES)
def test_k9_skips_masked_tiles(dev, case):
    b, s, h, hkv, d, layout = case
    gen = torch.Generator(device=dev).manual_seed(12)
    ck, cv = _randn(gen, dev, 1, b, s, hkv * d), _randn(gen, dev, 1, b, s, hkv * d)
    q = _randn(gen, dev, b, h, d)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    if layout == "islands":
        for i in range(b):
            for lo in range(13 * i, s, 300):
                seg[i, lo: lo + 100 + 7 * i] = 1
    elif layout == "empty_chunk":
        seg[:, 100:] = 1
        nsplit, chunk = tdec._split_plan(b, hkv, s, kernels.sm_count(dev))
        assert nsplit > 2 and chunk >= 3 * 64
        seg[0, chunk: 2 * chunk] = 0  # split 1 of row 0 holds nothing
        seg[1, : s - 1] = 0  # row 1: one key, the last
    else:
        seg[:, s - 30:] = 1  # only the last (partial) tile
        seg[1] = 0  # and a row with nothing
    out = tdec.decode_attention_stacked(q, ck, cv, seg, 0, num_kv_heads=hkv)
    torch.cuda.synchronize()
    ref = tdec.decode_attention_plain(q, ck[0], cv[0], seg, num_kv_heads=hkv, scale=d ** -0.5)
    _assert_close("decode_attention", out, ref)
    empty = (seg == 0).all(-1)
    assert torch.all(out[empty] == 0)
    # The same launch gives the same bits.
    assert torch.equal(out, tdec.decode_attention_stacked(q, ck, cv, seg, 0, num_kv_heads=hkv))


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
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {
        "tower_attention": 1, "prefill_attention": 1}


@pytest.mark.parametrize("cache_format", ["bf16", "int8"])
def test_head_dim_256_decoder_runs_on_the_card(dev, cache_format):
    """Gemma's head dim of 256, which no attention kernel takes: the
    predicates send prefill and decode to the plain path, so a tiny bf16
    decoder prefills and decodes on the card without a raise, launches no
    attention kernel, and gives the CPU run's logits (the same plain
    attention; bf16 matmuls whose f32 sums run in another order: 2e-2 of the
    largest logit)."""
    base = tcfg.tiny_test_config()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, head_dim=256))
    text = cfg.text
    cpu = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").text
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(2, text.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    seg = torch.ones((2, 9), dtype=torch.int32)
    pos = torch.arange(9)[None].repeat(2, 1)
    cseg = torch.zeros((2, 32), dtype=torch.int32)
    cseg[:, :9] = 1

    def run(model, device):
        cache = (tqwen.init_kv_cache_q8(text, 2, 32, device=device) if cache_format == "int8"
                 else tqwen.init_kv_cache(text, 2, 32, device=device))
        on = lambda t: t.to(device)  # noqa: E731
        with torch.inference_mode():
            tqwen.forward(model, text, input_embeds=tqwen.embed_tokens(model, on(tokens[:, :8]), text),
                          positions=on(pos[:, :8]), segment_ids=on(seg[:, :8]), kv_cache=cache,
                          cache_index=0, cache_segment_ids=on(cseg))
            step, _ = tqwen.forward(
                model, text, input_embeds=tqwen.embed_tokens(model, on(tokens[:, 8:]), text),
                positions=on(pos[:, 8:]), segment_ids=on(seg[:, 8:]), kv_cache=cache,
                cache_index=on(torch.tensor([8, 8])), cache_segment_ids=on(cseg))
        return step.float().cpu()

    kernels.reset_launch_counts()
    out = run(card, dev)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts()[name] for name in (
        "prefill_attention", "decode_attention", "decode_attention_q8"))
    ref = run(cpu, "cpu")
    assert torch.isfinite(out).all() and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-2 * float(ref.abs().max()))


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
# The edges of K3's tiles: 129 rows (one past a 128-row tile) with a K whose
# last 128-byte box is partial and N = 129 (one past a multiple of 8 and
# 128); 65 rows (one past a 64-row warpgroup) over a few 256-column tiles.
K3_EDGE_CASES = [(129, 4304, 129), (65, 3584, 1000), (257, 16, 520)]


@pytest.mark.parametrize("case", K3_CASES + K3_EDGE_CASES)
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


def test_k3_row_offset_view_gives_the_bits_of_a_copy(dev):
    """xq as a view that starts a row into its storage (16-byte aligned,
    since K % 16 == 0) reads as a copy does."""
    gen = torch.Generator(device=dev).manual_seed(28)
    m, k, n = 300, 1152, 520
    xq, xs = tw8.quantize_rows(_randn(gen, dev, m + 1, k))
    wq = _int8(gen, dev, n, k)
    ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    view = tw8.w8a8_matmul(xq[1:], xs[1:], wq, ws)
    copy = tw8.w8a8_matmul(xq[1:].clone(), xs[1:].clone(), wq, ws)
    torch.cuda.synchronize()
    assert xq[1:].data_ptr() != xq.data_ptr() and torch.equal(view, copy)
    assert torch.equal(view, tw8.w8a8_matmul_plain(xq[1:], xs[1:, 0], wq, ws, torch.bfloat16))


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
# shapes (40 rows: a verify step of 8 slots x 5); an odd N and a K that is
# no multiple of 64.
K5_CASES = [(1, 3584, 4608), (8, 18944, 3584), (33, 3584, 37888), (64, 3584, 4608),
            (8, 3584, 152064), (40, 3584, 37888), (5, 112, 131), (64, 48, 3), (17, 4864, 896)]


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


@pytest.mark.parametrize("case", [(3584, 4608), (18944, 3584), (3584, 37888), (3584, 152064)])
def test_k5_row_does_not_depend_on_row_count(dev, case):
    """Rows 0-7 alone, among 40 and among 64 rows, and row 0 alone: the same
    bits (greedy speculative tokens must equal plain greedy tokens)."""
    k, n = case
    gen = torch.Generator(device=dev).manual_seed(27)
    x = _randn(gen, dev, 64, k)
    w = _int8(gen, dev, n, k)
    scale = torch.rand(n, generator=gen, device=dev) * 2e-4 + 1e-5
    y8 = ti8.int8_matmul(x[:8].contiguous(), w, scale)
    y1 = ti8.int8_matmul(x[:1].contiguous(), w, scale)
    y40 = ti8.int8_matmul(x[:40].contiguous(), w, scale)
    y64 = ti8.int8_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(y8, y40[:8]) and torch.equal(y8, y64[:8]) and torch.equal(y1, y8[:1])
    # The same launch gives the same bits (the K splits are summed in a fixed order).
    assert torch.equal(y40, ti8.int8_matmul(x[:40].contiguous(), w, scale))


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
    # TMA reads xq and wq from 16-byte-aligned bases: a contiguous view one
    # byte into its storage is refused, not copied or sent elsewhere.
    flat = torch.zeros(80 * 64 + 16, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tw8.w8a8_matmul(flat[1:1 + 80 * 64].view(80, 64), xs, w, s)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tw8.w8a8_matmul(xq, xs, flat[1:1 + 32 * 64].view(32, 64), s)
    q = torch.zeros((1, 4, 64), device=dev, dtype=torch.bfloat16)
    c = torch.zeros((1, 1, 32, 128), device=dev, dtype=torch.bfloat16)
    sc = torch.ones((1, 1, 2, 32), device=dev)
    seg = torch.ones((1, 32), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8"):
        tdec.decode_attention_stacked_q8(q, c, c, sc, sc, seg, 0, num_kv_heads=2)


# (B, S, H, Hkv, D, W, layer)
WINDOW_CASES = [
    (8, 4224, 28, 4, 128, 5, 27),  # Qwen2-7B, spec_k = 4
    (8, 4224, 28, 4, 128, 16, 3),  # the widest window: 112 query rows a CTA
    (2, 1000, 14, 2, 64, 3, 0),  # Qwen2-0.5B, S not a multiple of 64
    (1, 77, 8, 1, 128, 2, 1),  # one kv head for eight query heads
    (3, 300, 4, 4, 32, 7, 2),  # no GQA
]
# Holes of 100 keys in every slot's history: K9 skips whole tiles there and
# K10 does not, and their rows must still be equal.
WINDOW_HOLES_CASE = (8, 4224, 28, 4, 128, 5, 1)
WINDOW_CASES.append(WINDOW_HOLES_CASE)
# Every window straddles a key-tile edge (widx % 64 == 62): rows 0-1 see a
# tile that rows 2-4 see, and rows 2-4 a tile that rows 0-1 do not.
WINDOW_EDGE_CASE = (8, 4224, 28, 4, 128, 5, 2)
WINDOW_CASES.append(WINDOW_EDGE_CASE)


def _window_inputs(dev, case, quantized):
    """A stacked cache whose every entry is finite but stale above each
    slot's window, slots at different window indices after their own left
    padding: slot 0's window ends at the last cache index, the last slot
    (where B > 2) holds nothing."""
    b, s, h, hkv, d, w, layer = case
    gen = torch.Generator(device=dev).manual_seed(11)
    ck, cv = (_randn(gen, dev, layer + 1, b, s, hkv * d) for _ in range(2))
    q = _randn(gen, dev, b, w, h, d)
    widx = torch.tensor([s - w] + [(s // 2 + 97 * i) % (s - w) for i in range(1, b)],
                        dtype=torch.int32, device=dev)
    if case == WINDOW_EDGE_CASE:
        widx = widx - widx % 64 + 62
        widx = torch.where(widx > s - w, widx - 64, widx)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for i in range(b):
        seg[i, (13 * i) % (s // 4): int(widx[i]) + w] = 1
    if case == WINDOW_HOLES_CASE:  # 100 keys of every 300 up to the window
        for i in range(b):
            for lo in range(150, int(widx[i]) - 100, 300):
                seg[i, lo: lo + 100] = 0
    if b > 2:
        seg[b - 1] = 0
    if not quantized:
        return q, (ck, cv), seg, widx
    (kq, ks), (vq, vs) = tkv.quantize_kv(ck, hkv), tkv.quantize_kv(cv, hkv)
    return q, (kq, vq, ks, vs), seg, widx


@pytest.mark.parametrize("quantized", [False, True], ids=["k10", "k11"])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_matches_plain_and_single_query_kernel(dev, case, quantized):
    b, s, h, hkv, d, w, layer = case
    q, cache, seg, widx = _window_inputs(dev, case, quantized)
    name = "decode_attention_window_q8" if quantized else "decode_attention_window"
    before = kernels.launch_counts()[name]
    if quantized:
        out = tdec.decode_attention_stacked_window_q8(q, *cache, seg, layer, widx, num_kv_heads=hkv)
        ref = tdec.decode_attention_window_q8_plain(
            q, *(c[layer] for c in cache), seg, widx, num_kv_heads=hkv, scale=d ** -0.5)
    else:
        out = tdec.decode_attention_stacked_window(q, *cache, seg, layer, widx, num_kv_heads=hkv)
        ref = tdec.decode_attention_window_plain(
            q, cache[0][layer], cache[1][layer], seg, widx, num_kv_heads=hkv, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert out.shape == q.shape
    _assert_close(name, out, ref)
    if b > 2:
        assert torch.all(out[b - 1] == 0)  # nothing visible -> 0, not NaN
    # Row j equals the single-query kernel over the keys row j sees.
    ar = torch.arange(s, device=dev)[None]
    for j in range(w):
        seg_j = torch.where(ar <= (widx[:, None] + j), seg, torch.zeros_like(seg))
        if quantized:
            one = tdec.decode_attention_stacked_q8(q[:, j], *cache, seg_j, layer, num_kv_heads=hkv)
        else:
            one = tdec.decode_attention_stacked(q[:, j], *cache, seg_j, layer, num_kv_heads=hkv)
        assert torch.equal(out[:, j], one), j


def test_window_ignores_non_finite_stale_scales(dev):
    """Scales above the window may hold anything: K11 masks p, never p * vs."""
    case = (2, 512, 8, 2, 64, 4, 0)
    b, s, h, hkv, d, w, layer = case
    q, (kq, vq, ks, vs), seg, widx = _window_inputs(dev, case, True)
    clean = tdec.decode_attention_stacked_window_q8(q, kq, vq, ks, vs, seg, 0, widx,
                                                    num_kv_heads=hkv)
    ks2, vs2 = ks.clone(), vs.clone()
    for i in range(b):
        hi = int(widx[i]) + w
        ks2[0, i, :, hi:] = float("nan")
        vs2[0, i, :, hi:] = float("inf")
    seg2 = seg.clone()
    seg2[1, int(widx[1]) + w:] = 1  # stale segment bits above the window, too
    out = tdec.decode_attention_stacked_window_q8(q, kq, vq, ks2, vs2, seg2, 0, widx,
                                                  num_kv_heads=hkv)
    torch.cuda.synchronize()
    assert torch.equal(out, clean)


def test_window_wrappers_raise_on_bad_input(dev):
    q = torch.zeros((2, 17, 4, 64), dtype=torch.bfloat16, device=dev)
    ck = torch.zeros((1, 2, 128, 2 * 64), dtype=torch.bfloat16, device=dev)
    seg = torch.ones((2, 128), dtype=torch.int32, device=dev)
    widx = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a window wider than 16
        tdec.decode_attention_stacked_window(q, ck, ck, seg, 0, widx, num_kv_heads=2)
    with pytest.raises(ValueError):  # window_idx not int32
        tdec.decode_attention_stacked_window(q[:, :4], ck, ck, seg, 0, widx.long(), num_kv_heads=2)
    with pytest.raises(ValueError):  # an f32 cache
        tdec.decode_attention_stacked_window(q[:, :4], ck.float(), ck.float(), seg, 0, widx,
                                             num_kv_heads=2)


def _q4(gen, dev, n, k):
    """Random packed nibbles [n, k/2] (every value of -8..7 occurs) and
    group scales [k/128, n] of differing sizes."""
    w = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev, dtype=torch.uint8)
    scale = torch.rand(k // 128, n, generator=gen, device=dev) * 4e-3 + 1e-4
    return w, scale


# (rows, K, N): 1-64 rows; the Qwen2-7B qkv / o / gateup / down shapes (28
# and 148 groups: neither divides by every split count); an odd N; one group.
K12_CASES = [(1, 3584, 4608), (8, 3584, 3584), (40, 3584, 37888), (8, 18944, 3584),
             (64, 18944, 3584), (33, 3584, 4608), (5, 128, 131), (64, 256, 3),
             (17, 4864, 896)]


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_matches_plain(dev, case):
    m, k, n = case
    gen = torch.Generator(device=dev).manual_seed(20)
    x = _randn(gen, dev, m, k)
    w, scale = _q4(gen, dev, n, k)
    before = kernels.launch_counts()["int4_matmul"]
    out = ti4.int4_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int4_matmul"] == before + 1
    _assert_close("int4_matmul", out, ti4.int4_matmul_plain(x, w, scale))


@pytest.mark.parametrize("case", [(3584, 4608), (18944, 3584), (3584, 37888)])
def test_k12_row_does_not_depend_on_row_count(dev, case):
    """Rows 0-7 alone, among 40 and among 64 rows: the same bits (greedy
    speculative tokens must equal plain greedy tokens)."""
    k, n = case
    gen = torch.Generator(device=dev).manual_seed(21)
    x = _randn(gen, dev, 64, k)
    w, scale = _q4(gen, dev, n, k)
    y8 = ti4.int4_matmul(x[:8].contiguous(), w, scale)
    y1 = ti4.int4_matmul(x[:1].contiguous(), w, scale)
    y40 = ti4.int4_matmul(x[:40].contiguous(), w, scale)
    y64 = ti4.int4_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(y8, y40[:8]) and torch.equal(y8, y64[:8]) and torch.equal(y1, y8[:1])


# (K, N): the four int4 decode projections of Qwen2-7B and two odd widths
# (scales that TMA cannot read: a row pitch that is no multiple of 16 bytes).
K12_EXACT_SHAPES = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584), (128, 131),
                    (256, 3)]


@pytest.mark.parametrize("case", K12_EXACT_SHAPES)
def test_k12_dequantizes_each_weight_exactly(dev, case):
    """x of one-hot rows picks one k a row, so each output is one weight:
    K12 must give bf16(f32(nibble) * scale) bit for bit, for every nibble
    of the matrix (64 k a launch), with group scales spread over 2^-40 ..
    2^7, as `dequantize_weight_int4` (the dequant route's weights) does."""
    k, n = case
    gen = torch.Generator(device=dev).manual_seed(24)
    w = torch.randint(0, 256, (n, k // 2), generator=gen, device=dev, dtype=torch.uint8)
    scale = torch.exp2(torch.rand(k // 128, n, generator=gen, device=dev) * 47.0 - 40.0)
    ref = ti4.dequantize_weight_int4(w, scale)  # [N, K] bf16
    for k0 in range(0, k, 64):
        ks = torch.arange(k0, min(k, k0 + 64), device=dev)
        x = torch.zeros((len(ks), k), device=dev, dtype=torch.bfloat16)
        x[torch.arange(len(ks), device=dev), ks] = 1.0
        out = ti4.int4_matmul(x, w, scale)
        assert torch.equal(out, ref[:, ks].t()), k0


def test_k12_dequant_route_uses_the_same_weights(dev):
    """Above 64 rows a Q4Linear dequantizes (the weights K12 rounds) and
    runs one plain matmul; at or below it launches K12."""
    gen = torch.Generator(device=dev).manual_seed(22)
    w, scale = _q4(gen, dev, 96, 256)
    lin = Q4Linear(w, scale, _randn(gen, dev, 96))
    kernels.reset_launch_counts()
    x = _randn(gen, dev, 65, 256)
    big = lin(x)
    small = lin(x[:64].contiguous())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["int4_matmul"] == 1
    assert (tq.qmm_route(65, bits=4), tq.qmm_route(64, bits=4)) == ("dequant", "int4")
    _assert_close("int4_matmul", small, big[:64])


def test_k12_wrapper_rejects_what_the_kernel_does_not_take(dev):
    w = torch.zeros((32, 64), device=dev, dtype=torch.uint8)
    s = torch.ones((1, 32), device=dev)
    x = torch.zeros((2, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        ti4.int4_matmul(x.float(), w, s)
    with pytest.raises(ValueError, match="rows"):
        ti4.int4_matmul(torch.zeros((65, 128), device=dev, dtype=torch.bfloat16), w, s)
    with pytest.raises(ValueError, match="uint8"):
        ti4.int4_matmul(x, w.view(torch.int8), s)
    with pytest.raises(ValueError, match="does not match"):
        ti4.int4_matmul(x[:, :64].contiguous(), w[:, :32].contiguous(), s)
    with pytest.raises(ValueError, match="CUDA"):
        ti4.int4_matmul(x, w.cpu(), s)


# (M, K, N): K3's cases (K = 4304 is no multiple of 32; tower rows; odd N)
# plus the down projection's K = 18944 and an M that is no multiple of 128.
K13_CASES = K3_CASES + [(3456, 18944, 3584), (1000, 18944, 256), (129, 128, 128),
                        (130, 16, 300)]  # K = 16: one k-tile, mostly zeros past K


@pytest.mark.parametrize("case", K13_CASES)
def test_k13_equals_quantize_rows_then_k3(dev, case):
    m, k, n = case
    gen = torch.Generator(device=dev).manual_seed(23)
    x = _randn(gen, dev, m, k) * 3.0
    x[m // 2] = 0  # a row of zeros: amax clamps, y = 0
    wq = _int8(gen, dev, n, k)
    ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    counts = kernels.launch_counts()
    out = tw8.w8a8_matmul_fused(x, wq, ws)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["w8a8_matmul_fused"] == counts["w8a8_matmul_fused"] + 1
    assert after["w8a8_matmul"] == counts["w8a8_matmul"]
    xq, xs = tw8.quantize_rows(x)
    assert torch.equal(out, tw8.w8a8_matmul(xq, xs, wq, ws))
    assert torch.equal(out, tw8.w8a8_matmul_fused_plain(x, wq, ws))
    assert torch.all(out[m // 2] == 0)


def test_k13_rounds_half_to_even(dev):
    """A row whose amax is 127 has the scale 1.0 exactly, so x / xs lands
    on k + 0.5 for x = k + 0.5: round half to even, as `quantize_rows`."""
    gen = torch.Generator(device=dev).manual_seed(25)
    m, k, n = 64, 256, 512
    x = _randn(gen, dev, m, k)
    halves = torch.tensor([0.5, 1.5, 2.5, 3.5, -0.5, -2.5, 126.5, -125.5], device=dev)
    x[3] = halves.repeat(k // 8).to(torch.bfloat16)
    x[3, 0] = 127.0
    xq, xs = tw8.quantize_rows(x)
    assert float(xs[3]) == 1.0 and torch.all((x[3].float() / xs[3]).frac().abs()[1:] == 0.5)
    eye = torch.zeros((n, k), dtype=torch.int8, device=dev)
    eye[torch.arange(k), torch.arange(k)] = 1  # y[:, :k] = xq * xs * 1
    ws = torch.ones(n, device=dev)
    out = tw8.w8a8_matmul_fused(x, eye, ws)
    torch.cuda.synchronize()
    assert torch.equal(out, tw8.w8a8_matmul(xq, xs, eye, ws))
    # x[3, 1:9] = 1.5, 2.5, 3.5, -0.5, -2.5, 126.5, -125.5, 0.5
    assert torch.equal(out[3, 1:9].float(), torch.tensor([2., 2., 4., 0., -2., 126., -126., 0.],
                                                        device=dev))


def test_k13_quantizes_every_bf16_magnitude(dev):
    """Rows whose amax spans every normal bf16 exponent, holding bf16 bit
    patterns within eight binades below it (quotients 0.5-127, every
    mantissa) and anywhere below it (denormals, quotients that round to 0),
    both signs. With wq the identity and ws = 1, y[:, j] = bf16(xq[:, j] *
    xs): two int8 values one apart land on two bf16 values, so every
    quantized element is compared with `quantize_rows`'s."""
    gen = torch.Generator(device=dev).manual_seed(27)
    m, k = 1024, 4096

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    amax = (ints(1, 255, m) << 7) | ints(0, 128, m)  # bf16 bits, normal
    near = (amax[:, None] - ints(0, 1024, m, k // 2)).clamp_min(0)
    far = (torch.rand(m, k // 2, generator=gen, device=dev) * (amax[:, None] + 1).float()).long()
    bits = torch.cat([near, far], 1).clamp_max(amax[:, None])
    bits[:, 0] = amax
    bits = bits | (ints(0, 2, m, k) << 15)
    x = torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16).view(torch.bfloat16)
    assert torch.isfinite(x.float()).all()
    eye = torch.eye(k, device=dev).to(torch.int8)
    ones = torch.ones(k, device=dev)
    out = tw8.w8a8_matmul_fused(x, eye, ones)
    xq, xs = tw8.quantize_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(out, tw8.w8a8_matmul(xq, xs, eye, ones))


@pytest.mark.parametrize("case", [(3584, 4608), (18944, 3584)])
def test_k13_row_does_not_depend_on_row_count(dev, case):
    """Row 0 alone and among 3456 rows: the same bits."""
    k, n = case
    gen = torch.Generator(device=dev).manual_seed(26)
    x = _randn(gen, dev, 3456, k)
    wq = _int8(gen, dev, n, k)
    ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    many = tw8.w8a8_matmul_fused(x, wq, ws)
    one = tw8.w8a8_matmul_fused(x[:1].contiguous(), wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(one[0], many[0])
    assert torch.equal(many, tw8.w8a8_matmul_fused(x, wq, ws))


def test_qmm_takes_the_fused_kernel_when_asked(dev, monkeypatch):
    gen = torch.Generator(device=dev).manual_seed(24)
    lin = QLinear(_int8(gen, dev, 96, 64), torch.full((96,), 1e-3, device=dev),
                  _randn(gen, dev, 96))
    x = _randn(gen, dev, 200, 64)
    ref = lin(x)
    monkeypatch.setenv("RADVLM_W8A8_IMPL", "fused")
    kernels.reset_launch_counts()
    out = lin(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["w8a8_matmul_fused"], counts["w8a8_matmul"]) == (1, 0)
    assert torch.equal(out, ref)


def test_k13_wrapper_rejects_what_the_kernel_does_not_take(dev):
    w = torch.zeros((32, 64), device=dev, dtype=torch.int8)
    s = torch.ones(32, device=dev)
    x = torch.zeros((80, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tw8.w8a8_matmul_fused(x.float(), w, s)
    with pytest.raises(ValueError, match="multiple of 16"):
        tw8.w8a8_matmul_fused(x[:, :40].contiguous(), w[:, :40].contiguous(), s)
    with pytest.raises(ValueError, match="CUDA"):
        tw8.w8a8_matmul_fused(x, w.cpu(), s)


# The training kernels: K2 with its lse, K7 (dk, dv) and K8 (dq).
# (B, Sq, Sk, H, Hkv, D, causal, segments)
BWD_CASES = [
    (1, 1024, 1024, 14, 2, 64, True, "packed"),  # Qwen2-0.5B, packed rows with padding
    (1, 1024, 1024, 28, 4, 128, True, "left_pad"),  # Qwen2-7B
    (5, 729, 729, 16, 16, 72, False, None),  # the SigLIP tower: ragged, D padded to 80
    (2, 700, 700, 14, 2, 64, True, "left_pad"),  # ragged tail, rows that attend nothing
    (1, 333, 333, 4, 4, 128, True, None),  # causal, no segment ids
    (2, 256, 256, 8, 2, 72, False, "packed"),  # non-causal, packed segments
    (2, 192, 512, 8, 8, 64, True, "cache"),  # Sk > Sq
    (1, 130, 130, 6, 3, 30, True, None),  # head_dim not a multiple of 8: 4-byte staging
    (1, 1000, 1000, 7, 1, 128, True, "packed"),  # GQA 7:1, ragged 128-row tiles
    (2, 129, 200, 4, 2, 16, False, "packed"),  # Sk > Sq, D = 16
    # K7's GQA group split over a cluster of c CTAs, c the largest divisor of
    # g <= 8: g = 14 and 16 (c = 7, 8; two heads a CTA), g = 2 at D = 72,
    # g = 71 (prime: c = 1, one CTA walks the group).
    (1, 300, 300, 14, 1, 64, True, "packed"),
    (1, 300, 300, 16, 1, 128, True, "left_pad"),
    (2, 200, 200, 4, 2, 72, True, "packed"),
    (1, 130, 130, 71, 1, 64, False, None),
]


def _bwd_inputs(dev, case):
    b, sq, sk, h, hkv, d, causal, segs = case
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _randn(gen, dev, b, sq, h, d)
    k, v = _randn(gen, dev, b, sk, hkv, d), _randn(gen, dev, b, sk, hkv, d)
    do = _randn(gen, dev, b, sq, h, d)
    dlse = torch.randn(b, h, sq, generator=gen, device=dev)
    qseg = kseg = None
    if segs is not None:
        qseg = torch.ones((b, sq), dtype=torch.int32, device=dev)
        if segs == "packed":
            qseg[:, sq // 3:] = 2
            qseg[0, -17:] = 0
        else:
            qseg[0, :sq // 3 + 5] = 0
        kseg = torch.zeros((b, sk), dtype=torch.int32, device=dev)
        kseg[:, :sq] = qseg
    return q, k, v, do, dlse, qseg, kseg


@pytest.mark.parametrize("case", BWD_CASES)
def test_k2_lse_matches_plain_and_k2(dev, case):
    causal, d = case[6], case[5]
    q, k, v, _, _, qseg, kseg = _bwd_inputs(dev, case)
    before = kernels.launch_counts()["prefill_attention_lse"]
    o, lse = tfa.prefill_attention_lse(q, k, v, q_segment_ids=qseg, kv_segment_ids=kseg,
                                       causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["prefill_attention_lse"] == before + 1
    # The no-lse entry point computes the same o, bit for bit.
    assert torch.equal(o, tfa.prefill_attention(q, k, v, q_segment_ids=qseg,
                                                kv_segment_ids=kseg, causal=causal))
    ref_o, ref_lse = tfa.attention_plain(q, k, v, qseg, kseg, causal, d ** -0.5, with_lse=True)
    real = None if qseg is None else qseg != 0
    _assert_close("prefill_attention_lse", o, ref_o, rows=real)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert torch.all(lse[~fin] == float("-inf"))
    # f32 sums in another order, exp2 / log for exp / log.
    assert float((lse[fin] - ref_lse[fin]).abs().max()) <= 1e-4 * max(
        1.0, float(ref_lse[fin].abs().max()))


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("case", BWD_CASES)
def test_k7_k8_match_plain(dev, case, with_dlse):
    causal, d = case[6], case[5]
    q, k, v, do, dlse, qseg, kseg = _bwd_inputs(dev, case)
    kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg, causal=causal)
    o, lse = tfa.prefill_attention_lse(q, k, v, **kw)
    dlse = dlse if with_dlse else None
    if dlse is not None:  # no cotangent reaches a row whose lse is -inf
        dlse = torch.where(torch.isfinite(lse), dlse, torch.zeros_like(dlse))
    delta = tfa.attention_delta(o, do, dlse)
    before = kernels.launch_counts()
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    rq, rk, rv = tfa.attention_backward_plain(q, k, v, qseg, kseg, o, lse, do, dlse, causal,
                                              d ** -0.5)
    _assert_close("flash_attention_bwd_dq", dq, rq)
    _assert_close("flash_attention_bwd_dkv", dk, rk)
    _assert_close("flash_attention_bwd_dkv", dv, rv)
    if qseg is not None:  # rows that attend nothing, keys nobody attends: exact zeros
        assert torch.all(dq[qseg == 0] == 0)
        assert torch.all(dk[kseg == 0] == 0) and torch.all(dv[kseg == 0] == 0)
    # The same launch gives the same bits (no atomics).
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_attention_function_on_the_card(dev):
    """`flash_attention` under a gradient: K2-lse forward, K7/K8 backward, f32
    inputs cast to bf16 and back; the tower shape does not take K1."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 729, 16, 72, generator=gen, device=dev, requires_grad=True)
               for _ in range(3))
    kernels.reset_launch_counts()
    out = tfa.flash_attention(q, k, v)
    assert out.dtype == torch.float32
    w = torch.randn(out.shape, generator=gen, device=dev)
    dq, dk, dv = torch.autograd.grad((out * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["tower_attention"] == 0 and counts["prefill_attention_lse"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1 and counts["flash_attention_bwd_dq"] == 1
    qb, kb, vb = (t.detach().to(torch.bfloat16) for t in (q, k, v))
    o, lse = tfa.attention_plain(qb, kb, vb, None, None, False, 72 ** -0.5, with_lse=True)
    rq, rk, rv = tfa.attention_backward_plain(qb, kb, vb, None, None, o, lse,
                                              w.to(torch.bfloat16), None, False, 72 ** -0.5)
    _assert_close("flash_attention_bwd_dq", dq, rq)
    _assert_close("flash_attention_bwd_dkv", dk, rk)
    _assert_close("flash_attention_bwd_dkv", dv, rv)


@pytest.mark.parametrize("d", [64, 72, 128])
def test_k7_k8_unaligned_views_give_the_aligned_bits(dev, d):
    """q / k / v / do that start 4 bytes past a 16-byte boundary take the
    4-byte staging into the same shared-memory layout: the aligned copies'
    bits, and within the bound of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, h, hkv = 1, 300, 14, 2

    def unaligned(*shape):
        n = 1
        for x in shape:
            n *= x
        buf = _randn(gen, dev, n + 2)
        view = buf[2:].view(*shape)
        assert view.data_ptr() % 16 == 4
        return view

    q, k, v = unaligned(b, s, h, d), unaligned(b, s, hkv, d), unaligned(b, s, hkv, d)
    do = unaligned(b, s, h, d)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    seg[0, :40] = 0
    seg[0, 200:] = 2
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=True)
    o, lse = tfa.prefill_attention_lse(q.clone(), k.clone(), v.clone(), **kw)
    delta = tfa.attention_delta(o, do, None)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    aligned = [t.clone() for t in (q, k, v, do)]
    dk_a, dv_a = tfa.flash_attention_bwd_dkv(*aligned, lse, delta, **kw)
    dq_a = tfa.flash_attention_bwd_dq(*aligned, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq_a) and torch.equal(dk, dk_a) and torch.equal(dv, dv_a)
    rq, rk, rv = tfa.attention_backward_plain(q, k, v, seg, seg, o, lse, do, None, True,
                                              d ** -0.5)
    _assert_close("flash_attention_bwd_dq", dq, rq)
    _assert_close("flash_attention_bwd_dkv", dk, rk)
    _assert_close("flash_attention_bwd_dkv", dv, rv)
