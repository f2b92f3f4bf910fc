"""Parity of the PyTorch port's attention ops with the JAX package on CPU.

The same numpy inputs go through the JAX function and its port. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them; on CPU tensors the port's kernel wrappers run their plain versions
(the CUDA kernels themselves are held against those on the card by
chip_smoke.py). Tolerance for the kernels' plain versions: f32, 2e-5, the
JAX package's own flash-attention tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu.ops import attention as jatt
from radvlm_tpu.ops.decode_attention import decode_attention_stacked as j_decode
from radvlm_tpu.ops.decode_attention import decode_attention_stacked_window as j_window
from radvlm_tpu.ops.decode_attention import decode_attention_stacked_window_q8 as j_window_q8
from radvlm_tpu.ops.kv_quant import quantize_kv as j_quantize_kv
from radvlm_tpu.ops.flash_attention import flash_attention as j_flash
from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import flash_attention as tfa
from radvlm_tpu_torch.ops import int8_matmul as ti8
from radvlm_tpu_torch.ops import w8a8_matmul as tw8

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("llama3", [False, True])
def test_rope_matches_jax(rng, llama3):
    x = _rand(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    kw = None
    if llama3:
        kw = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                  original_max_position=64)
    ref = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, kw)
    out = tatt.apply_rope(_t(x), _t(pos), 10000.0, kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_norms_match_jax(rng):
    x, w, b = _rand(rng, (3, 5, 24)), _rand(rng, (24,)), _rand(rng, (24,))
    for offset in (0.0, 1.0):
        ref = jatt.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset)
        out = tatt.rms_norm(_t(x), _t(w), 1e-6, offset)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
    ref = jatt.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    out = tatt.layer_norm(_t(x), _t(w), _t(b), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_offset", [0, 5, "per_row"])
@pytest.mark.parametrize("window", [0, 3])
def test_attention_mask_matches_jax(rng, q_offset, window):
    qseg = rng.integers(0, 3, (2, 4)).astype(np.int32)
    kseg = rng.integers(0, 3, (2, 12)).astype(np.int32)
    off = np.array([2, 7], np.int32) if q_offset == "per_row" else q_offset
    ref = jatt.make_attention_mask(jnp.asarray(qseg), jnp.asarray(kseg), True,
                                   jnp.asarray(off) if q_offset == "per_row" else off,
                                   window)
    out = tatt.make_attention_mask(_t(qseg), _t(kseg), True,
                                   _t(off) if q_offset == "per_row" else off, window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("window,alibi", [(0, 0), (5, 0), (0, 8)])
def test_mha_plain_path_matches_jax(rng, window, alibi):
    """Window and ALiBi go to the plain path in both packages (the kernels
    have neither); the query block sits at a cache offset, GQA 2."""
    b, sq, sk, h, hkv, d = 2, 3, 16, 4, 2, 8
    q, k, v = _rand(rng, (b, sq, h, d)), _rand(rng, (b, sk, hkv, d)), _rand(rng, (b, sk, hkv, d))
    qseg = np.ones((b, sq), np.int32)
    kseg = np.ones((b, sk), np.int32)
    kseg[0, :4] = 0
    args = dict(causal=True, q_offset=9, window=window, alibi=alibi)
    ref = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg), **args)
    assert not tatt.flash_eligible(_t(q), _t(k), q_offset=9, window=window, alibi=alibi)
    out = tatt.mha(_t(q), _t(k), _t(v), q_segment_ids=_t(qseg), kv_segment_ids=_t(kseg), **args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(2, 729, 16, 72), (1, 200, 2, 16)])
def test_k1_plain_matches_pallas(rng, shape):
    """K1 (`_fwd_short`) at the SigLIP tower's shape and at a small
    non-aligned S; both reach the single-pass kernel in JAX."""
    q, k, v = (_rand(rng, shape) for _ in range(3))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, interpret=True)
    assert tfa.tower_eligible(_t(q), _t(k), None, False)
    out = tfa.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _left_pad_and_packed(b, s):
    seg = np.ones((b, s), np.int32)
    seg[0, :37] = 0  # left padding
    seg[1, 100:] = 2  # two packed segments, no padding
    return seg


@pytest.mark.parametrize("gqa", [1, 2])
def test_k2_plain_matches_pallas(rng, gqa):
    """K2 (`_fwd_kernel`), causal with left padding and packed segments;
    only rows with a non-zero segment are compared (the XLA path and the
    kernel differ on padding rows, which nothing attends)."""
    b, s, h, d = 2, 256, 4, 64
    q = _rand(rng, (b, s, h, d))
    k, v = _rand(rng, (b, s, h // gqa, d)), _rand(rng, (b, s, h // gqa, d))
    seg = _left_pad_and_packed(b, s)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                  causal=True, block_q=128, block_k=128, interpret=True)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), q_segment_ids=_t(seg),
                              kv_segment_ids=_t(seg), causal=True)
    real = seg != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)
    np.testing.assert_array_equal(out.numpy()[~real], 0.0)


def test_k2_plain_prefill_into_longer_cache(rng):
    """Sq < Sk with q_offset 0: future cache slots masked by causality and
    the kv segment ids."""
    b, sq, sk, h, hkv, d = 2, 128, 256, 4, 2, 64
    q = _rand(rng, (b, sq, h, d))
    k, v = _rand(rng, (b, sk, hkv, d)), _rand(rng, (b, sk, hkv, d))
    qseg = np.ones((b, sq), np.int32)
    qseg[1, :20] = 0
    kseg = np.zeros((b, sk), np.int32)
    kseg[:, :sq] = qseg
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  q_segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg),
                  causal=True, block_q=128, block_k=128, interpret=True)
    out = tatt.mha(_t(q), _t(k), _t(v), q_segment_ids=_t(qseg), kv_segment_ids=_t(kseg),
                   causal=True)
    real = qseg != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)


def test_k9_plain_matches_pallas(rng):
    """K9 (`_fused_heads_kernel`) over a partly written stacked cache: left
    padding first, an unwritten tail, one row with a hole."""
    n_layers, b, s, h, hkv, d = 2, 3, 256, 4, 2, 64
    q = _rand(rng, (b, h, d))
    ck = _rand(rng, (n_layers, b, s, hkv * d))
    cv = _rand(rng, (n_layers, b, s, hkv * d))
    seg = np.zeros((b, s), np.int32)
    seg[0, 40:150] = 1
    seg[1, :200] = 1
    seg[2, 10:60] = 1
    seg[2, 100:101] = 1
    ref = j_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(seg), 1,
                   num_kv_heads=hkv, block_k=128, interpret=True)
    out = tdec.decode_attention_stacked(_t(q), _t(ck), _t(cv), _t(seg), 1, num_kv_heads=hkv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_k9_plain_empty_row_is_zero(rng):
    q = _t(_rand(rng, (1, 2, 8)))
    ck = _t(_rand(rng, (1, 1, 16, 8)))
    out = tdec.decode_attention_stacked(q, ck, ck, torch.zeros(1, 16, dtype=torch.int32), 0,
                                        num_kv_heads=1)
    assert torch.all(out == 0)


def test_dispatch_reaches_the_kernel_wrappers(rng, monkeypatch):
    """mha sends tower-shaped calls to K1 and everything else eligible to
    K2; window, ALiBi, a non-zero offset and impl="xla" stay plain."""
    calls = []
    monkeypatch.setattr(tfa, "tower_attention",
                        lambda q, k, v, scale=None: calls.append("k1") or q)
    monkeypatch.setattr(tfa, "prefill_attention",
                        lambda q, k, v, **kw: calls.append("k2") or q)
    x = _t(_rand(rng, (1, 32, 2, 8)))
    kv = _t(_rand(rng, (1, 32, 1, 8)))
    seg = torch.ones(1, 32, dtype=torch.int32)
    tatt.mha(x, x, x)
    tatt.mha(x, kv, kv, causal=True)
    tatt.mha(x, x, x, q_segment_ids=seg, kv_segment_ids=seg, causal=True)
    tatt.mha(x, x, x, causal=True, window=4)
    tatt.mha(x, x, x, causal=True, alibi=8)
    tatt.mha(x, x, x, causal=True, q_offset=3)
    tatt.mha(x, x, x, impl="xla")
    assert calls == ["k1", "k2", "k2"]


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor on a card gets no plain
    fallback: the wrapper raises, and counts nothing."""
    kernels.reset_launch_counts()
    m = torch.empty((1, 8, 2, 8), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.tower_attention(m, m, m)
    with pytest.raises(ValueError):
        tfa.prefill_attention(m, m, m, causal=True)
    with pytest.raises(ValueError, match="shapes"):  # checked before any pointer is passed
        tfa.prefill_attention(m, m[..., :4], m[..., :4], causal=True)
    with pytest.raises(ValueError):
        tdec.decode_attention_stacked(m[:, 0], m[:, :, 0][None], m[:, :, 0][None],
                                      torch.ones(1, 8, dtype=torch.int32, device="meta"), 0,
                                      num_kv_heads=1)
    i8 = torch.empty((1, 8, 16), device="meta", dtype=torch.int8)
    f32 = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError):
        tdec.decode_attention_stacked_q8(torch.empty((1, 2, 16), device="meta", dtype=torch.bfloat16),
                                         i8[None], i8[None], f32[:, None, :1], f32[:, None, :1],
                                         torch.ones(1, 8, dtype=torch.int32, device="meta"), 0,
                                         num_kv_heads=1)
    w = torch.empty((32, 16), device="meta", dtype=torch.int8)
    s = torch.empty((32,), device="meta")
    with pytest.raises(ValueError):
        ti8.int8_matmul(torch.empty((2, 16), device="meta", dtype=torch.bfloat16), w, s)
    with pytest.raises(ValueError):
        tw8.w8a8_matmul(torch.empty((80, 16), device="meta", dtype=torch.int8),
                        torch.empty((80, 1), device="meta"), w, s)
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError):
        tfa.prefill_attention_lse(m, m, m, causal=True)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(m, m, m, m, lse, lse, causal=True)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(m, m, m, m, lse, lse, causal=True)
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.launch_counts()) == {
        "tower_attention", "prefill_attention", "decode_attention", "w8a8_matmul",
        "decode_attention_q8", "int8_matmul", "decode_attention_window",
        "decode_attention_window_q8", "int4_matmul", "w8a8_matmul_fused",
        "prefill_attention_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}


def test_kernel_sources_and_build_dir():
    """The CUDA sources ship with the package and build into a git-ignored
    directory; importing the module needs no toolkit."""
    import os

    names = sorted(os.path.basename(s) for s in kernels._sources())
    assert names == ["common.cuh", "decode_attention.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "int4_matmul.cu", "int8_matmul.cu",
                     "w8a8_matmul.cu"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.relpath(kernels.BUILD_DIR, repo).startswith("build")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "build/" in f.read().split()


@pytest.mark.parametrize("mutation", ["drop_newest", "pad_slot_in", "first_slot_out"])
def test_error_ratio_catches_one_mis_masked_slot(mutation):
    """The card-side bound (`kernels.error_ratio`) rejects a decode output
    off by one slot at a segment edge, at Qwen2-7B's heads and a 1k cache,
    and accepts the plain version computed from the same values in f32."""
    gen = torch.Generator().manual_seed(0)
    b, s = 2, 1024
    ck, cv = (torch.randn(b, s, 4 * 128, generator=gen, dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(b, 28, 128, generator=gen, dtype=torch.bfloat16)
    spans = [(300, 900), (40, 1000)]
    shift = {"drop_newest": (0, -1), "pad_slot_in": (-1, 0), "first_slot_out": (1, 0)}[mutation]

    def run(spans, dtype=torch.bfloat16):
        seg = torch.zeros((b, s), dtype=torch.int32)
        for i, (lo, hi) in enumerate(spans):
            seg[i, lo:hi] = 1
        return tdec.decode_attention_plain(q.to(dtype), ck.to(dtype), cv.to(dtype), seg,
                                           num_kv_heads=4, scale=128 ** -0.5)

    ref = run(spans)
    _, ratio = kernels.error_ratio("decode_attention", run(spans, torch.float32), ref)
    assert ratio <= 1.0
    _, ratio = kernels.error_ratio(
        "decode_attention", run([(lo + shift[0], hi + shift[1]) for lo, hi in spans]), ref)
    assert ratio > 4.0


def _window_case(rng, w):
    """Slots at different window indices after their own left padding; slot
    1's window ends at the last cache index, slot 2 has a hole."""
    n_layers, b, s, h, hkv, d = 2, 3, 256, 4, 2, 64
    q = _rand(rng, (b, w, h, d))
    ck, cv = _rand(rng, (n_layers, b, s, hkv * d)), _rand(rng, (n_layers, b, s, hkv * d))
    widx = np.array([100, s - w, 37], np.int32)
    seg = np.zeros((b, s), np.int32)
    for i, lo in enumerate((0, 30, 5)):
        seg[i, lo:widx[i] + w] = 1
    seg[2, 20:23] = 0
    return q, ck, cv, widx, seg, hkv


@pytest.mark.parametrize("w", [3, 16])
def test_k10_plain_matches_pallas(rng, w):
    """K10 (`_fused_heads_window_kernel`, interpret mode) on f32 inputs, at
    the tolerance of tests/test_window_decode.py: 2e-5 (f32 sums in another
    order)."""
    q, ck, cv, widx, seg, hkv = _window_case(rng, w)
    for layer in range(2):
        ref = j_window(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(seg),
                       jnp.int32(layer), jnp.asarray(widx), num_kv_heads=hkv, block_k=128,
                       interpret=True)
        out = tdec.decode_attention_stacked_window(_t(q), _t(ck), _t(cv), _t(seg), layer,
                                                   _t(widx), num_kv_heads=hkv)
        assert out.shape == q.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("w", [5, 16])
def test_k11_plain_matches_pallas(rng, w):
    """K11 (`_fused_heads_window_q8_kernel`, interpret mode) over a cache
    quantized by the JAX package: 3e-2, as tests/test_window_decode.py (the
    TPU kernel rounds p * vs to bf16 before its PV product, the port keeps
    it in f32)."""
    q, ck, cv, widx, seg, hkv = _window_case(rng, w)
    (kq, ks), (vq, vs) = (j_quantize_kv(jnp.asarray(x), hkv) for x in (ck, cv))
    for layer in range(2):
        ref = j_window_q8(jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(seg), jnp.int32(layer),
                          jnp.asarray(widx), num_kv_heads=hkv, block_k=128, interpret=True)
        out = tdec.decode_attention_stacked_window_q8(
            _t(q), _t(np.asarray(kq)), _t(np.asarray(vq)), _t(np.asarray(ks)),
            _t(np.asarray(vs)), _t(seg), layer, _t(widx), num_kv_heads=hkv)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("quantized", [False, True], ids=["k10", "k11"])
def test_window_plain_rows_equal_single_query_plain(rng, quantized):
    """Row j of a window is the single-query function (K9 / K4) over the
    keys row j sees; an empty slot gives 0; stale, even non-finite, scales
    above the window leave the result as it is."""
    from radvlm_tpu_torch.ops import kv_quant as tkv

    w = 4
    q, ck, cv, widx, seg, hkv = _window_case(rng, w)
    seg[0] = 0  # slot 0 sees nothing
    q, seg_t, widx_t = _t(q), _t(seg), _t(widx)
    if quantized:
        (kq, ks), (vq, vs) = tkv.quantize_kv(_t(ck), hkv), tkv.quantize_kv(_t(cv), hkv)
        for i in range(3):
            ks[1, i, :, widx[i] + w:] = float("nan")
            vs[1, i, :, widx[i] + w:] = float("inf")
        out = tdec.decode_attention_stacked_window_q8(q, kq, vq, ks, vs, seg_t, 1, widx_t,
                                                      num_kv_heads=hkv)
    else:
        out = tdec.decode_attention_stacked_window(q, _t(ck), _t(cv), seg_t, 1, widx_t,
                                                   num_kv_heads=hkv)
    assert torch.isfinite(out).all() and torch.all(out[0] == 0)
    ar = torch.arange(seg.shape[1])[None]
    for j in range(w):
        seg_j = torch.where(ar <= widx_t[:, None] + j, seg_t, torch.zeros_like(seg_t))
        if quantized:
            # the single-query plain version multiplies p = 0 by the scale:
            # give it finite scales above the window
            one = tdec.decode_attention_stacked_q8(
                q[:, j], kq, vq, torch.nan_to_num(ks, nan=1.0), torch.nan_to_num(vs, posinf=1.0),
                seg_j, 1, num_kv_heads=hkv)
        else:
            one = tdec.decode_attention_stacked(q[:, j], _t(ck), _t(cv), seg_j, 1,
                                                num_kv_heads=hkv)
        np.testing.assert_allclose(out[:, j].numpy(), one.numpy(), atol=1e-6, rtol=1e-6)


def test_window_wrappers_raise_off_cpu_without_a_kernel():
    """On a tensor that is not on the CPU the window wrappers check their
    inputs and go for the kernel: no fallback to the plain version."""
    meta = torch.device("meta")
    q = torch.empty((2, 4, 4, 64), device=meta, dtype=torch.bfloat16)
    ck = torch.empty((1, 2, 128, 2 * 64), device=meta, dtype=torch.bfloat16)
    seg = torch.empty((2, 128), device=meta, dtype=torch.int32)
    widx = torch.empty((2,), device=meta, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_stacked_window(q, ck, ck, seg, 0, widx, num_kv_heads=2)
    with pytest.raises(ValueError, match="window of 2..16"):
        tdec.decode_attention_stacked_window(q[:, :1], ck, ck, seg, 0, widx, num_kv_heads=2)
    with pytest.raises(ValueError, match="int32"):
        tdec.decode_attention_stacked_window(q, ck, ck, seg, 0, widx.long(), num_kv_heads=2)
    i8, f32 = ck.to(torch.int8), torch.empty((1, 2, 2, 128), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention_stacked_window_q8(q, i8, i8, f32, f32, seg, 0, widx, num_kv_heads=2)
    with pytest.raises(ValueError, match="scales"):
        tdec.decode_attention_stacked_window_q8(q, i8, i8, f32[..., :5], f32[..., :5], seg, 0,
                                                widx, num_kv_heads=2)
    assert set(kernels.launch_counts().values()) == {0}
