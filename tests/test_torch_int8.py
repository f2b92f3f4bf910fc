"""The port's int8 path against the JAX package at small sizes.

The same numpy inputs go through the JAX function and its port. Quantizers
are held bit for bit (inputs include values that land on exact .5 ties,
which both round half to even). The Pallas kernels run in interpret mode,
as the JAX package's own tests run them; on CPU tensors the port's kernel
wrappers run their plain versions (the CUDA kernels are held against those
on the card by chip_smoke.py and tests/test_torch_cuda.py).

Tolerances, with their reasons:
- K3's plain version (f64 sums, exact) equals the Pallas kernel and XLA's
  s8 x s8 dot (int32 sums, exact) bit for bit;
- K5/K6's plain version sums x * q in f32 and scales after; the Pallas
  kernel does the same in another order: 2e-5 relative to the output;
- K4's plain version keeps p * vs in f32 where the Pallas kernel rounds it
  to bf16 before its PV matmul: 3e-2, the JAX package's own bound
  (tests/test_kv_quant.py), on rows that have a written slot;
- model logits (f32 weights dequantized from the same int8): 1e-4 where
  both sides compute the same products in f32, looser where one side
  rounds to bf16 (stated at each test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import kv_quant as jkv
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu.ops.decode_attention import decode_attention_stacked_q8 as j_decode_q8
from radvlm_tpu.ops.int8_matmul import int8_matmul as j_i8
from radvlm_tpu.ops.int8_matmul import int8_matmul_stacked as j_i8_stacked
from radvlm_tpu.ops.w8a8_matmul import quantize_rows as j_quantize_rows
from radvlm_tpu.ops.w8a8_matmul import w8a8_matmul_pallas
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.models import convert, qwen2, radvlm
from radvlm_tpu_torch.models.layers import QLinear
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import int8_matmul as ti8
from radvlm_tpu_torch.ops import kv_quant as tkv
from radvlm_tpu_torch.ops import quant as tq
from radvlm_tpu_torch.ops import w8a8_matmul as tw8


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _with_ties(rng, shape, e=-5):
    """Rows whose largest |value| is 127 * 2^e, so every quantizer's scale
    is exactly 2^e, and whose other values are (k + 0.5) * 2^e: quotients
    on exact .5 ties (k + 0.5 has at most 8 significant bits, exact in bf16
    too). Every third row is plain normal noise instead."""
    x = (rng.integers(-127, 127, shape) + 0.5) * 2.0 ** e
    x[..., 0] = 127 * 2.0 ** e * rng.choice([-1, 1], shape[:-1])
    x[::3] = rng.normal(size=x[::3].shape)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def tiny_q():
    """The tiny config with int8 weights from the JAX `quantize_params`."""
    cfg = cfglib.tiny_test_config(vocab_size=300)
    params = jrad.init_params(cfg, jax.random.key(0))
    return cfg, _np_tree(jquant.quantize_params(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_exact(rng, dtype):
    x = _with_ties(rng, (37, 96))
    jx = jnp.asarray(x).astype(dtype)
    jq_, js = j_quantize_rows(jx)
    tq_, ts = tw8.quantize_rows(_t(x).to(getattr(torch, dtype)))
    ties = np.mod(np.asarray(jx, np.float32) / np.asarray(js), 1.0) == 0.5
    assert ties.sum() > 1000  # the inputs do land on ties
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("axis", ["kernel", "embedding"])
def test_quantize_array_bit_exact(rng, axis):
    """Kernels [in, out] reduce over in (the port's [out, in] weights over
    their last axis); embeddings [V, D] over D, one scale per row."""
    x = _with_ties(rng, (40, 72))
    if axis == "kernel":
        node = jquant.quantize_array(jnp.asarray(x.T), reduce_axes=(-2,))
        q, s = tq.quantize_array(_t(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(node["__q__"]).T)
        np.testing.assert_array_equal(s.numpy()[:, 0], np.asarray(node["__scale__"])[0])
    else:
        node = jquant.quantize_array(jnp.asarray(x), reduce_axes=(-1,))
        q, s = tq.quantize_array(_t(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(node["__q__"]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(node["__scale__"]))
    back = tq.dequantize_array(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_array(node, jnp.float32)).reshape(back.shape)
        if axis == "embedding" else np.asarray(jquant.dequantize_array(node, jnp.float32)).T)


def test_quantize_kv_bit_exact(rng):
    hkv, d = 2, 16
    x = _with_ties(rng, (3, 4, 9, hkv, d)).reshape(3, 4, 9, hkv * d)
    jq_, js = jkv.quantize_kv(jnp.asarray(x), hkv)
    tq_, ts = tkv.quantize_kv(_t(x), hkv)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.shape == (3, 4, hkv, 9) and ts.is_contiguous()
    row = x[0, :, 0]
    jr, jrs = jkv.quantize_kv_row(jnp.asarray(row), hkv)
    tr, trs = tkv.quantize_kv_row(_t(row), hkv)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq_, ts, hkv, torch.float32).numpy(),
        np.asarray(jkv.dequantize_kv(jq_, js, hkv, jnp.float32)))


@pytest.mark.parametrize("m,d,f", [(96, 256, 384), (200, 512, 256)])
def test_k3_plain_matches_pallas_and_xla(rng, m, d, f):
    """At the block sizes of tests/test_quant.py: the Pallas kernel in
    interpret mode and XLA's s8 x s8 dot, bit for bit."""
    x = jnp.asarray(rng.normal(size=(m, d), scale=1.3), jnp.bfloat16)
    node = jquant.quantize_array(jnp.asarray(rng.normal(size=(d, f), scale=0.05), jnp.float32),
                                 reduce_axes=(-2,))
    xq, xs = j_quantize_rows(x)
    pallas = w8a8_matmul_pallas(xq, xs, node["__q__"], node["__scale__"].reshape(1, -1),
                                block_m=64, block_f=128, block_k=128, interpret=True)
    xla = jquant.w8a8_matmul(x, node)
    wq, ws = _t(np.asarray(node["__q__"]).T), _t(np.asarray(node["__scale__"])[0])
    out = tw8.w8a8_matmul(_t(xq), _t(xs), wq, ws, out_dtype=torch.bfloat16)
    ref = out.float().numpy()
    np.testing.assert_array_equal(ref, np.asarray(pallas, np.float32))
    np.testing.assert_array_equal(ref, np.asarray(xla, np.float32))


def test_k3_plain_takes_a_k_tail_and_extreme_values(rng):
    """K = 4304 (the SigLIP MLP, no multiple of 32) and weights at -128:
    the plain version still equals XLA's exact s8 x s8 dot."""
    m, d, f = 9, 4304, 40
    xq = rng.integers(-127, 128, (m, d)).astype(np.int8)
    xs = rng.uniform(0.01, 0.02, (m, 1)).astype(np.float32)
    wq = rng.integers(-128, 128, (d, f)).astype(np.int8)
    wq[:, 0] = -128
    ws = rng.uniform(1e-4, 2e-4, (1, f)).astype(np.float32)
    acc = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    ref = (acc.astype(jnp.float32) * xs * ws.reshape(-1)).astype(jnp.bfloat16)
    out = tw8.w8a8_matmul(_t(xq), _t(xs), _t(wq.T), _t(ws[0]))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("rows", [1, 8, 33, 64])
def test_k5_k6_plain_matches_pallas(rng, rows):
    """The flat kernel (K6, the lm_head) and the stacked one (K5, a layer
    picked by index) in interpret mode, at 1-64 decode rows."""
    n_layers, d, f = 3, 256, 384
    node = jquant.quantize_array(
        jnp.asarray(rng.normal(size=(n_layers, d, f), scale=0.02), jnp.float32), reduce_axes=(-2,))
    x = rng.normal(size=(rows, d)).astype(np.float32)
    for li in range(n_layers):
        wq = _t(np.asarray(node["__q__"][li]).T)
        ws = _t(np.asarray(node["__scale__"][li, 0]))
        out = ti8.int8_matmul(_t(x), wq, ws).numpy()
        flat = j_i8(jnp.asarray(x), node["__q__"][li], node["__scale__"][li], block_f=128,
                    interpret=True)
        stacked = j_i8_stacked(jnp.asarray(x), node["__q__"], node["__scale__"], li,
                               block_f=128, interpret=True)
        for ref in (flat, stacked):
            ref = np.asarray(ref)
            np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


def test_k4_plain_matches_pallas(rng):
    _k4_case(rng, 8, 2, 64)


@pytest.mark.parametrize("h", [8, 2])
def test_k4_plain_matches_pallas_at_head_dim_256(rng, h):
    """Gemma-2B's head dim: h query heads over one kv head."""
    _k4_case(rng, h, 1, 256)


def _k4_case(rng, h, hkv, d):
    """Per-row write indices (each row's keys end at its own index), left
    padding, and an empty row, which is compared only for being 0: the
    Pallas kernel's finite mask value gives mean(v) there."""
    n_layers, b, s = 3, 4, 256
    kv = jnp.asarray(rng.normal(size=(n_layers, b, s, hkv * d)), jnp.float32)
    vv = jnp.asarray(rng.normal(size=(n_layers, b, s, hkv * d)), jnp.float32)
    ckq, ksc = jkv.quantize_kv(kv, hkv)
    cvq, vsc = jkv.quantize_kv(vv, hkv)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    for i, (lo, widx) in enumerate([(10, 200), (0, 97), (120, 255)]):
        seg[i, lo:widx + 1] = 1  # row 3 stays empty
    for li in range(n_layers):
        ref = j_decode_q8(jnp.asarray(q), ckq, cvq, ksc, vsc, jnp.asarray(seg), li,
                          num_kv_heads=hkv, interpret=True)
        out = tdec.decode_attention_stacked_q8(_t(q), _t(ckq), _t(cvq), _t(ksc), _t(vsc),
                                               _t(seg), li, num_kv_heads=hkv)
        np.testing.assert_allclose(out.numpy()[:3], np.asarray(ref)[:3], atol=3e-2, rtol=3e-2)
        assert torch.all(out[3] == 0)


def test_qmm_routes_as_the_jax_dispatch(rng):
    """More than 64 rows: W8A8 (equal to JAX's qmm bit for bit in f32);
    64 or fewer: weight-only; w8a8=False above 64: dequantize (the
    lm_head)."""
    node = jquant.quantize_array(jnp.asarray(rng.normal(size=(48, 40), scale=0.05), jnp.float32),
                                 reduce_axes=(-2,))
    lin = QLinear(_t(np.asarray(node["__q__"]).T), _t(np.asarray(node["__scale__"])[0]))
    assert [tq.qmm_route(r) for r in (64, 65)] == ["int8", "w8a8"]
    assert tq.qmm_route(65, False) == "dequant"
    for rows, w8a8 in ((65, None), (64, None), (80, False)):
        x = rng.normal(size=(rows, 48)).astype(np.float32)
        ref = np.asarray(jquant.qmm(jnp.asarray(x), node, w8a8=w8a8))
        out = lin(_t(x), w8a8=w8a8).numpy()
        if tq.qmm_route(rows, w8a8) == "w8a8":
            np.testing.assert_array_equal(out, ref)
        else:
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_bridge_loads_quantized_trees(rng, tiny_q, fused):
    """Fused and unfused int8 trees: QLinear projections, the int8
    embedding, and the same logits as the JAX package's radvlm.forward on
    the same int8 params (W8A8 prefill on both sides; 1e-4: the same exact
    integer sums, f32 elsewhere in another order)."""
    cfg, params = tiny_q
    if fused:
        params = _np_tree(jrad.fuse_for_inference(params, cfg))
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    blk = model.text.layers[0]
    assert isinstance(blk.qkv if fused else blk.q, QLinear)
    assert isinstance(model.text.lm_head, QLinear) and isinstance(model.vision_tower.layers[0].fc1, QLinear)
    assert model.text.embed.dtype == torch.int8 and model.text.embed_scale.shape == (300, 1)
    tok = lambda s: [2 + b for b in s.encode()]  # noqa: E731
    img = rng.integers(0, 255, (90, 70, 3), dtype=np.uint8)
    batch = jmm.collate([jmm.build_sample(jmm.tokenize_with_images(tok, "<image>\nsome text"),
                                          [img], cfg)], pad_to_multiple=32, left_pad=True)
    ref, _ = jrad.forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          attn_impl="xla")
    out, _ = radvlm.forward(model, cfg, {k: _t(v) for k, v in batch.items()})
    real = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], atol=1e-4, rtol=1e-4)


def test_bridge_quantized_equals_port_quantize_model(tiny_q):
    """`quantize_model` on the port's f32 model gives the same int8 weights
    and scales as the JAX `quantize_params` brought over by the bridge."""
    cfg, qparams = tiny_q
    params = _np_tree(jrad.init_params(cfg, jax.random.key(0)))
    mine = tq.quantize_model(convert.radvlm_from_jax(params, cfg, device="cpu"))
    theirs = convert.radvlm_from_jax(qparams, cfg, device="cpu")
    sa, sb = mine.state_dict(), theirs.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_int8_prefill_and_per_row_decode_match_jax(rng, tiny_q, monkeypatch):
    """`prefill(cache_format="int8")`: the quantized cache equals the JAX
    one on real positions; then one decode step with a per-row write index
    (rows at different cache positions). Weight-only matmuls on both sides
    (RADVLM_W8A8=0): with W8A8 an activation that lands within f32 rounding
    of a .5 tie quantizes one step apart in the two packages, which moves
    later layers' K/V by a few int8 steps at a few positions (0.2% here).
    Logits: prefill 1e-4; decode 2e-3 (the JAX XLA path reads a
    bf16-dequantized cache, the port's K4 plain version the int8 values
    times f32 scales)."""
    monkeypatch.setenv("RADVLM_W8A8", "0")
    cfg, params = tiny_q
    params = _np_tree(jrad.fuse_for_inference(params, cfg))
    tok = lambda s: [2 + b for b in s.encode()]  # noqa: E731
    imgs = [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)]
    samples = [jmm.build_sample(jmm.tokenize_with_images(tok, p), [im], cfg)
               for p, im in zip(["<image>\nhi", "a longer <image>\nprompt"], imgs)]
    batch = jmm.collate(samples, pad_to_multiple=32, left_pad=True)
    b, l = batch["tokens"].shape
    max_len = 256
    jcache, jseg, jlog = jeng.prefill(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                      max_len, cache_format="int8")
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    cache, seg, logits = teng.prefill(model, cfg, {k: _t(v) for k, v in batch.items()},
                                      max_len, cache_format="int8")
    assert len(cache) == 4 and cache[0].dtype == torch.int8 and cache[2].shape == jcache[2].shape
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    real = np.asarray(jseg) != 0  # [B, S]; padding rows' K/V differ by design
    for mine, theirs in zip(cache[:2], jcache[:2]):
        np.testing.assert_array_equal(mine.numpy()[:, real], np.asarray(theirs)[:, real])
    for mine, theirs in zip(cache[2:], jcache[2:]):  # [L, B, Hkv, S]
        np.testing.assert_allclose(mine.numpy().transpose(0, 2, 1, 3)[:, :, real],
                                   np.asarray(theirs).transpose(0, 2, 1, 3)[:, :, real],
                                   rtol=1e-5, atol=0)

    # One per-row decode step, both packages from the JAX cache.
    widx = np.array([l, l + 3], np.int32)  # row 1 decodes 3 slots further on
    cseg = np.asarray(jseg).copy()
    cseg[0, widx[0]] = 1
    cseg[1, l:widx[1] + 1] = 1
    tok_ = rng.integers(2, 300, (b,)).astype(np.int32)
    pos = (batch["lengths"] + widx - l).astype(np.int32)
    emb = jq.embed_tokens(params["text"], jnp.asarray(tok_[:, None]), cfg.text)
    ref, _ = jq.forward(params["text"], cfg.text, input_embeds=emb,
                        positions=jnp.asarray(pos[:, None]), segment_ids=jnp.ones((b, 1), jnp.int32),
                        kv_cache=tuple(jcache), cache_index=jnp.asarray(widx),
                        cache_segment_ids=jnp.asarray(cseg), attn_impl="xla")
    tcache = tuple(_t(c) for c in jcache)
    tseg = _t(cseg)
    _, _, out = teng.decode_step(model, cfg, tcache, tseg, _t(tok_).long(), _t(pos), _t(widx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, 0], atol=2e-3, rtol=2e-3)
    # The new rows were written at each row's own index, quantized.
    for i in range(b):
        assert tcache[0][:, i, widx[i]].abs().sum() > 0
        assert torch.all(tcache[2][:, i, :, widx[i]] > 0)


def test_per_row_window_is_written_and_routed():
    """A per-row window of s > 1 tokens is written at each row's own offset,
    quantized (scales [B, s, Hkv] into [L, B, Hkv, S]), and attended through
    K11's plain version on the CPU (the text head dim widened from 12 to 16,
    the smallest K11 takes; at 12 the route is plain)."""
    cfg = cfglib.tiny_test_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, head_dim=16))
    model = convert.random_quantized_params(cfg, torch.Generator().manual_seed(0),
                                            device="cpu", dtype=torch.float32)
    cache = qwen2.init_kv_cache_q8(cfg.text, 2, 128)
    x = torch.randn((2, 3, cfg.text.hidden_size), generator=torch.Generator().manual_seed(1))
    seg = torch.zeros(2, 128, dtype=torch.int32)
    seg[0, 4:7] = 1
    seg[1, 9:12] = 1
    with torch.inference_mode():
        out, _ = qwen2.forward(model.text, cfg.text, input_embeds=x,
                               positions=torch.zeros(2, 3).long(), kv_cache=cache,
                               cache_index=torch.tensor([4, 9]), cache_segment_ids=seg)
    assert out.shape == (2, 3, cfg.text.vocab_size) and torch.isfinite(out).all()
    for row, lo in ((0, 4), (1, 9)):
        written = (cache[2][:, row] > 0).all(dim=(0, 1))  # [S]: scales of every layer and head
        assert written.nonzero().flatten().tolist() == [lo, lo + 1, lo + 2]
        assert cache[0][:, row, lo:lo + 3].abs().sum() > 0
    assert qwen2.cached_attention_route(cfg.text, 128, "auto", 3, True, True) == "window_q8"


def test_per_row_window_raises():
    """What still raises is a window the kernel does not take (over 16
    tokens), on a tensor that is not on the CPU: the wrapper never falls
    back to the plain version there."""
    from radvlm_tpu_torch.ops import decode_attention as tdec

    meta = torch.device("meta")
    seg = torch.zeros(2, 128, dtype=torch.int32, device=meta)
    q = torch.empty((2, 17, 4, 16), device=meta, dtype=torch.bfloat16)
    kv = torch.empty((1, 2, 128, 2 * 16), device=meta, dtype=torch.int8)
    sc = torch.empty((1, 2, 2, 128), device=meta)
    with pytest.raises(ValueError, match="window of 2..16"):
        tdec.decode_attention_stacked_window_q8(
            q, kv, kv, sc, sc, seg, 0, torch.empty((2,), device=meta, dtype=torch.int32),
            num_kv_heads=2)


def test_random_quantized_params_is_seeded_and_born_int8():
    cfg = cfglib.tiny_test_config()
    a, b = (convert.random_quantized_params(cfg, torch.Generator().manual_seed(3),
                                            device="cpu", dtype=torch.float32) for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    qkv = a.text.layers[0].qkv
    assert qkv.weight.dtype == torch.int8 and int(qkv.weight.min()) == -128
    assert torch.all(qkv.scale == np.float32(0.02 / 127))
    assert a.text.embed.dtype == torch.int8 and torch.all(a.text.embed_scale == np.float32(0.02 / 127))
    assert isinstance(a.text.lm_head, QLinear) and isinstance(a.vision_tower.layers[1].qkv, QLinear)
    assert not isinstance(a.projector.fcs[0], QLinear)
    assert 0.015 < float(a.text.norm.std()) < 0.025  # the rest N(0, 0.02)
    ref = convert.dequantized_copy(a, cfg)
    assert not any(isinstance(m, QLinear) for m in ref.modules())
    np.testing.assert_array_equal(ref.text.layers[0].qkv.weight.numpy(),
                                  (qkv.weight.float() * qkv.scale[:, None]).numpy())


def test_int8_path_against_its_f32_reference():
    """The int8 model through the kernels' plain versions (W8A8 prefill,
    int8 cache, weight-only decode) against plain attention on an f32 copy
    of the dequantized weights, at the tiny config with the random int8
    init of the card's smoke run. chip_smoke.py bounds the 7B kernel path's
    error by the figure this measures (see PERF.md)."""
    cfg = cfglib.tiny_test_config()
    model = convert.random_quantized_params(cfg, torch.Generator().manual_seed(0),
                                            device="cpu", dtype=torch.float32)
    ref = convert.dequantized_copy(model, cfg)
    rng = np.random.default_rng(0)
    tok = lambda s: [2 + b for b in s.encode()]  # noqa: E731
    img = rng.integers(0, 255, (90, 70, 3), dtype=np.uint8)
    batch = jmm.collate([jmm.build_sample(jmm.tokenize_with_images(tok, "<image>\nAny effusion?"),
                                          [img], cfg)], pad_to_multiple=128, left_pad=True)
    batch = {k: _t(v) for k, v in batch.items()}
    l = batch["tokens"].shape[1]
    errs = []
    tok0 = None
    for m, impl, fmt in ((ref, "xla", "bf16"), (model, "auto", "int8")):
        cache, cseg, lg = teng.prefill(m, cfg, batch, 256, attn_impl=impl, cache_format=fmt)
        tok0 = lg.argmax(-1) if tok0 is None else tok0
        _, _, lg1 = teng.decode_step(m, cfg, cache, cseg, tok0, batch["lengths"], l,
                                     attn_impl=impl)
        errs.append((lg, lg1))
    for i in range(2):
        r, o = errs[0][i], errs[1][i]
        rel = float((o - r).abs().max() / r.abs().max())
        assert rel < 0.05, rel
