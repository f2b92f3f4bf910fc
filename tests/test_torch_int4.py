"""The port's int4 (W4A16) path and its fused W8A8 matmul against the JAX
package at small sizes.

The same numpy inputs go through the JAX function and its port. The tiny
preset's widths (48, 32) do not divide by 128, so the int4 tests widen it
(text hidden 128 / intermediate 256, tower hidden 128; the tower's
intermediate stays 64, so its `fc2` stays int8 as the SO400M tower's does).
The Pallas kernels run in interpret mode, as the JAX package's own tests run
them; on CPU tensors the port's wrappers run their plain versions (the CUDA
kernels are held against those on the card by chip_smoke.py and
tests/test_torch_cuda.py).

Tolerances, with their reasons:
- packing, the int4 quantizer and its inverse: bit for bit (inputs include
  quotients on exact .5 ties, which both round half to even, and a group of
  zeros, whose scale clamps);
- K12's plain version rounds each weight to x's dtype after its scale and
  sums in f32, as the Pallas kernel does, in another order: f32 within
  1e-4 / 1e-4, bf16 within 2^-7 of the row's largest value (one ulp of the
  single final rounding);
- K13's plain version (`quantize_rows`, then exact sums) equals the Pallas
  fused kernel bit for bit;
- model logits: 1e-4 where both sides compute the same f32 products (the
  int4 layers are dequantized to f32 on both sides), as
  tests/test_torch_int8.py; greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import int4_matmul as j4
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu.ops.w8a8_matmul import w8a8_matmul_fused as j_fused
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert, radvlm, siglip
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.models.layers import Linear, Q4Linear, QLinear
from radvlm_tpu_torch.ops import int4_matmul as t4
from radvlm_tpu_torch.ops import quant as tq
from radvlm_tpu_torch.ops import w8a8_matmul as tw8


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def wide_tiny(cfg):
    """The tiny config at widths int4 can take (contraction dims of 128 and
    256); the tower's MLP width stays 64, so its fc2 stays int8."""
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256, head_dim=32),
        vision=dataclasses.replace(cfg.vision, hidden_size=128),
    )


def _with_ties(rng, d, f, e=-4):
    """[D, F] whose groups of 128 rows have amax 7 * 2^e (scale exactly 2^e)
    and other values (k + 0.5) * 2^e: quotients on exact .5 ties. Every third
    column is normal noise; group 1 of column 1 is all zeros."""
    x = (rng.integers(-7, 7, (d, f)) + 0.5) * 2.0 ** e
    x[::128] = 7 * 2.0 ** e * rng.choice([-1, 1], (d // 128, f))
    x[:, ::3] = rng.normal(size=x[:, ::3].shape)
    x[128:256, 1] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def wide_q4():
    """The widened tiny config, its f32 params and their JAX
    `quantize_params(bits=4)` tree."""
    cfg = wide_tiny(cfglib.tiny_test_config(vocab_size=300))
    params = jrad.init_params(cfg, jax.random.key(0))
    return cfg, _np_tree(params), _np_tree(jquant.quantize_params(params, bits=4))


# ------------------------------------------------------------- the quantizer


@pytest.mark.parametrize("shape", [(256, 40), (3, 128, 16), (2, 2, 384, 8)])
def test_pack_unpack_bit_exact(rng, shape):
    vals = rng.integers(-8, 8, shape).astype(np.int8)
    jp = j4.pack_int4(jnp.asarray(vals))
    tp = t4.pack_int4(_t(vals))
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t4.unpack_int4(tp).numpy(), np.asarray(j4.unpack_int4(jp)))
    np.testing.assert_array_equal(t4.unpack_int4(tp).numpy(), vals)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_quantize_array_int4_bit_exact(rng, dtype, lead):
    x = np.stack([_with_ties(rng, 384, 24) for _ in range(int(np.prod(lead, dtype=int)))])
    x = x.reshape(*lead, 384, 24)
    jx = jnp.asarray(x).astype(dtype)
    node = j4.quantize_array_int4(jx)
    packed, scale = t4.quantize_array_int4(_t(x).to(getattr(torch, dtype)))
    grouped = np.asarray(jx, np.float32).reshape(*lead, 3, 128, 24)
    ties = np.mod(grouped / np.asarray(node["__scale__"])[..., None, :], 1.0) == 0.5
    assert ties.sum() > 1000  # the inputs do land on ties
    assert float(np.asarray(node["__scale__"]).min()) == np.float32(1e-12)  # the zero group
    np.testing.assert_array_equal(packed.numpy(), np.asarray(node["__q4__"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(node["__scale__"]))
    for out in ("float32", "bfloat16"):
        back = t4.dequantize_array_int4(packed, scale, getattr(torch, out))
        ref = j4.dequantize_array_int4(node, getattr(jnp, out))
        np.testing.assert_array_equal(back.float().numpy(), np.asarray(ref, np.float32))


def test_port_layout_repacks_without_loss(rng):
    """JAX packed bytes -> the port's [out, in/2] layout -> back: the same
    bytes; and the port's quantizer on a torch weight [out, in] equals the
    JAX one on its transpose, value for value."""
    w = _with_ties(rng, 256, 40)  # [in, out]
    node = j4.quantize_array_int4(jnp.asarray(w))
    packed = _t(node["__q4__"])
    mine = t4.repack_from_concat(packed)
    assert mine.dtype == torch.uint8 and mine.shape == (40, 128)
    np.testing.assert_array_equal(t4.repack_to_concat(mine).numpy(), np.asarray(node["__q4__"]))
    np.testing.assert_array_equal(t4.unpack_rows(mine).numpy(),
                                  np.asarray(j4.unpack_int4(node["__q4__"])).T)
    weight, scale = t4.quantize_weight_int4(_t(w.T))
    assert torch.equal(weight, mine)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(node["__scale__"]))
    np.testing.assert_array_equal(
        t4.dequantize_weight_int4(weight, scale, torch.float32).numpy(),
        np.asarray(j4.dequantize_array_int4(node, jnp.float32)).T)
    with pytest.raises(ValueError, match="128"):
        t4.quantize_weight_int4(torch.zeros(8, 96))


# ------------------------------------------------------------------ K12, K13


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 40, 64])
def test_int4_matmul_plain_matches_pallas_interpret(rng, rows, dtype):
    layers, d, f = 2, 256, 256
    w = jnp.asarray(rng.normal(size=(layers, d, f), scale=0.05), jnp.float32)
    node = j4.quantize_array_int4(w)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j4.int4_matmul_stacked(jx, node["__q4__"], node["__scale__"], 1,
                                             interpret=True), np.float32)
    weight = t4.repack_from_concat(_t(node["__q4__"][1]))
    tx = _t(x).to(getattr(torch, dtype))
    got = t4.int4_matmul(tx, weight, _t(node["__scale__"][1]))  # the plain version on the CPU
    assert got.dtype == tx.dtype and got.shape == (rows, f)
    assert torch.equal(got, t4.int4_matmul_plain(tx, weight, _t(node["__scale__"][1])))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        bound = 2.0 ** -7 * np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("case", [(96, 256, 384), (200, 512, 256)])
def test_w8a8_fused_plain_bit_exact(rng, case):
    m, d, f = case
    x = rng.normal(size=(m, d), scale=1.3).astype(np.float32)
    x[m // 2] = 0.0  # a row of zeros: amax clamps, y = 0
    w = jnp.asarray(rng.normal(size=(d, f), scale=0.05), jnp.float32)
    node = jquant.quantize_array(w, reduce_axes=(-2,))
    want = j_fused(jnp.asarray(x, jnp.bfloat16), node["__q__"], node["__scale__"].reshape(1, -1),
                   block_m=64, block_f=128, block_k=128, interpret=True)
    tx = _t(x).to(torch.bfloat16)
    wq, ws = _t(node["__q__"]).t().contiguous(), _t(node["__scale__"]).reshape(-1)
    got = tw8.w8a8_matmul_fused(tx, wq, ws)  # the plain version on the CPU
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    xq, xs = tw8.quantize_rows(tx)
    assert torch.equal(got, tw8.w8a8_matmul_plain(xq, xs[:, 0], wq, ws, torch.bfloat16))
    assert torch.all(got[m // 2] == 0) and torch.isfinite(got.float()).all()


def test_qmm_goes_through_the_fused_matmul_when_asked(rng, monkeypatch):
    lin = QLinear(_t(rng.integers(-128, 128, (24, 64)).astype(np.int8)),
                  torch.full((24,), 1e-3))
    x = _t(rng.normal(size=(70, 64)).astype(np.float32))
    calls = []
    real = tq.w8a8_matmul_fused
    monkeypatch.setattr(tq, "w8a8_matmul_fused", lambda *a: calls.append(1) or real(*a))
    ref = lin(x)
    assert not calls and tq.w8a8_impl_name() == "kernel"
    for name in ("xla", "pallas"):  # the port has no XLA emitter: both mean K3
        monkeypatch.setenv("RADVLM_W8A8_IMPL", name)
        assert tq.w8a8_impl_name() == "kernel"
    monkeypatch.setenv("RADVLM_W8A8_IMPL", "fused")
    assert tq.w8a8_impl_name() == "fused"
    assert torch.equal(lin(x), ref) and len(calls) == 1
    lin(x[:64])  # 64 rows: K5/K6, not W8A8
    lin(x, w8a8=False)  # the lm_head's call: dequant
    assert len(calls) == 1
    monkeypatch.setenv("RADVLM_W8A8_IMPL", "cublas")
    with pytest.raises(ValueError, match="RADVLM_W8A8_IMPL"):
        tq.w8a8_impl_name()


# ------------------------------------------------------- modules and bridge


def test_quantize_model_picks_the_jax_split(wide_q4):
    """`quantize_model(bits=4)` on the port's f32 model equals the bridge of
    `quantize_params(bits=4)` leaf by leaf: int4 where the contraction dim
    divides by 128, int8 for the tower's fc2 (D = 64), the lm_head and the
    embedding, dense elsewhere; payloads and scales equal."""
    cfg, params, qparams = wide_q4
    mine = tq.quantize_model(convert.radvlm_from_jax(params, cfg, device="cpu"), bits=4)
    theirs = convert.radvlm_from_jax(qparams, cfg, device="cpu")
    kinds = {n: type(m) for n, m in theirs.named_modules()
             if isinstance(m, (Linear, QLinear, Q4Linear))}
    assert kinds == {n: type(m) for n, m in mine.named_modules()
                     if isinstance(m, (Linear, QLinear, Q4Linear))}
    assert kinds["text.layers.0.down"] is Q4Linear and kinds["vision_tower.layers.1.fc1"] is Q4Linear
    assert kinds["vision_tower.layers.0.fc2"] is QLinear and kinds["text.lm_head"] is QLinear
    assert kinds["projector.fcs.0"] is Linear and kinds["vision_tower.patch_embed"] is Linear
    sa, sb = mine.state_dict(), theirs.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    assert mine.text.embed.dtype == torch.int8
    assert tq.quantized_bytes(mine) == sum(v.numel() * v.element_size() for v in sa.values())
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_model(mine, bits=2)


def test_fuse_linears_over_q4_equals_bridge_of_fused_tree(rng, wide_q4):
    """The JAX `fuse_projections` concatenates an int4 node's packed bytes
    and group scales along the output axis; `fuse_linears` over `Q4Linear`s
    gives the bridge of that tree. (The JAX package fuses int4 nodes in the
    decoder only, so the tower is fused on the port's side alone and held to
    its own unfused forward.)"""
    cfg, _, qparams = wide_q4
    fused_tree = _np_tree(jrad.fuse_for_inference(qparams))  # the decoder
    a = convert.radvlm_from_jax(fused_tree, cfg, device="cpu")
    b = radvlm.fuse_for_inference(convert.radvlm_from_jax(qparams, cfg, device="cpu"))
    assert isinstance(a.text.layers[0].qkv, Q4Linear) and isinstance(b.text.layers[1].gateup, Q4Linear)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    pixels = _t(rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    unfused = siglip.forward(b.vision_tower, cfg.vision, pixels)
    radvlm.fuse_for_inference(b, cfg)
    assert isinstance(b.vision_tower.layers[0].qkv, Q4Linear)
    np.testing.assert_allclose(siglip.forward(b.vision_tower, cfg.vision, pixels).numpy(),
                               unfused.numpy(), atol=1e-5, rtol=1e-5)


def test_inverse_bridge_gives_the_jax_tree_back(wide_q4):
    cfg, _, qparams = wide_q4
    model = convert.radvlm_from_jax(qparams, cfg, device="cpu")
    back = convert.radvlm_to_tree(model)
    want = jax.tree_util.tree_flatten_with_path(qparams)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        b = b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), path
    with pytest.raises(ValueError, match="unfused"):
        convert.radvlm_to_tree(radvlm.fuse_for_inference(model, cfg))


def test_random_quantized_params_int4_is_seeded_and_born_packed(wide_q4):
    cfg = wide_q4[0]
    a, b = (convert.random_quantized_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                                            dtype=torch.float32, bits=4) for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    qkv = a.text.layers[0].qkv
    assert isinstance(qkv, Q4Linear) and qkv.weight.dtype == torch.uint8
    assert int(t4.unpack_rows(qkv.weight).min()) == -8 and int(t4.unpack_rows(qkv.weight).max()) == 7
    assert qkv.scale.shape == (1, 256) and torch.all(qkv.scale == np.float32(0.02 / 7))
    fc2 = a.vision_tower.layers[0].fc2
    assert isinstance(fc2, QLinear) and torch.all(fc2.scale == np.float32(0.02 / 127))
    assert isinstance(a.text.lm_head, QLinear) and a.text.embed.dtype == torch.int8
    unfused = convert.random_quantized_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                                              dtype=torch.float32, bits=4, fuse=False)
    assert isinstance(unfused.text.layers[0].q, Q4Linear) and not hasattr(unfused.text.layers[0], "qkv")
    ref = convert.dequantized_copy(a, cfg)
    assert not any(isinstance(m, (QLinear, Q4Linear)) for m in ref.modules())
    np.testing.assert_array_equal(
        ref.text.layers[0].qkv.weight.numpy(),
        t4.dequantize_weight_int4(qkv.weight, qkv.scale, torch.float32).numpy())


# ----------------------------------------------------------------- the slice


def _samples(mm, cfg):
    out = []
    for n in (6, 11, 8, 14):
        r = np.random.default_rng(n)
        img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
        ids = [int(t) for t in r.integers(3, cfg.text.vocab_size, size=n)]
        out.append(mm.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg))
    return out


def test_int4_prefill_logits_and_greedy_tokens_match_jax(rng, wide_q4):
    """The int4 model through `radvlm.forward` and the static generate
    function: prefill logits within 1e-4 (int4 layers dequantized to f32 on
    both sides; fc2 and the tower W8A8: the same exact integer sums), greedy
    tokens identical."""
    cfg, _, qparams = wide_q4
    fused = _np_tree(jrad.fuse_for_inference(qparams))  # the JAX package fuses the decoder
    model = convert.radvlm_from_jax(fused, cfg, device="cpu")
    tok = lambda s: [2 + b for b in s.encode()]  # noqa: E731
    img = rng.integers(0, 255, (90, 70, 3), dtype=np.uint8)
    batch = jmm.collate([jmm.build_sample(jmm.tokenize_with_images(tok, "<image>\nsome text"),
                                          [img], cfg)], pad_to_multiple=32, left_pad=True)
    ref, _ = jrad.forward(fused, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          attn_impl="xla")
    out, _ = radvlm.forward(model, cfg, {k: _t(v) for k, v in batch.items()})
    real = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], atol=1e-4, rtol=1e-4)
    jgen = jeng.make_generate_fn(cfg, jeng.GenerationConfig(max_new_tokens=6), attn_impl="xla")
    want = jgen(fused, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    tgen = teng.make_generate_fn(cfg, teng.GenerationConfig(max_new_tokens=6))
    got = tgen(model, {k: _t(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("kv_quant", [True, False])
def test_int4_batcher_tokens_identical_to_jax(wide_q4, kv_quant, spec_k):
    cfg, _, qparams = wide_q4
    engine = dict(num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2,
                  steps_per_sync=4, pipeline_depth=2, kv_quant=kv_quant, spec_k=spec_k)
    new = 7
    tb = TBatcher(convert.radvlm_from_jax(qparams, cfg, device="cpu"), cfg,
                  teng.GenerationConfig(max_new_tokens=new), **engine)
    reqs = [tb.submit(s) for s in _samples(tmm, cfg)]
    list(tb.run())
    got = [list(r.emitted) for r in reqs]
    jb = JBatcher(qparams, cfg, jeng.GenerationConfig(max_new_tokens=new), attn_impl="xla",
                  **engine)
    jreqs = [jb.submit(s) for s in _samples(jmm, cfg)]
    list(jb.run())
    assert got == [list(r.emitted) for r in jreqs]
    assert all(len(e) == new for e in got)
    prov = tb.kernel_provenance()
    assert (prov["decode_matmul"], prov["prefill_matmul"], prov["decode_lm_head"]) == (
        "int4", "dequant", "int8")


def test_kernel_provenance_names_the_int4_route_and_the_w8a8_impl(monkeypatch):
    cfg = cfglib.radvlm_7b()
    kw = dict(prompt_len=4096, max_new_tokens=128, quantized=True, cache_format="int8",
              fill_rows=2, tiles=5, decode_rows=8)
    q4 = teng.kernel_provenance(cfg, weight_bits=4, spec_k=4, **kw)
    assert (q4["tower_matmul"], q4["prefill_matmul"]) == ("dequant", "dequant")
    assert q4["tower_matmul_int8"] == "w8a8"  # fc2: D = 4304 does not divide by 128
    assert (q4["decode_matmul"], q4["verify_matmul"]) == ("int4", "int4")  # 8 and 40 rows
    assert {q4[k] for k in ("fill_lm_head", "decode_lm_head", "verify_lm_head")} == {"int8"}
    assert q4["w8a8_impl"] == "kernel"
    wide = teng.kernel_provenance(cfg, weight_bits=4, spec_k=15, **kw)  # 128 rows a verify step
    assert (wide["verify_matmul"], wide["verify_lm_head"]) == ("dequant", "dequant")
    q8 = teng.kernel_provenance(cfg, **kw)
    assert q8["prefill_matmul"] == "w8a8" and q8["w8a8_impl"] == "kernel"
    assert "tower_matmul_int8" not in q8
    monkeypatch.setenv("RADVLM_W8A8_IMPL", "fused")
    assert teng.kernel_provenance(cfg, **kw)["w8a8_impl"] == "fused"
    monkeypatch.setenv("RADVLM_W8A8", "0")
    off = teng.kernel_provenance(cfg, **kw)
    assert off["prefill_matmul"] == "dequant" and off["w8a8_impl"] == "off"
    assert "w8a8_impl" not in teng.kernel_provenance(cfg, prompt_len=4096, max_new_tokens=128)
    assert (tq.qmm_route(64, bits=4), tq.qmm_route(65, bits=4), tq.qmm_route(65, True, bits=4)) == (
        "int4", "dequant", "dequant")
