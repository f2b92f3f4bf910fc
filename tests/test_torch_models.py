"""Parity of the PyTorch port's models with the JAX package at tiny sizes.

JAX random-init weights go through the weight bridge (`models/convert.py`)
into the port; the same numpy inputs go through both. f32 weights; the JAX
side runs XLA on CPU, the port the plain versions of its kernels.
Tolerance 1e-4: f32 rounding in a few layers of differently ordered sums.
Where the KV cache (bf16 in both packages) is read, the JAX XLA path rounds
the normalised probabilities to bf16 before PV while the port's decode
kernel keeps them f32: 5e-4 on logits there (measured 1.8e-4 on logits of
magnitude 0.4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import projector as jproj
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.models import siglip as jsig
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch.config import radvlm_7b
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.models import convert, qwen2, radvlm, siglip
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=300)
    params = _np_tree(jrad.init_params(cfg, jax.random.key(0)))
    # Non-trivial norms and biases, so the bridge's placement is exercised.
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale")
               for k in p) else x,
        params,
    )
    return cfg, params


def _batch(rng, cfg, b=2, s=24, pad=(5, 0)):
    tokens = rng.integers(2, cfg.text.vocab_size, (b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for i, p in enumerate(pad):
        seg[i, :p] = 0
        pos[i, p:] = np.arange(s - p)
    return tokens, seg, pos


@pytest.mark.parametrize("fused", [False, True])
def test_siglip_matches_jax(rng, tiny, fused):
    cfg, params = tiny
    vt = params["vision_tower"]
    if fused:
        vt = jsig.fuse_projections(vt)
    pixels = rng.uniform(-1, 1, (3, 56, 56, 3)).astype(np.float32)
    ref = jsig.forward(vt, cfg.vision, jnp.asarray(pixels))
    tower = siglip.SigLIPTower(cfg.vision)
    convert.load_tower(tower, _np_tree(vt))
    assert hasattr(tower.layers[0], "qkv") == fused
    out = siglip.forward(tower, cfg.vision, torch.from_numpy(pixels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_siglip_patchify_matches_jax(rng):
    x = rng.normal(size=(2, 30, 44, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        siglip.patchify(torch.from_numpy(x), 14).numpy(),
        np.asarray(jsig.patchify(jnp.asarray(x), 14)),
    )


def test_projector_matches_jax(rng, tiny):
    cfg, params = tiny
    x = rng.normal(size=(2, 5, cfg.vision.hidden_size)).astype(np.float32)
    ref = jproj.forward(params["projector"], cfg.projector, jnp.asarray(x))
    model = convert.radvlm_from_jax(_np_tree(params), cfg, device="cpu")
    out = model.projector(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_qwen2_prefill_logits_and_kv_match_jax(rng, tiny, fused):
    """Left-padded prefill: logits and the collected (bf16) K/V at real
    positions. Padding rows differ by design (mean(v) in XLA, 0 in the
    kernel) and nothing attends them."""
    cfg, params = tiny
    tp = jq.fuse_projections(params["text"]) if fused else params["text"]
    tokens, seg, pos = _batch(rng, cfg)
    emb = jq.embed_tokens(tp, jnp.asarray(tokens), cfg.text)
    ref, (rk, rv) = jq.forward(tp, cfg.text, input_embeds=emb, positions=jnp.asarray(pos),
                               segment_ids=jnp.asarray(seg), collect_kv=True)
    model = qwen2.Qwen2Decoder(cfg.text)
    convert.load_qwen2(model, _np_tree(tp))
    t_emb = qwen2.embed_tokens(model, torch.from_numpy(tokens), cfg.text)
    out, (k, v) = qwen2.forward(model, cfg.text, input_embeds=t_emb,
                                positions=torch.from_numpy(pos),
                                segment_ids=torch.from_numpy(seg), collect_kv=True)
    real = seg != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)
    assert k.dtype == torch.bfloat16 and k.shape == rk.shape
    # bf16 cache entries: equal up to one bf16 rounding of f32 values that
    # agree to ~1e-6.
    for a, r in ((k, rk), (v, rv)):
        np.testing.assert_allclose(a.float().numpy()[:, real],
                                   np.asarray(r, np.float32)[:, real],
                                   atol=1e-5, rtol=2 ** -7)


def test_qwen2_cached_decode_step_matches_jax(rng, tiny):
    """One decode step against a prefilled bf16 cache (K9's plain version
    in the port, XLA attention in JAX)."""
    cfg, params = tiny
    tp = jq.fuse_projections(params["text"])
    tokens, seg, pos = _batch(rng, cfg)
    b, l = tokens.shape
    max_len = 128
    emb = jq.embed_tokens(tp, jnp.asarray(tokens), cfg.text)
    _, (rk, rv) = jq.forward(tp, cfg.text, input_embeds=emb, positions=jnp.asarray(pos),
                             segment_ids=jnp.asarray(seg), collect_kv=True)
    ck, cv = jq.init_kv_cache(cfg.text, b, max_len)
    ck = ck.at[:, :, :l].set(rk)
    cv = cv.at[:, :, :l].set(rv)
    cache_seg = np.zeros((b, max_len), np.int32)
    cache_seg[:, :l] = seg
    cache_seg[:, l] = 1
    tok = rng.integers(2, cfg.text.vocab_size, (b,)).astype(np.int32)
    dpos = pos[:, -1] + 1
    ref, _ = jq.forward(tp, cfg.text, input_embeds=jq.embed_tokens(tp, jnp.asarray(tok[:, None])),
                        positions=jnp.asarray(dpos[:, None]), segment_ids=jnp.ones((b, 1), jnp.int32),
                        kv_cache=(ck, cv), cache_index=jnp.int32(l),
                        cache_segment_ids=jnp.asarray(cache_seg))

    model = qwen2.Qwen2Decoder(cfg.text)
    convert.load_qwen2(model, _np_tree(tp))
    assert qwen2.decode_kernel_eligible(cfg.text, max_len, "auto")
    tck = torch.from_numpy(np.asarray(ck, np.float32)).to(torch.bfloat16)
    tcv = torch.from_numpy(np.asarray(cv, np.float32)).to(torch.bfloat16)
    out, cache = qwen2.forward(
        model, cfg.text, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(tok[:, None])),
        positions=torch.from_numpy(dpos[:, None]), segment_ids=torch.ones(b, 1, dtype=torch.int32),
        kv_cache=(tck, tcv), cache_index=l, cache_segment_ids=torch.from_numpy(cache_seg))
    assert cache[0] is tck  # written in place
    assert tck[:, :, l].abs().sum() > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4, rtol=1e-3)


def test_radvlm_forward_matches_jax(rng, tiny):
    """Tower + projector + merge + splice + decoder on a collated batch."""
    from radvlm_tpu.models import multimodal as jmm

    cfg, params = tiny
    tok = lambda s: [2 + b for b in s.encode()]
    imgs = [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)]
    samples = [jmm.build_sample(jmm.tokenize_with_images(tok, p), [im], cfg)
               for p, im in zip(["<image>\nhi", "a longer <image>\nprompt"], imgs)]
    batch = jmm.collate(samples, pad_to_multiple=32, left_pad=True)
    ref, _ = jrad.forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.radvlm_from_jax(_np_tree(params), cfg, device="cpu")
    out, _ = radvlm.forward(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    real = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)


def test_fused_bridge_equals_unfused(tiny):
    cfg, params = tiny
    a = convert.radvlm_from_jax(_np_tree(jrad.fuse_for_inference(params, cfg)), cfg,
                                device="cpu")
    b = radvlm.fuse_for_inference(convert.radvlm_from_jax(_np_tree(params), cfg, device="cpu"), cfg)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_bridge_rejects_quantized_leaves(tiny):
    """An int4 node whose contraction dim does not divide by 128 is refused:
    `quantize_params(bits=4)` keeps such a kernel int8, so no tree holds one
    (int4 nodes that do divide load: tests/test_torch_int4.py; int8 nodes:
    tests/test_torch_int8.py)."""
    cfg, params = tiny
    text = dict(_np_tree(params["text"]))
    text["lm_head"] = {"kernel": {"__q4__": np.zeros((24, 300), np.int8),
                                  "__scale__": np.ones((1, 300), np.float32)}}
    with pytest.raises(ValueError, match="multiple of 128"):
        convert.load_qwen2(qwen2.Qwen2Decoder(cfg.text), text)


def test_init_params_is_seeded(tiny):
    cfg, _ = tiny
    a = convert.init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                            dtype=torch.float32)
    b = convert.init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                            dtype=torch.float32)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb) and torch.isfinite(pa).all(), name
    assert torch.all(a.text.norm == 1) and torch.all(a.text.layers[0].q.bias == 0)
    assert 0.015 < float(a.text.embed.std()) < 0.025


@pytest.mark.parametrize("name", ["radvlm_7b", "radvlm_0_5b", "tiny_test_config"])
def test_tile_grid_helpers_match_jax(name):
    """The port's jax-free `tokens_per_tile` and `feature_grid_side` give
    what the JAX config's properties give (through the jax resampler)."""
    from radvlm_tpu_torch import config as tcfg

    cfg = getattr(cfglib, name)()
    assert tcfg.tokens_per_tile(cfg) == cfg.tokens_per_tile
    assert tcfg.feature_grid_side(cfg) == cfg.feature_grid_side


def test_kernel_provenance_reports_the_predicates():
    cfg = radvlm_7b()
    prov = teng.kernel_provenance(cfg, prompt_len=3584, max_new_tokens=32)
    assert prov["tower_attention"] == prov["prefill_attention"] == "kernel"
    assert prov["decode_attention"] == "kernel"
    assert set(prov["launches"]) == {"tower_attention", "prefill_attention", "decode_attention",
                                     "w8a8_matmul", "decode_attention_q8", "int8_matmul",
                                     "decode_attention_window", "decode_attention_window_q8",
                                     "int4_matmul", "w8a8_matmul_fused", "prefill_attention_lse",
                                     "flash_attention_bwd_dkv", "flash_attention_bwd_dq"}
    plain = teng.kernel_provenance(cfg, prompt_len=3584, max_new_tokens=32, attn_impl="xla")
    assert {plain[k] for k in ("tower_attention", "prefill_attention", "decode_attention")} == {"plain"}
    # A continuous engine's decode chunks: CUDA-graph replays on the card,
    # the same body uncaptured on the CPU (`generation/graphs.chunk_route`).
    assert prov["decode_chunk"] == "graph"
    assert teng.kernel_provenance(cfg, prompt_len=3584, max_new_tokens=32,
                                  device="cpu")["decode_chunk"] == "eager: cpu"
    # The int8 serving path: W8A8 fills and tower, weight-only decode and
    # lm_head, the q8 decode kernel.
    q8 = teng.kernel_provenance(cfg, prompt_len=3584, max_new_tokens=128, quantized=True,
                                cache_format="int8", fill_rows=2, decode_rows=8)
    assert q8["decode_attention"] == "kernel_q8"
    assert (q8["tower_matmul"], q8["prefill_matmul"]) == ("w8a8", "w8a8")
    assert {q8[k] for k in ("fill_lm_head", "decode_matmul", "decode_lm_head")} == {"int8"}
    # A tied embedding (radvlm_0_5b) unembeds through its dequantized rows.
    tied = cfglib.radvlm_0_5b()
    assert tied.text.tie_word_embeddings
    q8 = teng.kernel_provenance(tied, prompt_len=3584, max_new_tokens=128, quantized=True,
                                decode_rows=8)
    assert (q8["fill_lm_head"], q8["decode_lm_head"], q8["decode_matmul"]) == (
        "dequant", "dequant", "int8")
    assert prov["resampler_attention"] == plain["resampler_attention"] == "none"
    assert prov["train_attention"] == "kernel_lse" and plain["train_attention"] == "plain"
    # Gemma-2B (head_dim 256, 8 query heads over 1 kv head) behind the same
    # tower: the D = 256 kernels serve prefill, decode and verify on both
    # caches, and under a gradient K2 with the lse and K7 / K8.
    gemma = dataclasses.replace(cfg, text=tcfg.gemma_2b())
    for fmt, suffix in (("bf16", ""), ("int8", "_q8")):
        g = teng.kernel_provenance(gemma, prompt_len=3584, max_new_tokens=128, quantized=True,
                                   cache_format=fmt, decode_rows=8, spec_k=4)
        assert (g["prefill_attention"], g["decode_attention"], g["verify_attention"]) == (
            "kernel", "kernel" + suffix, "window" + suffix)
        assert g["train_attention"] == "kernel_lse"
    # The tower is judged at its own sequence length, class token included
    # and before the resampler: CLIP-L/14-336 577 tokens at D = 64 (x 14
    # crops under S2), ImageBind 257 at D = 80 though it hands on one token,
    # SigLIP's 729 under a Q-Former that hands on 32 (plain einsums).
    from radvlm_tpu_torch.config import ResamplerConfig
    from radvlm_tpu_torch.models import towers

    clip_cfg = towers.with_tower(cfg, "openai/clip-vit-large-patch14-336", s2=True,
                                 s2_scales=(336, 672, 1008))
    imagebind = towers.with_tower(cfg, "imagebind_huge")
    qformer = dataclasses.replace(cfg, resampler=ResamplerConfig(kind="qformer"),
                                  image_aspect_ratio="pad")
    assert [towers.sequence_length(c.vision) for c in (clip_cfg, imagebind, qformer)] == [
        577, 257, 729]
    assert towers.passes_per_tile(clip_cfg.vision) == 14
    for c, resampled in ((clip_cfg, "none"), (imagebind, "none"), (qformer, "plain")):
        p = teng.kernel_provenance(c, prompt_len=3584, max_new_tokens=32, quantized=True)
        assert (p["tower_attention"], p["resampler_attention"]) == ("kernel", resampled)
        assert p["tower_matmul"] == "w8a8"
        p = teng.kernel_provenance(c, prompt_len=3584, max_new_tokens=32, tower_grad=True)
        assert p["tower_attention"] == "kernel_lse"
    # One tile of ImageBind is 257 rows in the tower (K3), one of its tokens
    # reaches the decoder.
    one = teng.kernel_provenance(imagebind, prompt_len=64, max_new_tokens=8, quantized=True)
    assert one["tower_matmul"] == "w8a8"
    # A tensor-parallel rank routes at its local shapes (parallel/tp.py):
    # Qwen2-7B at tp 2 (14 q heads, 2 kv heads, intermediate 9472) and at
    # tp 4 (7, 1 and 4736 = 37 x 128); the kernels take both.
    from radvlm_tpu_torch.parallel.tp import local_text_cfg

    for deg, heads in ((2, (14, 2, 9472)), (4, (7, 1, 4736))):
        local = dataclasses.replace(cfg, text=local_text_cfg(cfg.text, deg))
        t = local.text
        assert (t.num_heads, t.num_kv_heads, t.intermediate_size) == heads
        p = teng.kernel_provenance(local, prompt_len=3584, max_new_tokens=128, quantized=True,
                                   cache_format="int8", fill_rows=2, decode_rows=8, spec_k=3)
        assert (p["prefill_attention"], p["decode_attention"], p["verify_attention"]) == (
            "kernel", "kernel_q8", "window_q8")
        assert (p["prefill_matmul"], p["decode_matmul"], p["verify_matmul"]) == (
            "w8a8", "int8", "int8")
        p = teng.kernel_provenance(local, prompt_len=3584, max_new_tokens=128, decode_rows=8)
        assert (p["tower_attention"], p["decode_attention"]) == ("kernel", "kernel")


def _widened(head_dim: int, num_heads: int = 4, num_kv_heads: int = 2):
    """The port's tiny config with the tower's and the decoder's heads
    `head_dim` wide (the tower: 2 heads)."""
    cfg = tcfg.tiny_test_config()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, hidden_size=2 * head_dim),
        text=dataclasses.replace(cfg.text, head_dim=head_dim, num_heads=num_heads,
                                 num_kv_heads=num_kv_heads))


# (head_dim, query heads, kv heads) -> (flash kernels, bf16-cache decode
# kernels, int8-cache decode kernels): what the wrappers take on the card.
ROUTE_CASES = {
    (64, 4, 2): (True, True, True),
    (128, 4, 2): (True, True, True),
    (72, 4, 2): (True, True, False),  # the int8-cache kernels want a multiple of 16
    (256, 4, 2): (True, True, True),  # Gemma's head dim: the D = 256 instances
    (320, 4, 2): (False, False, False),  # above 256: every kernel refuses it
    (128, 16, 1): (True, False, False),  # a GQA group of 16: the decode kernels take 8
}


@pytest.mark.parametrize("case", list(ROUTE_CASES), ids=lambda c: "d{}_h{}_kv{}".format(*c))
def test_routes_hold_exactly_what_the_kernels_take(case):
    """The dispatch predicates send a call to a kernel only where its wrapper
    launches it on a CUDA tensor (no raise on the card), and to the plain
    path otherwise; `kernel_provenance` reports the same routes for the
    tower, prefill, decode and verify stages, without a card."""
    flash, decode, decode_q8 = ROUTE_CASES[case]
    d, h, hkv = case
    cfg = _widened(d, h, hkv)
    meta = torch.device("meta")
    q = torch.empty((1, 64, h, d), device=meta)
    kv = torch.empty((1, 64, hkv, d), device=meta)
    assert tatt.flash_eligible(q, kv) is flash
    assert tfa.kernel_takes(d) is flash
    assert qwen2.decode_kernel_eligible(cfg.text, 128, "auto") is decode
    assert qwen2.decode_kernel_eligible(cfg.text, 128, "auto", quantized=True) is decode_q8
    assert tdec.kernel_takes(d, h, hkv, False) is decode
    assert tdec.kernel_takes(d, h, hkv, True) is decode_q8
    for fmt, kernel in (("bf16", decode), ("int8", decode_q8)):
        prov = teng.kernel_provenance(cfg, prompt_len=96, max_new_tokens=16, cache_format=fmt,
                                      decode_rows=8, spec_k=4)
        suffix = "_q8" if fmt == "int8" else ""
        assert prov["tower_attention"] == ("kernel" if flash else "plain")
        assert prov["prefill_attention"] == ("kernel" if flash else "plain")
        assert prov["decode_attention"] == ("kernel" + suffix if kernel else "plain")
        assert prov["verify_attention"] == ("window" + suffix if kernel else "plain")


# (head_dim, query heads, kv heads) -> the route under a gradient, where
# the backward kernels K7 / K8 read K2's lse: they take head dims up to 256.
GRAD_ROUTE_CASES = {
    (128, 4, 2): True,
    (72, 4, 2): True,
    (256, 4, 2): True,  # Gemma's head dim: the D = 256 instances of K7 / K8
    (256, 8, 1): True,
    (320, 4, 2): False,  # above 256: no kernel takes it, forward or backward
}


@pytest.mark.parametrize("case", list(GRAD_ROUTE_CASES), ids=lambda c: "d{}_h{}_kv{}".format(*c))
def test_routes_under_a_gradient_hold_what_the_backward_kernels_take(case):
    """Under a gradient the kernel route is K2 with the lse and K7 / K8
    backward, whose head dims stop at 256, the forward kernels' own limit:
    `flash_eligible`, `kernel_takes` and `kernel_provenance`'s tower and
    train routes name the plain route above it, and `mha` on tensors that
    need a gradient takes the plain (autograd) path there and
    `_FlashAttention` up to it."""
    kernel = GRAD_ROUTE_CASES[case]
    d, h, hkv = case
    meta = torch.device("meta")
    q = torch.empty((1, 64, h, d), device=meta)
    kv = torch.empty((1, 64, hkv, d), device=meta)
    assert tatt.flash_eligible(q, kv) is kernel
    assert tfa.kernel_takes(d) is kernel
    prov = teng.kernel_provenance(_widened(d, h, hkv), prompt_len=96, max_new_tokens=16,
                                  tower_grad=True)
    route = "kernel_lse" if kernel else "plain"
    assert prov["train_attention"] == prov["tower_attention"] == route
    assert prov["prefill_attention"] == ("kernel" if tfa.kernel_takes(d) else "plain")
    gen = torch.Generator().manual_seed(3)
    qg = torch.randn((1, 64, h, d), generator=gen).requires_grad_(True)
    k, v = (torch.randn((1, 64, hkv, d), generator=gen) for _ in range(2))
    out = tatt.mha(qg, k, v, causal=True)
    assert ("_FlashAttention" in type(out.grad_fn).__name__) is kernel
    with torch.no_grad():  # no gradient: K2 (its plain version on the CPU)
        ref = tatt.mha(qg, k, v, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_head_dim_256_decoder_runs_the_plain_routes():
    """A tiny decoder with Gemma's head dim of 256 prefills and decodes (bf16
    and int8 cache) through the kernel routes, K2 and K9 / K4, whose
    wrappers run their plain versions on the CPU: the same logits as a full
    forward. (The name is older than the D = 256 kernels, when the
    predicates sent this decoder to plain attention.)"""
    cfg = _widened(256).text
    model = convert.init_params(_widened(256), torch.Generator().manual_seed(0), device="cpu",
                                dtype=torch.float32).text
    tokens = torch.randint(2, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    seg = torch.ones((2, 9), dtype=torch.int32)
    pos = torch.arange(9)[None].repeat(2, 1)
    full, _ = qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(model, tokens, cfg),
                            positions=pos, segment_ids=seg)
    for cache in (qwen2.init_kv_cache(cfg, 2, 32, dtype=torch.float32, device="cpu"),
                  qwen2.init_kv_cache_q8(cfg, 2, 32, device="cpu")):
        cseg = torch.zeros((2, 32), dtype=torch.int32)
        cseg[:, :9] = 1
        with torch.inference_mode():
            qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(model, tokens[:, :8], cfg),
                          positions=pos[:, :8], segment_ids=seg[:, :8], kv_cache=cache,
                          cache_index=0, cache_segment_ids=cseg)
            step, _ = qwen2.forward(
                model, cfg, input_embeds=qwen2.embed_tokens(model, tokens[:, 8:], cfg),
                positions=pos[:, 8:], segment_ids=seg[:, 8:], kv_cache=cache,
                cache_index=torch.tensor([8, 8]), cache_segment_ids=cseg)
        quantized = len(cache) == 4
        assert qwen2.cached_attention_route(cfg, 32, "auto", 1, True, quantized) == (
            "kernel_q8" if quantized else "kernel")
        # The int8 cache quantizes K / V per token and head: 3e-2, as in
        # tests/test_torch_int8.py; the f32 cache only reorders f32 sums.
        tol = 3e-2 if quantized else 1e-5
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].detach().numpy(),
                                   atol=tol, rtol=tol)


def test_engine_prefill_cache_layout_matches_jax(rng, tiny):
    """`prefill`: the cache is [L, B, max_len, Hkv*D] bf16 with the prompt's
    K/V spliced at the front and zero after; cache_seg extends the prompt's
    segment ids with zeros."""
    from radvlm_tpu.models import multimodal as jmm

    cfg, params = tiny
    tok = lambda s: [2 + b for b in s.encode()]
    img = rng.integers(0, 255, (80, 64, 3), dtype=np.uint8)
    batch = jmm.collate([jmm.build_sample(jmm.tokenize_with_images(tok, "<image>\nx"), [img], cfg)],
                        pad_to_multiple=32, left_pad=True)
    (rk, _), rseg, rlog = jeng.prefill(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, 128)
    model = convert.radvlm_from_jax(_np_tree(params), cfg, device="cpu")
    (k, _), seg, logits = teng.prefill(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, 128)
    assert k.shape == rk.shape and k.dtype == torch.bfloat16
    np.testing.assert_array_equal(seg.numpy(), np.asarray(rseg))
    real = np.asarray(rseg) != 0
    np.testing.assert_allclose(k.float().numpy()[:, real], np.asarray(rk, np.float32)[:, real],
                               atol=1e-5, rtol=2 ** -7)
    assert torch.all(k[:, :, batch["tokens"].shape[1]:] == 0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlog), **TOL)
