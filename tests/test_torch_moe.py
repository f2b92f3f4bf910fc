"""MoE decoders in the port against the JAX package: the Qwen2-MoE layout
(the JAX tests/test_moe.py TINY, with a shared expert) and a tiny Mixtral
(no shared expert, renormalised top-2, a sliding window of 16 under a
24-token prompt). Weights are the JAX package's init, moved across by
`models/convert.py`; inputs come from numpy with a seed.

- forward logits in f32, exact mode and capacity mode at factors 1.25 and
  0.5 (the second drops tokens): atol / rtol 1e-5;
- `loss_fn` with `router_aux_coef > 0`: the loss and `moe_aux` at 1e-5
  relative, every gradient at atol 3e-5 / rtol 1e-4 against `jax.grad`;
- cached decode over the bf16 and the int8 cache, step by step, against
  the full forward of the same tokens: atol 2e-2 / 5e-3 of the logits'
  scale (one bf16, or int8, rounding of each cached K/V);
- `quantize_model` of an MoE model equal bit for bit to `quantize_params`
  (attention, lm_head and embedding int8; router, experts and shared
  expert dense), and `fuse_projections` leaving the MoE MLP alone;
- greedy tokens of a tiny MoE `RadVLM` through `ContinuousBatcher` (int8
  weights, the int8 cache, `RADVLM_W8A8=0`) equal the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import IMAGE_TOKEN_INDEX, Qwen2Config
from radvlm_tpu.generation import engine as jeng
from radvlm_tpu.generation.continuous import ContinuousBatcher as JBatcher
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import qwen2 as jq
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch.eval.harness import batch_to_device
from radvlm_tpu_torch.generation import engine as teng
from radvlm_tpu_torch.generation.continuous import ContinuousBatcher as TBatcher
from radvlm_tpu_torch.models import convert, qwen2, radvlm
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.models.layers import Linear, QLinear
from radvlm_tpu_torch.ops.quant import quantize_model

QWEN2_MOE = Qwen2Config(
    vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, rope_theta=10000.0, tie_word_embeddings=False,
    max_position_embeddings=512, num_experts=4, num_experts_per_tok=2,
    moe_intermediate_size=48, shared_expert_intermediate_size=56, norm_topk_prob=True,
)
MIXTRAL = Qwen2Config(
    vocab_size=128, hidden_size=32, intermediate_size=48, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=False,
    tie_word_embeddings=False, max_position_embeddings=512, sliding_window=16, num_experts=4,
    num_experts_per_tok=2, moe_intermediate_size=48, shared_expert_intermediate_size=0,
    norm_topk_prob=True,
)
CONFIGS = {"qwen2_moe": QWEN2_MOE, "mixtral": MIXTRAL}
TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(params, seed=1):
    """Norms and biases off their init values, so their use is checked."""
    noise = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "ln1", "ln2", "norm", "scale") for k in p)
        else x,
        params,
    )


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tiny models' small ops: several test
    workers share the cores, and PyTorch's thread pools contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def decoder(request):
    cfg = CONFIGS[request.param]
    params = _noisy(_np_tree(jq.init_params(cfg, jax.random.key(0))))
    model = qwen2.Qwen2Decoder(cfg)
    convert.load_qwen2(model, params)
    return request.param, cfg, params, model


def _ids(seed=0, b=2, s=24):
    ids = np.random.default_rng(seed).integers(0, 128, (b, s))
    return ids, np.tile(np.arange(s)[None], (b, 1)), np.ones((b, s), np.int32)


def _jax_logits(params, cfg, ids, pos, seg):
    out, _ = jq.forward(params, cfg, input_embeds=jq.embed_tokens(params, jnp.asarray(ids), cfg),
                        positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
                        attn_impl="xla")
    return np.asarray(out)


def _port_logits(model, cfg, ids, pos, seg):
    out, _ = qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(
        model, torch.from_numpy(ids), cfg), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg), attn_impl="xla")
    return out.numpy()


@pytest.mark.parametrize("factor", [0.0, 1.25, 0.5])
def test_moe_logits_match_jax(decoder, factor):
    """Exact mode, and capacity dispatch with room for every pick (1.25) and
    with half of them dropped (0.5), which must change the logits."""
    _, cfg, params, model = decoder
    cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    ids, pos, seg = _ids()
    ref = _jax_logits(params, cfg, ids, pos, seg)
    got = _port_logits(model, cfg, ids, pos, seg)
    np.testing.assert_allclose(got, ref, **TOL)
    if factor == 0.5:
        exact = _port_logits(model, dataclasses.replace(cfg, moe_capacity_factor=0.0),
                             ids, pos, seg)
        assert np.abs(exact - got).max() > 1e-3


def test_shared_expert_is_the_layout(decoder):
    name, cfg, params, model = decoder
    moe = model.layers[0].moe
    shared = "shared" in params["layers"]["mlp"]["moe"]
    assert (moe.shared is not None) == (name == "qwen2_moe") == shared
    assert tuple(moe.gate.shape) == (cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size)
    assert tuple(moe.down.shape) == (cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size)


def _tiny_moe(name, vocab=300):
    base = cfglib.tiny_test_config(vocab_size=vocab)
    c = CONFIGS[name]
    moe = {f: getattr(c, f) for f in ("num_experts", "num_experts_per_tok",
                                      "moe_intermediate_size",
                                      "shared_expert_intermediate_size", "norm_topk_prob")}
    return dataclasses.replace(base, text=dataclasses.replace(base.text, **moe,
                                                              router_aux_coef=0.05))


def _grad_tree(model):
    saved = {n: p.data for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.data = p.grad if p.grad is not None else torch.zeros_like(p)
    tree = convert.radvlm_to_tree(model)
    for n, p in model.named_parameters():
        p.data = saved[n]
    return tree


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _train_batch(cfg):
    out = []
    for mod in (jmm, tmm):
        rows = []
        for i in range(2):
            r = np.random.default_rng(i)
            img = r.integers(0, 255, (70, 90, 3), dtype=np.uint8)
            ids = [int(t) for t in r.integers(2, 300, 5 + i)] + [-200] + \
                  [int(t) for t in r.integers(2, 300, 6)]
            rows.append(mod.build_sample(ids, [img], cfg, labels=[-100] * (6 + i) + ids[6 + i:]))
        out.append(mod.collate(rows, pad_to_multiple=128))
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k
    return out[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_router_loss_and_gradients_match_jax(name):
    """`loss_fn` of a tiny MoE RadVLM with router_aux_coef 0.05: the loss,
    `moe_aux` (1e-5 relative) and the gradient of every leaf (atol 3e-5,
    rtol 1e-4, the tolerance of tests/test_torch_train.py) against
    `jax.value_and_grad` of the JAX `loss_fn`, both on plain attention."""
    cfg = _tiny_moe(name)
    params = _noisy(_np_tree(jrad.init_params(cfg, jax.random.key(3))))
    batch = _train_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jrad.loss_fn(p, cfg, jbatch, remat=False, attn_impl="xla"), has_aux=True)(params)
    model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    for p in model.parameters():
        p.requires_grad_(True)
    # Plain attention on both sides: the router loss counts every position,
    # padding too, and a padding row's attention output is the XLA path's.
    tl, tm = radvlm.loss_fn(model, cfg, batch_to_device(batch, "cpu"), remat=True,
                            attn_impl="xla")
    tl.backward()
    assert set(tm) == set(jm) == {"loss", "tokens", "moe_aux"}
    np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["moe_aux"]) > 0
    got, want = _leaves(_grad_tree(model)), _leaves(jg)
    assert got.keys() == want.keys()
    router = [k for k in want if "router" in k]
    assert router and all(np.abs(want[k]).max() > 0 for k in router)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cached_decode_matches_full_forward(decoder, kv):
    """Prefill of 8 tokens, then 16 cached steps of one token, each step's
    logits against the full forward's at that position (Mixtral's window
    of 16 is crossed). The bf16 cache holds the prompt's collected K/V; the
    int8 one quantizes every token per (token, kv head)."""
    _, cfg, params, model = decoder
    ids, pos, seg = _ids(seed=5, b=1, s=24)
    full = _port_logits(model, cfg, ids, pos, seg)
    np.testing.assert_allclose(full, _jax_logits(params, cfg, ids, pos, seg), **TOL)
    max_len, n0 = 32, 8
    if kv == "int8":
        cache = qwen2.init_kv_cache_q8(cfg, 1, max_len)
    else:
        cache = qwen2.init_kv_cache(cfg, 1, max_len)
    cache_seg = torch.zeros(1, max_len, dtype=torch.int32)
    cache_seg[:, :n0] = 1
    qwen2.forward(model, cfg, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(ids[:, :n0]),
                  cfg), positions=torch.from_numpy(pos[:, :n0]),
                  segment_ids=torch.from_numpy(seg[:, :n0]), kv_cache=cache, cache_index=0,
                  cache_segment_ids=cache_seg)
    scale = np.abs(full).max()
    for i in range(n0, ids.shape[1]):
        cache_seg[:, i] = 1
        out, _ = qwen2.forward(
            model, cfg, input_embeds=qwen2.embed_tokens(model, torch.from_numpy(ids[:, i:i + 1]),
                                                        cfg),
            positions=torch.tensor([[i]]), segment_ids=torch.ones(1, 1, dtype=torch.int32),
            kv_cache=cache, cache_index=torch.tensor([i]), cache_segment_ids=cache_seg)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, i], atol=2e-2 * scale,
                                   rtol=5e-3)


def test_quantize_and_fuse_leave_the_experts_dense(decoder):
    """`quantize_model` of the port's MoE RadVLM equals the JAX
    `quantize_params` of the same tree bit for bit: the attention, the
    lm_head and the embedding int8; the router, the expert tables and the
    shared expert dense. Fusing joins q / k / v and leaves the MoE MLP."""
    name, _, _, _ = decoder
    cfg = _tiny_moe(name)
    params = _np_tree(jrad.init_params(cfg, jax.random.key(4)))
    want = _leaves(_np_tree(jquant.quantize_params(params)))
    model = quantize_model(convert.radvlm_from_jax(params, cfg, device="cpu"))
    got = _leaves(convert.radvlm_to_tree(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    moe = model.text.layers[0].moe
    assert isinstance(model.text.layers[0].q, QLinear) and isinstance(moe.router, Linear)
    assert moe.gate.dtype == torch.float32
    fused = jq.fuse_projections(jquant.quantize_params(params)["text"])
    radvlm.fuse_for_inference(model, cfg)
    blk = model.text.layers[0]
    assert hasattr(blk, "qkv") and not hasattr(blk, "gateup") and blk.moe is moe
    assert set(fused["layers"]["mlp"]) == {"moe"} and "qkv" in fused["layers"]["attn"]


def _samples(mod, cfg):
    out = []
    for n in (6, 11, 8):
        r = np.random.default_rng(n)
        img = r.integers(0, 255, size=(90, 70, 3), dtype=np.uint8)
        ids = list(r.integers(3, cfg.text.vocab_size, size=n))
        out.append(mod.build_sample(ids[:2] + [IMAGE_TOKEN_INDEX] + ids[2:], [img], cfg))
    return out


ENGINE = dict(num_slots=2, max_len=256, prompt_buckets=(128,), pad_tiles=2, steps_per_sync=4,
              pipeline_depth=2)


def test_engine_tokens_identical_to_jax(monkeypatch):
    """Greedy tokens of a tiny MoE RadVLM (Qwen2-MoE layout, int8 weights by
    the JAX `quantize_params`) through the port's `ContinuousBatcher` and
    the JAX one, 3 requests over 2 slots, the int8 cache, exact mode, with
    RADVLM_W8A8=0 (W8A8 turns f32-level differences into int8 flips)."""
    monkeypatch.setenv("RADVLM_W8A8", "0")
    cfg = _tiny_moe("qwen2_moe", vocab=512)
    params = _np_tree(jquant.quantize_params(jrad.init_params(cfg, jax.random.key(7))))
    gen = dict(max_new_tokens=6)
    tb = TBatcher(convert.radvlm_from_jax(params, cfg, device="cpu"), cfg,
                  teng.GenerationConfig(**gen), kv_quant=True, **ENGINE)
    treqs = [tb.submit(s) for s in _samples(tmm, cfg)]
    tdone = {r.uid: r.emitted for r in tb.run()}
    jb = JBatcher(params, cfg, jeng.GenerationConfig(**gen), attn_impl="xla", kv_quant=True,
                  **ENGINE)
    jreqs = [jb.submit(s) for s in _samples(jmm, cfg)]
    jdone = {r.uid: r.emitted for r in jb.run()}
    got, want = [tdone[r.uid] for r in treqs], [jdone[r.uid] for r in jreqs]
    assert got == want and all(len(e) == 6 for e in got)


MPT_FIELDS = dict(attention_bias=False, tie_word_embeddings=True, hidden_act="gelu",
                  pos_embedding="alibi", norm_kind="layernorm", mlp_gated=False)


@pytest.mark.parametrize("name", ["qwen2_moe", "mpt"])
def test_quantized_artifact_carries_experts_and_mpt(tmp_path, name):
    """A model born int8 (`random_quantized_params`, unfused) with an MoE
    or an MPT decoder: `save_quantized` -> `load_quantized` gives every
    tensor back bit for bit, the JAX package's `load_quantized` reads the
    same tree (the experts dense, MPT's tied embedding int8), and
    `dequantized_copy` holds the dense leaves unchanged."""
    from radvlm_tpu.models import quant_io as jqio
    from radvlm_tpu_torch.models import quant_io

    if name == "mpt":
        base = cfglib.tiny_test_config()
        cfg = dataclasses.replace(base, text=dataclasses.replace(
            base.text, num_kv_heads=base.text.num_heads, **MPT_FIELDS))
    else:
        cfg = _tiny_moe(name, vocab=512)
    model = convert.random_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                            fuse=False)
    quant_io.save_quantized(model, cfg, str(tmp_path))
    loaded, loaded_cfg = quant_io.load_quantized(str(tmp_path), device="cpu")
    assert dataclasses.asdict(loaded_cfg) == dataclasses.asdict(cfg)
    mine = dict(loaded.named_parameters())
    for n, p in model.named_parameters():
        assert p.dtype == mine[n].dtype and torch.equal(p, mine[n]), n
    tree, _ = jqio.load_quantized(str(tmp_path))
    want = _leaves(jax.tree.map(lambda x: np.asarray(x, np.float32) if x.dtype != np.int8
                                else np.asarray(x), tree))
    got = {k: v.astype(np.float32) if v.dtype != np.int8 else v
           for k, v in _leaves(jax.tree.map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16
                                            else t.numpy(), convert.radvlm_to_tree(model))).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref = convert.dequantized_copy(model, cfg)
    blk, rblk = model.text.layers[0], ref.text.layers[0]
    if name == "mpt":
        assert model.text.embed.dtype == torch.int8 and not hasattr(blk, "gate")
        assert torch.equal(rblk.up.weight, (blk.up.weight.float() * blk.up.scale[:, None]))
    else:
        assert blk.moe.gate.dtype == torch.bfloat16
        assert torch.equal(rblk.moe.gate, blk.moe.gate.float())
