"""The port's attention under a gradient against the JAX package's kernels.

The same numpy arrays go through `radvlm_tpu.ops.flash_attention`
(`flash_attention`, `flash_attention_with_lse` under `jax.grad`, the Pallas
kernels in interpret mode, as tests/test_flash_attention.py runs them) and
through the port's `_FlashAttention` Function, which on CPU tensors runs the
plain forward and `attention_backward_plain`: the hand-written backward
formulas that the CUDA kernels K7 / K8 repeat. f32 throughout; tolerance
atol = rtol = 3e-5, the JAX package's own for its backward
(tests/test_flash_attention.py): f32 sums in another order, and the JAX
forward folds the scale into q before the dot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu.ops import flash_attention as jfa
from radvlm_tpu_torch.ops import attention as tatt
from radvlm_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=3e-5, rtol=3e-5)

# (name, B, Sq, Sk, H, Hkv, D, causal, segments)
CASES = [
    ("causal_pad_gqa1", 2, 128, 128, 2, 2, 64, True, "pad"),
    ("causal_pad_gqa2", 1, 256, 256, 4, 2, 64, True, "pad"),
    ("causal_packed_gqa7", 1, 128, 128, 7, 1, 64, True, "packed"),
    ("causal_packed_gqa2", 2, 256, 256, 4, 2, 64, True, "packed"),
    ("sk_longer", 2, 128, 256, 2, 2, 64, True, "cache"),
    ("ragged_nomask", 1, 100, 100, 2, 2, 64, False, None),
    ("causal_nomask", 1, 128, 128, 2, 1, 64, True, None),
    ("tower", 2, 729, 729, 2, 2, 72, False, None),
    ("noncausal_packed", 1, 128, 128, 4, 2, 64, False, "packed"),
    # Gemma-2B's head dim (the D = 256 instances of K7 / K8): MQA 8:1 packed
    # as its training rows are, and GQA 4:2 left-padded.
    ("d256_causal_packed_mqa8", 1, 128, 128, 8, 1, 256, True, "packed"),
    ("d256_causal_pad_gqa2", 1, 128, 128, 4, 2, 256, True, "pad"),
]
IDS = [c[0] for c in CASES]


def _inputs(case):
    _, b, sq, sk, h, hkv, d, causal, segs = case
    rng = np.random.default_rng(11)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    wl = rng.normal(size=(b, h, sq)).astype(np.float32)
    qseg = kseg = None
    if segs is not None:
        qseg = np.ones((b, sq), np.int32)
        if segs == "packed":
            qseg[:, sq // 3:] = 2
            qseg[0, -17:] = 0  # right padding
        else:
            qseg[0, :sq // 3 + 5] = 0  # left padding: rows that attend nothing
        kseg = np.zeros((b, sk), np.int32)
        kseg[:, :sq] = qseg
    return q, k, v, w, wl, qseg, kseg, causal


def _jax_run(case, with_lse):
    q, k, v, w, wl, qseg, kseg, causal = _inputs(case)
    kw = dict(causal=causal, block_q=128, block_k=128, interpret=True)
    if qseg is not None:
        kw.update(q_segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg))

    def loss(q, k, v):
        if not with_lse:
            o = jfa.flash_attention(q, k, v, **kw)
            return jnp.sum(o * w), (o, None)
        o, lse = jfa.flash_attention_with_lse(q, k, v, **kw)
        fin = jnp.isfinite(lse)
        return jnp.sum(o * w) + jnp.sum(jnp.where(fin, lse, 0.0) * wl), (o, lse)

    (_, (o, lse)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), None if lse is None else np.asarray(lse), [np.asarray(g) for g in grads]


def _torch_run(case, with_lse):
    q, k, v, w, wl, qseg, kseg, causal = _inputs(case)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kw = dict(causal=causal)
    if qseg is not None:
        kw.update(q_segment_ids=torch.from_numpy(qseg), kv_segment_ids=torch.from_numpy(kseg))
    if with_lse:
        o, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
        fin = torch.isfinite(lse)
        loss = (o * torch.from_numpy(w)).sum() + (
            torch.where(fin, lse, torch.zeros_like(lse)) * torch.from_numpy(wl)).sum()
    else:
        o, lse = tfa.flash_attention(q, k, v, **kw), None
        loss = (o * torch.from_numpy(w)).sum()
    assert type(o.grad_fn).__name__ != "NoneType"
    grads = torch.autograd.grad(loss, (q, k, v))
    return (o.detach().numpy(), None if lse is None else lse.detach().numpy(),
            [g.numpy() for g in grads])


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_lse"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_and_gradients_match_jax(case, with_lse):
    """o, lse and dq / dk / dv of the port equal the JAX kernels' (a
    non-zero lse cotangent in the `o_lse` variant), rows that attend nothing
    give o = 0, lse = -inf and finite gradients in both."""
    jo, jlse, jg = _jax_run(case, with_lse)
    to, tlse, tg = _torch_run(case, with_lse)
    np.testing.assert_allclose(to, jo, **TOL)
    if with_lse:
        fin = np.isfinite(jlse)
        assert np.array_equal(fin, np.isfinite(tlse))
        assert np.all(tlse[~fin] == -np.inf)
        np.testing.assert_allclose(tlse[fin], jlse[fin], **TOL)
    qseg = _inputs(case)[5]
    if qseg is not None and (qseg == 0).any():
        assert np.all(to[qseg == 0] == 0)
        if with_lse:
            assert np.all(np.isinf(tlse.transpose(0, 2, 1)[qseg == 0]))
    for name, a, b in zip("qkv", tg, jg):
        assert np.isfinite(a).all(), f"d{name} not finite"
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "tower"],
                         ids=[i for i in IDS if i != "tower"])
def test_backward_plain_matches_autograd(case):
    """`attention_backward_plain` (formulas written out) against
    `torch.autograd` through `mha_reference`, with the loss taken on the
    rows that attend something (the reference averages v on the others)."""
    q, k, v, w, _, qseg, kseg, causal = _inputs(case)
    scale = q.shape[-1] ** -0.5
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    qs = torch.from_numpy(qseg) if qseg is not None else torch.ones((q.shape[0], sq),
                                                                    dtype=torch.int32)
    ks = torch.from_numpy(kseg) if kseg is not None else torch.ones((q.shape[0], sk),
                                                                    dtype=torch.int32)
    mask = tatt.make_attention_mask(qs, ks, causal)
    live = (qs != 0)[:, :, None, None].float()
    do = torch.from_numpy(w) * live
    ref = torch.autograd.grad((tatt.mha_reference(tq, tk, tv, mask=mask) * do).sum(),
                              (tq, tk, tv))
    seg_args = (None, None) if qseg is None else (qs, ks)
    with torch.no_grad():
        o, lse = tfa.attention_plain(tq, tk, tv, *seg_args, causal, scale, with_lse=True)
        got = tfa.attention_backward_plain(tq, tk, tv, *seg_args, o, lse, do, None, causal, scale)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"d{name}", **TOL)


def test_wrappers_on_cpu_take_the_plain_backward():
    """The K7 / K8 wrappers on CPU tensors give `attention_backward_plain`'s
    results from a ready delta (a non-zero dlse folded in)."""
    q, k, v, w, wl, qseg, kseg, causal = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in _inputs(CASES[1]))
    scale = q.shape[-1] ** -0.5
    o, lse = tfa.prefill_attention_lse(q, k, v, q_segment_ids=qseg, kv_segment_ids=kseg,
                                       causal=causal)
    dlse = torch.where(torch.isfinite(lse), wl, torch.zeros_like(wl))
    ref = tfa.attention_backward_plain(q, k, v, qseg, kseg, o, lse, w, dlse, causal, scale)
    delta = tfa.attention_delta(o, w, dlse)
    kw = dict(q_segment_ids=qseg, kv_segment_ids=kseg, causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, w, lse, delta, **kw)
    dq = tfa.flash_attention_bwd_dq(q, k, v, w, lse, delta, **kw)
    for a, b in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_routing_under_a_gradient():
    """K1 serves a tower-shaped call only where no input needs a gradient;
    under a gradient the call goes through the Function (as the JAX
    package's `_flash_fwd` always takes `_fwd`), and `mha` follows."""
    q = torch.randn(1, 20, 2, 16)
    assert tfa.tower_eligible(q, q, None, False)
    assert not tfa.tower_eligible(q, q, None, False, needs_grad=True)
    assert tfa.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = tatt.mha(qg, q, q, causal=False)
    assert "_FlashAttention" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert tatt.mha(qg, q, q, causal=False).grad_fn is None
    # The ring route takes a gradient too (its backward is
    # tests/test_torch_ring_train.py's): here it only lacks a registered group.
    with pytest.raises(RuntimeError, match="enable_ring_attention"):
        tatt.mha(qg, q, q, causal=True, impl="ring")
    # `kernel_provenance` reads the same predicate.
    from radvlm_tpu_torch.config import tiny_test_config
    from radvlm_tpu_torch.generation.engine import kernel_provenance

    cfg = tiny_test_config()
    kw = dict(prompt_len=128, max_new_tokens=4)
    assert kernel_provenance(cfg, **kw)["tower_attention"] == "kernel"
    assert kernel_provenance(cfg, tower_grad=True, **kw)["tower_attention"] == "kernel_lse"
    assert kernel_provenance(cfg, tower_grad=True, attn_impl="xla",
                             **kw)["tower_attention"] == "plain"


def test_cuda_wrappers_refuse_cpu_free_fallbacks():
    """Only a CPU tensor takes the plain version: the wrappers decide by the
    tensor's device, not by whether a build is available."""
    import inspect

    src = inspect.getsource(tfa)
    assert "except" not in src  # no try/except around a build or a launch
    assert src.count('device.type == "cpu"') >= 5
