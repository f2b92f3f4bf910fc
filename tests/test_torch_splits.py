"""The split plans of the port's decode kernels, on the CPU.

`int8_matmul._splits` (K5/K6) and `int4_matmul._splits` (K12) cut the work
into 64-column blocks x K splits (K12's in whole 128-k scale groups);
`decode_attention._split_plan` (K9 / K4 and their windows K10 /
K11) cuts the cache into key chunks. Each plan takes the card's SM count,
covers K (or S) in whole steps of the kernel, and depends on the weight's
(or the cache's) shape only: a row's sums must not depend on how many rows
(K5/K6, K12) or window queries (K10 / K11) come with it, or greedy speculative
tokens stop being plain greedy tokens. The wrappers are driven here on meta
tensors with a stand-in for the kernel library, which records the plan each
launch would get.
"""

import types

import pytest
import torch

from radvlm_tpu_torch import kernels
from radvlm_tpu_torch.ops import decode_attention as tdec
from radvlm_tpu_torch.ops import int4_matmul as ti4
from radvlm_tpu_torch.ops import int8_matmul as ti8

# (label, K, N): the Qwen2-7B decode projections of a fused layer and the lm_head.
K5_SHAPES = [("qkv", 3584, 4608), ("o", 3584, 3584), ("gateup", 3584, 37888),
             ("down", 18944, 3584), ("lm_head", 3584, 152064)]
# Shapes of tests/test_torch_cuda.py: an odd N, K no multiple of 64, small K.
K5_EDGE_SHAPES = [("odd", 112, 131), ("narrow", 48, 3), ("0.5b", 4864, 896)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("shape", K5_SHAPES + K5_EDGE_SHAPES, ids=lambda s: s[0])
def test_k5_plan_covers_k_in_whole_steps(shape, sms):
    """Every block's K splits are whole 64-wide steps that cover K once,
    and a split is one CTA of a cluster (at most 8)."""
    _, k, n = shape
    nsplit, per = ti8._splits(n, k, sms)
    assert 1 <= nsplit <= 8 and per % 64 == 0
    ranges = [(r * per, min(k, (r + 1) * per)) for r in range(nsplit)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_k5_plan_units_at_132_sms():
    """The grid of the five main-path shapes on an H100 (132 SMs): work
    units (64-column blocks x K splits). Fewer blocks than SMs: K split in
    two while the units fit the SMs at once (o, down; qkv's 72 blocks do
    not fit twice); more: persistent CTAs walk whole blocks (gateup 4-5 a
    CTA, lm_head 18)."""
    plans = {label: ti8._splits(n, k, 132) for label, k, n in K5_SHAPES}
    assert plans == {"qkv": (1, 3584), "o": (2, 1792), "gateup": (1, 3584),
                     "down": (2, 9472), "lm_head": (1, 3584)}
    units = {label: -(-n // 64) * plans[label][0] for label, k, n in K5_SHAPES}
    assert units == {"qkv": 72, "o": 112, "gateup": 592, "down": 112, "lm_head": 2376}


# K12 at the four decode projections of a fused Qwen2-7B layer (the lm_head
# stays int8), and the edge shapes of tests/test_torch_cuda.py's K12_CASES:
# one group and an odd N, two groups and N = 3, the 0.5B down projection.
K12_SHAPES = K5_SHAPES[:4]
K12_EDGE_SHAPES = [("one_group", 128, 131), ("narrow", 256, 3), ("0.5b", 4864, 896)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("shape", K12_SHAPES + K12_EDGE_SHAPES, ids=lambda s: s[0])
def test_k12_plan_covers_k_in_whole_groups(shape, sms):
    """Every block's K splits are whole 512-k stages of the kernel (so whole
    128-k scale groups) that cover K once, a split is one CTA of a cluster
    (at most 8), and the units fit the SMs at once wherever K is split."""
    _, k, n = shape
    nsplit, per = ti4._splits(n, k, sms)
    assert 1 <= nsplit <= 8 and per % 512 == 0 and per % ti4.GROUP == 0
    ranges = [(r * per, min(k, (r + 1) * per)) for r in range(nsplit)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi and lo % 128 == 0 for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert nsplit == 1 or -(-n // 64) * nsplit <= sms


def test_k12_plan_units_at_132_sms():
    """The grid of the four int4 shapes on an H100 (132 SMs), as K5/K6's:
    work units (64-column blocks x K splits). o and down split K in two
    (112 CTAs, clusters of two), qkv's 72 blocks do not fit twice, gateup's
    592 blocks are walked by 132 persistent CTAs (4-5 each). K = 3584 is 7
    stages (o: 4 + 3), 18944 is 37 (down: 19 + 18)."""
    plans = {label: ti4._splits(n, k, 132) for label, k, n in K12_SHAPES}
    assert plans == {"qkv": (1, 3584), "o": (2, 2048), "gateup": (1, 3584),
                     "down": (2, 9728)}
    units = {label: -(-n // 64) * plans[label][0] for label, k, n in K12_SHAPES}
    assert units == {"qkv": 72, "o": 112, "gateup": 592, "down": 112}


@pytest.fixture
def fake_lib(monkeypatch):
    """The kernel library replaced by one that records each launch's
    arguments; meta tensors pass the wrappers' device checks. The launch
    counts are restored afterwards."""
    calls = []

    def record(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    lib = types.SimpleNamespace(**{name: record(name) for name in (
        "radvlm_int8_matmul", "radvlm_int4_matmul", "radvlm_decode_attention", "radvlm_decode_attention_q8",
        "radvlm_decode_attention_window", "radvlm_decode_attention_window_q8")})
    counts = kernels.launch_counts()
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(kernels, "require_cuda_tensors", lambda *a, **kw: None)
    yield calls
    with kernels._count_lock:
        kernels._launches.update(counts)


@pytest.mark.parametrize("label,k,n", K5_SHAPES)
def test_k5_wrapper_plan_does_not_depend_on_rows(fake_lib, label, k, n):
    """1, 8, 40 and 64 rows of x against the same weight: one plan, the
    weight's, and no scratch for partials."""
    w = torch.empty((n, k), device="meta", dtype=torch.int8)
    scale = torch.empty((n,), device="meta")
    for m in (1, 8, 40, 64):
        out = ti8.int8_matmul(torch.empty((m, k), device="meta", dtype=torch.bfloat16), w, scale)
        assert out.shape == (m, n)
    plans = set()
    for name, args in fake_lib:
        assert name == "radvlm_int8_matmul"
        part, m, n_, k_, nsplit, per = args[4:10]
        assert part is None and (n_, k_) == (n, k)
        plans.add((nsplit, per))
    assert [args[5] for _, args in fake_lib] == [1, 8, 40, 64]
    assert plans == {ti8._splits(n, k, 132)}


@pytest.mark.parametrize("label,k,n", K12_SHAPES)
def test_k12_wrapper_plan_does_not_depend_on_rows(fake_lib, label, k, n):
    """1, 8, 40 and 64 rows of x against the same int4 weight: one plan, the
    weight's, and no scratch for partials (the splits meet in a cluster)."""
    w = torch.empty((n, k // 2), device="meta", dtype=torch.uint8)
    scale = torch.empty((k // 128, n), device="meta")
    for m in (1, 8, 40, 64):
        out = ti4.int4_matmul(torch.empty((m, k), device="meta", dtype=torch.bfloat16), w, scale)
        assert out.shape == (m, n)
    plans = set()
    for name, args in fake_lib:
        assert name == "radvlm_int4_matmul"
        part, m, n_, k_, nsplit, per = args[4:10]
        assert part is None and (n_, k_) == (n, k)
        plans.add((nsplit, per))
    assert [args[5] for _, args in fake_lib] == [1, 8, 40, 64]
    assert plans == {ti4._splits(n, k, 132)}


# (B, Hkv, S): the decode and verify steps of 8 slots, K9's phase-3 batch,
# Qwen2-0.5B's cache, one slot of a short cache.
DECODE_CACHES = [(8, 4, 4224), (4, 4, 4096), (2, 2, 1000), (1, 1, 77)]


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("cache", DECODE_CACHES)
def test_decode_plan_covers_s_in_whole_tiles(cache, sms):
    """The key chunks are whole 64-key tiles that cover S once, with about
    two CTAs an SM where S has the tiles for it."""
    b, hkv, s = cache
    nsplit, chunk = tdec._split_plan(b, hkv, s, sms)
    assert chunk % 64 == 0 and (nsplit - 1) * chunk < s <= nsplit * chunk
    want = -(-2 * sms // (b * hkv))
    assert nsplit <= max(1, want)
    if -(-s // 64) >= want:  # enough tiles: about two CTAs an SM
        assert nsplit * b * hkv >= 2 * sms * 0.5


def test_decode_plan_at_132_sms():
    """8 slots x 4224 keys of Qwen2-7B's 4 kv heads: 9 chunks of 512 keys,
    288 CTAs for K4 and for each window of K11."""
    assert tdec._split_plan(8, 4, 4224, 132) == (9, 512)
    assert tdec._split_plan(4, 4, 4096, 132) == (16, 256)


@pytest.mark.parametrize("quantized", [False, True], ids=["k9_k10", "k4_k11"])
def test_decode_wrappers_share_one_plan_for_every_window(fake_lib, quantized):
    """The one-query kernel and its windows of 2, 5 and 16 queries over the
    same cache get the same key chunks, so a window row sums over the chunks
    of the one-query kernel's row."""
    b, hkv, s, h, d, layers = 8, 4, 4224, 28, 128, 2
    dt = torch.int8 if quantized else torch.bfloat16
    ck = torch.empty((layers, b, s, hkv * d), device="meta", dtype=dt)
    sc = torch.empty((layers, b, hkv, s), device="meta")
    seg = torch.empty((b, s), device="meta", dtype=torch.int32)
    widx = torch.empty((b,), device="meta", dtype=torch.int32)
    q1 = torch.empty((b, h, d), device="meta", dtype=torch.bfloat16)
    if quantized:
        tdec.decode_attention_stacked_q8(q1, ck, ck, sc, sc, seg, 1, num_kv_heads=hkv)
    else:
        tdec.decode_attention_stacked(q1, ck, ck, seg, 1, num_kv_heads=hkv)
    for w in (2, 5, 16):
        qw = torch.empty((b, w, h, d), device="meta", dtype=torch.bfloat16)
        if quantized:
            out = tdec.decode_attention_stacked_window_q8(qw, ck, ck, sc, sc, seg, 1, widx,
                                                          num_kv_heads=hkv)
        else:
            out = tdec.decode_attention_stacked_window(qw, ck, ck, seg, 1, widx, num_kv_heads=hkv)
        assert out.shape == qw.shape
    assert len(fake_lib) == 4
    # (nsplit, chunk) sit just before the softmax scale and the stream.
    plans = {args[-4:-2] for _, args in fake_lib}
    assert plans == {tdec._split_plan(b, hkv, s, 132)}
