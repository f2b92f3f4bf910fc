"""The port's serving slice end to end against the JAX package at the tiny
config: host prep (bit for bit), `VLMRunner.generate_batch` and
`ModelWorker.generate_stream` (identical greedy tokens and text), an HTTP
round trip to the port's worker, and a run of the port with jax blocked.
"""

import base64
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.eval.harness import VLMRunner as JRunner
from radvlm_tpu.models import anyres as janyres
from radvlm_tpu.models import multimodal as jmm
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import image_ops as jimg
from radvlm_tpu.serve.worker import ModelWorker as JWorker
from radvlm_tpu_torch.eval.harness import VLMRunner as TRunner
from radvlm_tpu_torch.models import anyres as tanyres
from radvlm_tpu_torch.models import convert
from radvlm_tpu_torch.models import multimodal as tmm
from radvlm_tpu_torch.ops import image_ops as timg
from radvlm_tpu_torch.serve.worker import ModelWorker as TWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


def _images(rng):
    return [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)]


PROMPTS = ["<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n",
           "<|im_start|>user\nHello <image>\nFind the lesion in this study, "
           "please.<|im_end|>\n<|im_start|>assistant\n"]


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_test_config(vocab_size=300)
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    return cfg, params


@pytest.mark.parametrize("size", [(90, 70), (60, 130), (56, 56), (400, 35)])
def test_host_tiles_and_plans_bit_exact(rng, size):
    cfg = cfglib.tiny_test_config()
    img = rng.integers(0, 255, size + (3,), dtype=np.uint8)
    for fn in ("preprocess_anyres_host", "preprocess_single_host"):
        (jt, js), (tt, ts) = (getattr(m, fn)(img, cfg.anyres) for m in (jimg, timg))
        assert js == ts and jt.dtype == tt.dtype
        np.testing.assert_array_equal(tt, jt)
    wh = (size[1], size[0])
    jp = janyres.compute_merge_plan(wh, cfg.anyres, 4)
    tp = tanyres.compute_merge_plan(wh, cfg.anyres, 4)
    assert (jp.length, jp.num_tiles, jp.grid) == (tp.length, tp.num_tiles, tp.grid)
    for a, b in zip(janyres.batch_plans([jp, jp]), tanyres.batch_plans([tp, tp])):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("left_pad", [True, False])
def test_collate_arrays_bit_exact(rng, tiny, left_pad):
    cfg, _ = tiny
    tok = ByteTokenizer()
    imgs = _images(rng)
    batches = []
    for mm in (jmm, tmm):
        samples = [mm.build_sample(mm.tokenize_with_images(tok.encode, p), [im], cfg)
                   for p, im in zip(PROMPTS, imgs)]
        batches.append(mm.collate(samples, pad_to_multiple=64, left_pad=left_pad))
    jb, tb = batches
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_normalize_tiles_device_matches_jax(rng):
    tiles = rng.integers(0, 255, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        timg.normalize_tiles_device(torch.from_numpy(tiles)).numpy(),
        np.asarray(jimg.normalize_tiles_device(jax.numpy.asarray(tiles))),
    )


def _runners(tiny, **kw):
    cfg, params = tiny
    common = dict(cfg=cfg, tokenizer=ByteTokenizer(), max_new_tokens=16, pad_to_multiple=64, **kw)
    return (JRunner(params=params, **common),
            TRunner(model=convert.radvlm_from_jax(params, cfg, device="cpu"), **common))


def test_generate_batch_tokens_identical(rng, tiny):
    """Two left-padded multimodal prompts of different lengths, greedy."""
    jr, tr = _runners(tiny, batch_size=2)
    imgs = [[im] for im in _images(rng)]
    expected = jr.generate_batch(PROMPTS, imgs)
    got = tr.generate_batch(PROMPTS, imgs)
    assert got == expected
    assert all(len(t) > 0 for t in got)


def _b64_png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_generate_stream_text_identical(rng, tiny):
    jr, tr = _runners(tiny, batch_size=1)
    req = {"prompt": PROMPTS[1], "images": [_b64_png(_images(rng)[1])], "max_new_tokens": 12}
    expected = list(JWorker(jr, model_names=["tiny"]).generate_stream(req))
    got = list(TWorker(tr, model_names=["tiny"]).generate_stream(req))
    assert got == expected
    assert got and got[-1]["error_code"] == 0


def test_http_round_trip(rng, tiny):
    _, tr = _runners(tiny, batch_size=1)
    worker = TWorker(tr, model_names=["tiny"])
    port = worker.serve_forever(host="127.0.0.1", port=0, background=True)
    try:
        body = json.dumps({"prompt": PROMPTS[0], "images": [_b64_png(_images(rng)[0])],
                           "max_new_tokens": 5}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/worker_generate_stream", data=body)
        with urllib.request.urlopen(req, timeout=60) as resp:
            chunks = [json.loads(c) for c in resp.read().split(b"\0") if c]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/worker_get_status", data=b"{}")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["model_names"] == ["tiny"]
    finally:
        worker.shutdown()


def test_port_runs_with_jax_blocked():
    """The port imports no jax and nothing of the JAX package: with both
    `jax` and `radvlm_tpu` blocked in sys.modules (`sys.modules[name] = None`
    makes any import of it raise), every module imports, the tiny model
    generates tokens, the int8 continuous engine serves requests, with
    speculative decoding too, and an int4 model saved as an artifact loads
    back and serves the same tokens."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["radvlm_tpu"] = None
        import importlib, pkgutil
        import numpy as np, torch
        import radvlm_tpu_torch
        for m in pkgutil.walk_packages(radvlm_tpu_torch.__path__, "radvlm_tpu_torch."):
            importlib.import_module(m.name)
        from radvlm_tpu_torch.config import tiny_test_config
        from radvlm_tpu_torch.eval.harness import VLMRunner
        from radvlm_tpu_torch.models.convert import init_params

        class Tok:
            eos_token_ids, pad_token_id = (1,), 0
            encode = staticmethod(lambda s: [2 + b for b in s.encode()])
            decode = staticmethod(lambda ids: str(list(ids)))

        cfg = tiny_test_config(vocab_size=300)
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
        runner = VLMRunner(model=model, cfg=cfg, tokenizer=Tok(), max_new_tokens=4,
                           batch_size=1, pad_to_multiple=64)
        img = np.random.default_rng(0).integers(0, 255, (70, 90, 3), dtype=np.uint8)
        # The int8 continuous path: int8 weights made by the port, the int8 cache.
        from radvlm_tpu_torch.generation.continuous import ContinuousBatcher
        from radvlm_tpu_torch.generation.engine import GenerationConfig
        from radvlm_tpu_torch.models import multimodal
        from radvlm_tpu_torch.models.convert import random_quantized_params
        qmodel = random_quantized_params(cfg, torch.Generator().manual_seed(0),
                                         device="cpu", dtype=torch.float32)
        batcher = ContinuousBatcher(qmodel, cfg, GenerationConfig(max_new_tokens=3),
                                    num_slots=2, max_len=256, prompt_buckets=(128,),
                                    pad_tiles=2, kv_quant=True)
        sample = multimodal.build_sample(Tok.encode("hi") + [-200], [img], cfg)
        reqs = [batcher.submit(sample) for _ in range(3)]
        assert [len(r.emitted) for r in batcher.run()] == [3, 3, 3]
        plain = [r.emitted for r in reqs]
        batcher = ContinuousBatcher(qmodel, cfg, GenerationConfig(max_new_tokens=3),
                                    num_slots=2, max_len=256, prompt_buckets=(128,),
                                    pad_tiles=2, kv_quant=True, spec_k=2)
        reqs = [batcher.submit(sample) for _ in range(3)]
        list(batcher.run())
        assert [r.emitted for r in reqs] == plain
        # The int4 path: an unfused int4 model at a width that divides by 128,
        # saved as an artifact, loaded back, served by the int4 engine.
        import dataclasses, tempfile
        from radvlm_tpu_torch.models import quant_io
        from radvlm_tpu_torch.models.layers import Q4Linear
        wide = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256,
                                          head_dim=32),
            vision=dataclasses.replace(cfg.vision, hidden_size=128))
        q4 = random_quantized_params(wide, torch.Generator().manual_seed(1), device="cpu",
                                     dtype=torch.float32, bits=4, fuse=False)
        with tempfile.TemporaryDirectory() as d:
            quant_io.save_quantized(q4, wide, d)
            loaded_model, loaded_cfg = quant_io.load_quantized(d, device="cpu")
        assert loaded_cfg == wide and isinstance(loaded_model.text.layers[0].down, Q4Linear)
        sample4 = multimodal.build_sample(Tok.encode("hi") + [-200], [img], wide)
        outs = []
        for m in (q4, loaded_model):
            VLMRunner(model=m, cfg=wide, tokenizer=Tok())  # fuses in place
            b4 = ContinuousBatcher(m, wide, GenerationConfig(max_new_tokens=3), num_slots=2,
                                   max_len=256, prompt_buckets=(128,), pad_tiles=2,
                                   kv_quant=True)
            assert b4.kernel_provenance()["decode_matmul"] == "int4"
            r4 = [b4.submit(sample4) for _ in range(2)]
            list(b4.run())
            outs.append([r.emitted for r in r4])
        assert outs[0] == outs[1] and len(outs[0][0]) == 3
        print(runner.generate_batch(["<image>\\nhi"], [[img]]))
        loaded = [k for k, v in sys.modules.items() if v is not None]
        assert not [k for k in loaded if k.split(".")[0] == "jax"]
        assert not [k for k in loaded if k.split(".")[0] == "radvlm_tpu"]
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    toks = eval(out.stdout.strip().splitlines()[-1])[0]
    assert len(eval(toks)) > 0


PRESETS = ["tiny_test_config", "radvlm_0_5b", "radvlm_7b", "qwen2_0_5b", "qwen2_7b"]
CONSTANTS = ["IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN"]


@pytest.mark.parametrize("name", PRESETS + CONSTANTS)
def test_port_config_equals_jax_config(name):
    """The port keeps its own copy of the config module: every preset it
    exports equals the JAX package's field by field, and so do the three
    constants; a config object of either package drives the port."""
    import dataclasses

    from radvlm_tpu_torch import config as tcfg

    if name in CONSTANTS:
        assert getattr(tcfg, name) == getattr(cfglib, name)
        return
    mine, theirs = getattr(tcfg, name)(), getattr(cfglib, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(theirs)]
    assert type(mine).__module__ == "radvlm_tpu_torch.config"
    if name.startswith(("radvlm", "tiny")):
        assert tcfg.tokens_per_tile(mine) == tcfg.tokens_per_tile(theirs) == theirs.tokens_per_tile
