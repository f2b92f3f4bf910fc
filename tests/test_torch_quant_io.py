"""The port's checkpoint paths against the JAX package at small sizes: the
safetensors container (against the `safetensors` package), the pre-quantized
artifact both ways (int8 and int4), the HF loader, `quantize_cli` and
`worker_cli`, and the default device.

Everything here is held bit for bit: the artifact and the loaders move
bytes, they compute nothing. int4 needs contraction dims that divide by 128,
so those cases use the widened tiny config of tests/test_torch_int4.py.
"""

import base64
import dataclasses
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import hf_import as jhf
from radvlm_tpu.models import quant_io as jqio
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.models.hf_export import save_radvlm_hf
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch import device as tdevice
from radvlm_tpu_torch.eval.harness import VLMRunner
from radvlm_tpu_torch.generation.continuous import KVSnapshot
from radvlm_tpu_torch.models import convert, hf_import, quant_io, quantize_cli, safetensors_io
from radvlm_tpu_torch.models.layers import Q4Linear, QLinear
from radvlm_tpu_torch.ops.quant import quantize_model
from radvlm_tpu_torch.serve import worker_cli
from radvlm_tpu_torch.serve.batch_worker import BatchWorker


def wide_tiny(cfg):
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256, head_dim=32),
        vision=dataclasses.replace(cfg.vision, hidden_size=128),
    )


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same_params(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k].view(torch.uint8) if sa[k].dtype == torch.bfloat16 else sa[k],
                           sb[k].view(torch.uint8) if sb[k].dtype == torch.bfloat16 else sb[k]), k


class ByteTokenizer:
    eos_token_ids = (1,)
    pad_token_id = 0

    def encode(self, text):
        return [2 + b for b in text.encode()]

    def decode(self, ids):
        return bytes(min(255, i - 2) for i in ids if i >= 2).decode(errors="ignore")


# ------------------------------------------------------------- the container

DTYPES = {"I8": torch.int8, "U8": torch.uint8, "U16": torch.uint16, "BF16": torch.bfloat16,
          "F16": torch.float16, "F32": torch.float32, "I32": torch.int32, "I64": torch.int64}


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _sample_tensors(rng, dtype):
    raw = rng.integers(0, 256, 2 * 3 * 5 * 8, dtype=np.uint8)
    t = torch.from_numpy(raw.copy())
    if dtype.is_floating_point:  # no NaN payloads: equality is by value below
        t = torch.from_numpy(rng.normal(size=(30,)).astype(np.float32)).to(dtype).view(torch.uint8)
    a = t.view(dtype)
    return {"a": a.reshape(2, -1).clone(), "odd/name": torch.arange(7, dtype=torch.int8),
            "scalar": a[:1].reshape(()).clone(), "empty": torch.empty((0, 4), dtype=dtype)}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_io_matches_the_package(rng, tmp_path, name):
    from safetensors import safe_open
    from safetensors.torch import save_file

    tensors = _sample_tensors(rng, DTYPES[name])
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.write_file(tensors, mine, metadata={"who": "port"})
    save_file(tensors, theirs)
    for path in (mine, theirs):
        with safe_open(path, framework="pt") as sf:  # the package reads both
            assert sorted(sf.keys()) == sorted(tensors)
            for k in tensors:
                assert torch.equal(_bytes(sf.get_tensor(k)), _bytes(tensors[k])), k
        got = safetensors_io.read_file(path)  # and so does the port
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(_bytes(got[k]), _bytes(t)), k
    header, _ = safetensors_io.read_header(mine)
    assert header["__metadata__"] == {"who": "port"} and header["a"]["dtype"] == name


def test_safetensors_io_reads_shards_and_rejects_bad_files(rng, tmp_path):
    from safetensors.torch import save_file

    a = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    b = {"y": torch.arange(5, dtype=torch.int64), "z": torch.ones(3, dtype=torch.bfloat16)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors_io.write_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    state = safetensors_io.read_dir(str(tmp_path))
    assert sorted(state) == ["x", "y", "z"]
    assert torch.equal(state["x"], a["x"]) and torch.equal(state["y"], b["y"])
    state["x"][0, 0] = 9.0  # copy on write: the file is not touched
    assert float(safetensors_io.read_dir(str(tmp_path))["x"][0, 0]) == 0.0
    with pytest.raises(FileNotFoundError):
        safetensors_io.read_dir(str(tmp_path / "nothing"))
    (tmp_path / "short.safetensors").write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="too short"):
        safetensors_io.read_file(str(tmp_path / "short.safetensors"))
    (tmp_path / "long.safetensors").write_bytes((10 ** 6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="exceeds"):
        safetensors_io.read_file(str(tmp_path / "long.safetensors"))
    with pytest.raises(ValueError, match="unsupported dtype"):
        safetensors_io.write_file({"c": torch.zeros(2, dtype=torch.complex64)}, str(tmp_path / "c"))


# -------------------------------------------------------------- the artifact


@pytest.fixture(scope="module")
def wide():
    cfg = wide_tiny(cfglib.tiny_test_config(vocab_size=300))
    return cfg, jrad.init_params(cfg, jax.random.key(0))


def test_config_round_trip():
    cfg = wide_tiny(tcfg.tiny_test_config(vocab_size=300))
    jcfg = wide_tiny(cfglib.tiny_test_config(vocab_size=300))
    d = quant_io.config_to_dict(cfg)
    assert d == jqio.config_to_dict(jcfg)
    back = quant_io.config_from_dict(json.loads(json.dumps(d)))
    assert back == cfg and type(back).__module__ == "radvlm_tpu_torch.config"
    assert dataclasses.asdict(jqio.config_from_dict(json.loads(json.dumps(d)))) == dataclasses.asdict(cfg)
    assert quant_io.config_from_dict(dict(d, later_field=1)) == cfg  # extra keys are dropped
    # A CLIP tower's config (S2 scales, a tuple, through JSON) round-trips as
    # the JAX package's does; the other tower classes: test_torch_tower_import.py.
    from radvlm_tpu.models import towers as jtowers
    from radvlm_tpu_torch.models import towers as ttowers

    name = "openai/clip-vit-large-patch14-336"
    clip_cfg = ttowers.with_tower(cfg, name, s2=True, s2_scales=(336, 672))
    d = quant_io.config_to_dict(clip_cfg)
    assert d == jqio.config_to_dict(jtowers.with_tower(jcfg, name, s2=True, s2_scales=(336, 672)))
    back = quant_io.config_from_dict(json.loads(json.dumps(d)))
    assert back == clip_cfg and type(back.vision).__module__ == "radvlm_tpu_torch.models.clip"
    assert dataclasses.asdict(jqio.config_from_dict(json.loads(json.dumps(d)))) == (
        dataclasses.asdict(back))
    assert (quant_io.MARKER, quant_io.FORMAT_VERSION) == (jqio.MARKER, jqio.FORMAT_VERSION)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_jax_artifact_loads_into_the_bridged_model(tmp_path, wide, bits, dtype):
    cfg, params = wide
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    qparams = jquant.quantize_params(params, bits=bits)
    jqio.save_quantized(_np_tree(qparams), cfg, str(tmp_path))
    assert quant_io.is_quantized_dir(str(tmp_path)) and not quant_io.is_quantized_dir(str(tmp_path / "x"))
    model, lcfg = quant_io.load_quantized(str(tmp_path), device="cpu")
    assert dataclasses.asdict(lcfg) == dataclasses.asdict(cfg)
    want = convert.radvlm_from_jax(_np_tree(qparams), cfg, device="cpu",
                                   dtype=getattr(torch, dtype))
    _same_params(model, want)
    assert isinstance(model.text.layers[0].q, Q4Linear if bits == 4 else QLinear)
    assert model.image_newline.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_port_artifact_is_read_back_by_jax(tmp_path, wide, bits, dtype):
    cfg, params = wide
    params = _np_tree(jax.tree.map(lambda x: x.astype(dtype), params))
    model = convert.radvlm_from_jax(params, cfg, device="cpu", dtype=getattr(torch, dtype))
    quantize_model(model, bits=bits)
    payload = quant_io.save_quantized(model, cfg, str(tmp_path))
    assert jqio.is_quantized_dir(str(tmp_path))
    tree, jcfg = jqio.load_quantized(str(tmp_path))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    want = _np_tree(jquant.quantize_params(jax.tree.map(jnp.asarray, params), bits=bits))
    got = jax.tree_util.tree_flatten_with_path(_np_tree(tree))[0]
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a,
                              b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b), path
    assert payload == sum(a.nbytes for _, a in ref)
    if dtype == "bfloat16":  # stored as uint16 bit patterns, named in the marker
        meta = json.loads((tmp_path / quant_io.MARKER).read_text())
        assert meta["dtypes"]["image_newline"] == "bfloat16"
        assert safetensors_io.read_file(str(tmp_path / "model.safetensors"))[
            "image_newline"].dtype == torch.uint16
    again, _ = quant_io.load_quantized(str(tmp_path), device="cpu")  # and by the port
    _same_params(again, model)


def test_load_quantized_rejects_another_format(tmp_path):
    (tmp_path / quant_io.MARKER).write_text(json.dumps({"format_version": 99}))
    with pytest.raises(ValueError, match="format"):
        quant_io.load_quantized(str(tmp_path), device="cpu")


# ------------------------------------------------------------- the HF loader


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory, wide):
    cfg, params = wide
    path = tmp_path_factory.mktemp("hf")
    save_radvlm_hf(params, cfg, str(path))
    (path / "tokenizer_config.json").write_text(json.dumps({"t": 1}))
    return path


def test_config_from_hf_dir_equals_jax(hf_dir, wide):
    mine, theirs = hf_import.config_from_hf_dir(str(hf_dir)), jhf.config_from_hf_dir(str(hf_dir))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert type(mine).__module__ == "radvlm_tpu_torch.config"
    assert mine.text.hidden_size == 128 and mine.vision.hidden_size == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_checkpoint_loads_into_the_bridged_model(hf_dir, dtype):
    cfg = hf_import.config_from_hf_dir(str(hf_dir))
    model = hf_import.load_radvlm_checkpoint(str(hf_dir), cfg, device="cpu",
                                             dtype=getattr(torch, dtype))
    jtree = jhf.load_radvlm_checkpoint(str(hf_dir), jhf.config_from_hf_dir(str(hf_dir)),
                                       dtype=getattr(jnp, dtype))
    want = convert.radvlm_from_jax(_np_tree(jtree), cfg, device="cpu", dtype=getattr(torch, dtype))
    _same_params(model, want)


@pytest.mark.parametrize("layout", ["llava_ov_training", "hf_converted", "hf_newer", "plain_qwen2"])
def test_normalize_keys_layouts(layout):
    keys = {
        "llava_ov_training": {
            "model.layers.0.self_attn.q_proj.weight": "text.layers.0.self_attn.q_proj.weight",
            "model.vision_tower.vision_tower.vision_model.encoder.layers.1.mlp.fc1.bias":
                "vision.encoder.layers.1.mlp.fc1.bias",
            "model.mm_projector.0.weight": "projector.fc0.weight",
            "model.mm_projector.2.bias": "projector.fc1.bias",
            "model.image_newline": "image_newline",
            "model.embed_tokens.weight": "text.embed_tokens.weight",
            "lm_head.weight": "text.lm_head.weight",
        },
        "hf_converted": {
            "language_model.model.layers.3.mlp.down_proj.weight": "text.layers.3.mlp.down_proj.weight",
            "language_model.lm_head.weight": "text.lm_head.weight",
            "vision_tower.vision_model.embeddings.patch_embedding.weight":
                "vision.embeddings.patch_embedding.weight",
            "multi_modal_projector.linear_1.weight": "projector.fc0.weight",
            "multi_modal_projector.linear_2.bias": "projector.fc1.bias",
            "image_newline": "image_newline",
        },
        "hf_newer": {
            "model.language_model.layers.0.input_layernorm.weight": "text.layers.0.input_layernorm.weight",
            "model.language_model.embed_tokens.weight": "text.embed_tokens.weight",
            "model.language_model.norm.weight": "text.norm.weight",
            "model.vision_tower.vision_model.post_layernorm.bias": "vision.post_layernorm.bias",
            "model.multi_modal_projector.linear_1.bias": "projector.fc0.bias",
            "model.image_newline": "image_newline",
            "lm_head.weight": "text.lm_head.weight",
        },
        "plain_qwen2": {
            "model.layers.5.self_attn.o_proj.weight": "text.layers.5.self_attn.o_proj.weight",
            "model.norm.weight": "text.norm.weight",
            "lm_head.weight": "text.lm_head.weight",
            "vision_model.embeddings.position_embedding.weight":
                "vision.embeddings.position_embedding.weight",
        },
    }[layout]
    state = {k: np.zeros(1, np.float32) for k in keys}
    assert sorted(hf_import.normalize_keys(state)) == sorted(keys.values())
    assert sorted(jhf.normalize_keys(state)) == sorted(keys.values())


# ------------------------------------------------------- the entry points


def _png_b64(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


ENGINE = dict(kv_quant=True, pad_tiles=2, steps_per_sync=4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_cli_then_worker_cli(tmp_path, hf_dir, bits, capsys):
    """HF dir -> quantize_cli -> the artifact the JAX package reads -> the
    worker `worker_cli` builds from it answers over HTTP with the text of a
    `BatchWorker` built from the bridge of the same tree."""
    out = tmp_path / f"q{bits}"
    quantize_cli.main(["--hf-checkpoint", str(hf_dir), "--out", str(out), "--bits", str(bits),
                       "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"int{bits}" in printed and "GB quantized payload" in printed
    assert quant_io.is_quantized_dir(str(out)) and (out / "tokenizer_config.json").exists()
    tree, jcfg = jqio.load_quantized(str(out))
    jtree = jhf.load_radvlm_checkpoint(str(hf_dir), jcfg, dtype=jnp.bfloat16)
    want = _np_tree(jquant.quantize_params(jtree, bits=bits))
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(_np_tree(tree))[0]):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), path

    tok = ByteTokenizer()
    args = worker_cli.parse_args(["--checkpoint", str(out), "--device", "cpu", "--num-slots", "2",
                                  "--max-len", "256", "--prompt-bucket", "128",
                                  "--max-new-tokens", "6", "--model-names", "tiny, other"])
    worker = worker_cli.build_worker(args, tokenizer=tok, **ENGINE)
    assert isinstance(worker, BatchWorker) and worker.model_names == ["tiny", "other"]
    prov = worker.batcher.kernel_provenance()
    assert prov["decode_matmul"] == ("int4" if bits == 4 else "int8")
    cfg = worker.runner.cfg
    ref_runner = VLMRunner(model=convert.radvlm_from_jax(_np_tree(tree), cfg, device="cpu",
                                                         dtype=torch.bfloat16),
                           cfg=cfg, tokenizer=tok, max_new_tokens=6)
    ref = BatchWorker(ref_runner, model_names=["tiny"], num_slots=2, max_len=256,
                      prompt_bucket=128, **ENGINE)
    img = np.random.default_rng(3).integers(0, 255, (90, 70, 3), dtype=np.uint8)
    body = {"prompt": "<|im_start|>user\n<image>\nDescribe.<|im_end|>\n<|im_start|>assistant\n",
            "images": [_png_b64(img)], "max_new_tokens": 5}
    ports = [w.serve_forever(host="127.0.0.1", port=0, background=True) for w in (worker, ref)]
    try:
        got, exp = (_post(p, "/worker_generate", body) for p in ports)
        assert got == exp and got["error_code"] == 0
    finally:
        worker.shutdown()
        ref.shutdown()


def test_worker_cli_load_order_and_what_raises(tmp_path, hf_dir):
    """An HF dir loads dense (bf16) or, with --int8, quantized at load; the
    static engine is the streaming worker; a fleet takes the continuous
    engine, and a fleet of TP engines outside torchrun's world raises
    naming torchrun."""
    from radvlm_tpu_torch.serve.worker import ModelWorker

    tok = ByteTokenizer()
    base = ["--checkpoint", str(hf_dir), "--device", "cpu", "--engine", "static"]
    dense = worker_cli.build_worker(worker_cli.parse_args(base), tokenizer=tok)
    assert isinstance(dense, ModelWorker)
    assert not any(isinstance(m, (QLinear, Q4Linear)) for m in dense.runner.model.modules())
    assert dense.runner.model.image_newline.dtype == torch.bfloat16
    q = worker_cli.build_worker(worker_cli.parse_args(base + ["--int8"]), tokenizer=tok)
    assert isinstance(q.runner.model.text.layers[0].qkv, QLinear)
    with pytest.raises(ValueError, match="torchrun"):
        worker_cli.build_worker(worker_cli.parse_args(base + ["--fleet-tp", "2"]), tokenizer=tok)
    with pytest.raises(ValueError, match="--engine continuous"):
        worker_cli.build_worker(worker_cli.parse_args(base + ["--fleet", "2"]), tokenizer=tok)
    with pytest.raises(ValueError, match="static engine"):
        worker_cli.build_worker(worker_cli.parse_args(base), tokenizer=tok, kv_quant=True)
    with pytest.raises(Exception):  # no tokenizer files in the directory
        worker_cli.build_worker(worker_cli.parse_args(base))


# ------------------------------------------------------- the default device


@pytest.mark.parametrize("entry", ["resolve", "init_params", "random_quantized_params",
                                   "radvlm_from_jax", "kv_snapshot", "load_quantized",
                                   "load_radvlm_checkpoint", "quantize_cli", "worker_cli"])
def test_device_none_means_the_card_and_raises_without_one(tmp_path, hf_dir, wide, entry):
    """No function that makes or loads a model or a snapshot builds on the
    CPU unless the caller asked for it: `device=None` is the card, and where
    there is none it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: device=None is cuda:0 here")
    cfg = tcfg.tiny_test_config()
    gen = torch.Generator().manual_seed(0)
    assert tdevice.resolve("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda:0"):
        if entry == "resolve":
            tdevice.resolve(None)
        elif entry == "init_params":
            convert.init_params(cfg, gen)
        elif entry == "random_quantized_params":
            convert.random_quantized_params(cfg, gen)
        elif entry == "radvlm_from_jax":
            convert.radvlm_from_jax(_np_tree(wide[1]), wide[0])
        elif entry == "kv_snapshot":
            KVSnapshot.from_numpy({"cache_rows": (np.zeros((1, 2, 4), np.uint16),),
                                   "seg_row": np.zeros(2, np.int32)})
        elif entry == "load_quantized":
            jqio.save_quantized(_np_tree(jquant.quantize_params(wide[1])), wide[0], str(tmp_path))
            quant_io.load_quantized(str(tmp_path))
        elif entry == "load_radvlm_checkpoint":
            hf_import.load_radvlm_checkpoint(str(hf_dir), hf_import.config_from_hf_dir(str(hf_dir)))
        elif entry == "quantize_cli":
            quantize_cli.main(["--hf-checkpoint", str(hf_dir), "--out", str(tmp_path / "o")])
        else:
            worker_cli.build_worker(worker_cli.parse_args(["--checkpoint", str(hf_dir)]),
                                    tokenizer=ByteTokenizer())
