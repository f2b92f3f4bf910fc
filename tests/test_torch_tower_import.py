"""The port's HF import of the towers and the Q-Former, its CLIP config
branch, `normalize_keys`' resampler rule, artifacts of every vision class
and the training CLI's `--vision-tower`, against the JAX package.

Each importer must fill the port's module with exactly the values the JAX
importer's tree carries through the weight bridge, bit for bit, on the same
state dict: an HF `CLIPVisionModel` built by `transformers` on the CPU, and
the open_clip, ImageBind, EVA and Q-Former layouts of tests/tower_layouts.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.config import ResamplerConfig
from radvlm_tpu.models import clip as jclip
from radvlm_tpu.models import eva as jeva
from radvlm_tpu.models import hf_export as jexport
from radvlm_tpu.models import hf_import as jhf
from radvlm_tpu.models import imagebind as jib
from radvlm_tpu.models import quant_io as jqio
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch.models import convert, hf_import, quant_io, radvlm, resampler, towers
from radvlm_tpu_torch.ops.quant import quantize_model
from tower_layouts import eva_state, imagebind_state, open_clip_state, qformer_state

TINY = jclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                              image_size=42, patch_size=14)
IMAGEBIND = jib.ImageBindVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                                      num_heads=2, image_size=42, patch_size=14, embed_dim=16)
EVA_BASE = dict(hidden_size=32, head_dim=16, num_layers=2, intermediate_size=48, image_size=42,
                patch_size=14, rope_pt_seq_len=3)
EVAS = {
    "eva02": jeva.EVAVisionConfig(**EVA_BASE),
    "eva8b": jeva.EVAVisionConfig(**EVA_BASE, qkv_bias=False, subln=False, swiglu=False,
                                  rope=False, norm="rms"),
    "layerscale": jeva.EVAVisionConfig(**EVA_BASE, ls_init_value=0.1, swiglu=False),
}
QFORMER = ResamplerConfig(kind="qformer", depth=2, num_latents=4, qformer_layers=3,
                          qformer_hidden=32, qformer_heads=2, qformer_intermediate=64)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPVisionConfig as HFConfig, CLIPVisionModel

    torch.manual_seed(0)
    model = CLIPVisionModel(HFConfig(
        hidden_size=TINY.hidden_size, intermediate_size=TINY.intermediate_size,
        num_hidden_layers=TINY.num_layers + 1, num_attention_heads=TINY.num_heads,
        image_size=TINY.image_size, patch_size=TINY.patch_size))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # Norms off their init, so the placement of each is exercised.
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if "norm" in k or k.endswith(".bias"):
            sd[k] = v + 0.05 * torch.randn(v.shape, generator=g)
    return sd


def same_module(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def np_state(state):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state.items()}


def check_tower(port_import, jax_import, state, vis):
    """The port's importer against the JAX importer's tree bridged in."""
    mine = towers.build(vis, device="cpu", dtype=torch.float32)
    port_import({k: torch.as_tensor(v) for k, v in state.items()}, mine)
    want = towers.build(vis, device="cpu", dtype=torch.float32)
    convert.load_tower(want, jax.tree.map(np.asarray, jax_import(np_state(state), vis,
                                                                 dtype=jnp.float32)))
    same_module(mine, want)


def test_import_clip_matches_jax(hf_clip):
    state = {k: v for k, v in hf_import.normalize_keys(hf_clip).items()}
    check_tower(hf_import.import_clip, jhf.import_clip, state, TINY)


def test_import_open_clip_matches_jax(hf_clip):
    check_tower(hf_import.import_open_clip, jhf.import_open_clip, open_clip_state(hf_clip), TINY)
    # The same tensors in either layout make the same tower.
    a = towers.build(TINY, device="cpu", dtype=torch.float32)
    hf_import.import_open_clip(open_clip_state(hf_clip), a)
    b = towers.build(TINY, device="cpu", dtype=torch.float32)
    hf_import.import_clip(hf_import.normalize_keys(hf_clip), b)
    same_module(a, b)


def test_import_imagebind_matches_jax(hf_clip, rng):
    check_tower(hf_import.import_imagebind, jhf.import_imagebind,
                imagebind_state(hf_clip, rng, IMAGEBIND), IMAGEBIND)


@pytest.mark.parametrize("name", list(EVAS))
@pytest.mark.parametrize("prefix", ["visual.", ""])
def test_import_eva_matches_jax(rng, name, prefix):
    check_tower(hf_import.import_eva, jhf.import_eva, eva_state(EVAS[name], rng, prefix),
                EVAS[name])


def test_import_qformer_matches_jax(rng):
    state = qformer_state(QFORMER, 24, rng)
    mine = resampler.build(QFORMER, 24, device="cpu", dtype=torch.float32)
    hf_import.import_qformer({k: torch.from_numpy(v) for k, v in state.items()}, mine)
    want = resampler.build(QFORMER, 24, device="cpu", dtype=torch.float32)
    convert.load_tower(want, jax.tree.map(np.asarray, jhf.import_qformer(
        state, QFORMER, dtype=jnp.float32)))
    same_module(mine, want)


def test_import_radvlm_with_clip_and_qformer_matches_jax(hf_clip, rng, monkeypatch):
    """A whole LLaVA checkpoint (HF decoder and projector keys, the CLIP
    tower under `vision_tower.vision_model.`, the Q-Former under
    `model.vision_resampler.`) through both packages' `import_radvlm`."""
    base = cfglib.tiny_test_config(vocab_size=300)
    cfg = dataclasses.replace(base, vision=TINY, resampler=QFORMER, image_aspect_ratio="pad",
                              anyres=dataclasses.replace(base.anyres, tile_size=42))
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(0)))
    monkeypatch.setattr(jexport, "export_siglip", lambda *a, **k: {})
    state = dict(jexport.export_radvlm(params, cfg))
    state.update({"vision_tower.vision_model." + k[len("vision_model."):]: v.numpy()
                  for k, v in hf_clip.items()})
    state.update({"model.vision_resampler." + k: v
                  for k, v in qformer_state(QFORMER, TINY.hidden_size, rng).items()})
    mine = radvlm.RadVLM(cfg, device="cpu", dtype=torch.float32)
    hf_import.import_radvlm({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, mine)
    want = convert.radvlm_from_jax(jhf.import_radvlm(state, cfg, dtype=jnp.float32), cfg,
                                   device="cpu")
    same_module(mine, want)


def test_normalize_keys_vision_resampler():
    state = {"model.vision_resampler.query_tokens": np.zeros((1, 4, 8), np.float32),
             "model.vision_resampler.Qformer.bert.embeddings.LayerNorm.weight":
                 np.ones((8,), np.float32),
             "model.vision_tower.vision_tower.visual.cls_token": np.zeros((1, 1, 8), np.float32)}
    mine, theirs = hf_import.normalize_keys(state), jhf.normalize_keys(state)
    assert sorted(mine) == sorted(theirs) == sorted([
        "vision_resampler.query_tokens",
        "vision_resampler.Qformer.bert.embeddings.LayerNorm.weight", "visual.cls_token"])


@pytest.mark.parametrize("vision", [
    {"model_type": "clip_vision_model", "hidden_size": 64, "intermediate_size": 128,
     "num_hidden_layers": 5, "num_attention_heads": 4, "image_size": 56, "patch_size": 14},
    {"model_type": "clip_vision_model"},
    {"model_type": "siglip_vision_model", "hidden_size": 48, "num_hidden_layers": 3},
], ids=["clip", "clip_defaults", "siglip"])
def test_config_from_hf_dir(tmp_path, vision):
    data = {"text_config": {"model_type": "qwen2", "hidden_size": 64, "num_attention_heads": 4,
                            "num_key_value_heads": 2, "num_hidden_layers": 2},
            "vision_config": vision, "image_aspect_ratio": "anyres_max_4"}
    (tmp_path / "config.json").write_text(json.dumps(data))
    mine, theirs = hf_import.config_from_hf_dir(str(tmp_path)), jhf.config_from_hf_dir(
        str(tmp_path))
    assert type(mine.vision).__name__ == type(theirs.vision).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    if vision["model_type"] == "clip_vision_model":
        assert mine.vision.num_layers == vision.get("num_hidden_layers", 24) - 1
        assert mine.anyres.tile_size == mine.vision.image_size


ARTIFACT_TOWERS = {
    "clip_s2": dataclasses.replace(TINY, s2_scales=(42, 84)),
    "eva02": EVAS["eva02"],
    "eva8b": EVAS["eva8b"],
    "imagebind": IMAGEBIND,
}


@pytest.mark.parametrize("name", list(ARTIFACT_TOWERS))
def test_quantized_artifact_round_trip(tmp_path, name):
    """An int8 model of each vision class saved by the port is read back by
    the JAX package as the tree its `quantize_params` gives, with the same
    config, and by the port as the same model."""
    vis = ARTIFACT_TOWERS[name]
    base = cfglib.tiny_test_config(vocab_size=300)
    cfg = dataclasses.replace(base, vision=vis,
                              anyres=dataclasses.replace(base.anyres, tile_size=vis.image_size),
                              image_aspect_ratio="pad" if name == "imagebind" else "anyres_max_9")
    params = jax.tree.map(np.asarray, jrad.init_params(cfg, jax.random.key(1)))
    model = quantize_model(convert.radvlm_from_jax(params, cfg, device="cpu"))
    quant_io.save_quantized(model, cfg, str(tmp_path))
    tree, jcfg = jqio.load_quantized(str(tmp_path))
    assert type(jcfg.vision).__name__ == type(vis).__name__
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    want = jax.tree.map(np.asarray, jquant.quantize_params(params))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again, tcfg = quant_io.load_quantized(str(tmp_path), device="cpu")
    assert type(tcfg.vision).__module__.startswith("radvlm_tpu_torch")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    same_module(again, model)


def test_training_cli_vision_tower(tmp_path, capsys):
    """`training.cli --vision-tower` goes through `towers.with_tower`: an
    `hf:` tower directory of a tiny CLIP trains a step on the CPU."""
    from PIL import Image

    from radvlm_tpu_torch.training import cli as tcli
    from radvlm_tpu_torch.training import loop as tloop

    torch.set_num_threads(1)
    vdir = tmp_path / "clip"
    vdir.mkdir()
    (vdir / "config.json").write_text(json.dumps({
        "model_type": "clip_vision_model", "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 3, "num_attention_heads": 2, "image_size": 28, "patch_size": 14}))
    rng = np.random.default_rng(0)
    cells = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (50, 40, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
        cells.append({"id": str(i), "image": f"img{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nAny effusion?"},
            {"from": "gpt", "value": "No effusion."}]})
    (tmp_path / "train.json").write_text(json.dumps(cells))
    seen = {}
    real_train = tloop.train

    def spy(run, *a, **k):
        seen["cfg"] = run.model
        return real_train(run, *a, **k)

    class Tok:
        eos_token_ids, pad_token_id = (1,), 0
        encode = staticmethod(lambda s: [2 + b for b in s.encode()])

    argv = ["--model-size", "tiny", "--data-path", str(tmp_path / "train.json"),
            "--image-folder", str(tmp_path), "--output-dir", str(tmp_path / "out"),
            "--device", "cpu", "--vision-tower", f"hf:{vdir}", "--mm-vision-select-layer", "-2",
            "--buckets", "256:4", "--micro-batch-size", "1", "--grad-accum-steps", "1",
            "--max-steps", "1",
            "--save-steps", "100"]
    try:
        tloop.train = spy
        tcli.main(argv, tokenizer=Tok())
    finally:
        tloop.train = real_train
    assert "training finished at step 1" in capsys.readouterr().out
    vis = seen["cfg"].vision
    assert towers.kind(vis) == "clip" and (vis.hidden_size, vis.num_layers) == (32, 2)
    assert seen["cfg"].anyres.tile_size == 28
    assert os.path.isdir(tmp_path / "out")
