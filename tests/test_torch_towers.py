"""Parity of the port's vision towers (CLIP with S2, EVA, ImageBind) and
their dispatch with the JAX package, at tiny sizes.

JAX random-init trees, with their norms and biases perturbed, go through
the weight bridge (`models/convert.py`) into the port; the same numpy
pixels go through both towers. f32 weights and plain attention on both
sides (attn_impl="xla"): atol 1e-5, rtol 1e-4. The tables (`rope_tables`,
`collapse_video_stem`) are bit-equal; configs are compared field by field.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radvlm_tpu import config as cfglib
from radvlm_tpu.models import clip as jclip
from radvlm_tpu.models import eva as jeva
from radvlm_tpu.models import imagebind as jib
from radvlm_tpu.models import radvlm as jrad
from radvlm_tpu.models import towers as jtowers
from radvlm_tpu.ops import quant as jquant
from radvlm_tpu_torch import config as tcfg
from radvlm_tpu_torch.models import clip, convert, eva, imagebind, radvlm, towers
from radvlm_tpu_torch.ops.quant import quantize_model

TOL = dict(atol=1e-5, rtol=1e-4)

CLIP = jclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                              image_size=42, patch_size=14)
EVA = dict(hidden_size=32, head_dim=16, num_layers=2, intermediate_size=48, image_size=42,
           patch_size=14, rope_pt_seq_len=2)
TOWERS = {
    "clip": CLIP,
    "clip_s2_2": dataclasses.replace(CLIP, s2_scales=(42, 84)),
    "clip_s2_3": dataclasses.replace(CLIP, s2_scales=(42, 84, 126)),
    "eva02": jeva.EVAVisionConfig(**EVA),
    "eva8b": jeva.EVAVisionConfig(**EVA, qkv_bias=False, subln=False, swiglu=False,
                                  rope=False, norm="rms"),
    "eva_postnorm": jeva.EVAVisionConfig(**dict(EVA, rope_pt_seq_len=3), postnorm=True,
                                         rope_intp_freq=False),
    "eva_layerscale": jeva.EVAVisionConfig(**EVA, ls_init_value=0.1, swiglu=False),
    "imagebind": jib.ImageBindVisionConfig(hidden_size=40, intermediate_size=64, num_layers=2,
                                           num_heads=2, image_size=28, patch_size=14,
                                           embed_dim=24),
}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed=1):
    """Norm scales, biases and layerscale gammas moved off their init, so
    that the bridge's placement of each is exercised."""
    noise = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * noise.normal(size=x.shape)).astype(x.dtype)
        if any(getattr(k, "key", None) in ("bias", "scale", "gamma_1", "gamma_2") for k in p)
        else x,
        np_tree(tree))


def port_tower(vis, tree):
    tower = towers.build(vis, device="cpu", dtype=torch.float32)
    convert.load_tower(tower, tree)
    return tower


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_matches_jax(rng, name):
    vis = TOWERS[name]
    tree = perturbed(jtowers.init_params(vis, jax.random.key(3), jnp.float32))
    pixels = rng.normal(size=(3, vis.image_size, vis.image_size, 3)).astype(np.float32)
    ref = jtowers.forward(tree, vis, jnp.asarray(pixels), attn_impl="xla")
    out = towers.forward(port_tower(vis, tree), vis, torch.from_numpy(pixels), attn_impl="xla")
    assert out.shape == ref.shape == (3, vis.tokens_per_tile, jtowers.feature_size(vis))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_module_tree_round_trip():
    """`module_to_tree` gives back the JAX tree it was loaded from, key for
    key and bit for bit, for every tower kind."""
    for vis in (TOWERS["clip"], TOWERS["eva02"], TOWERS["eva8b"], TOWERS["eva_layerscale"],
                TOWERS["imagebind"]):
        tree = perturbed(jtowers.init_params(vis, jax.random.key(4), jnp.float32))
        back = convert.module_to_tree(port_tower(vis, tree))
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        flat_back = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, back)))
        assert flat.keys() == flat_back.keys()
        for k in flat:
            np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=str(k))


@pytest.mark.parametrize("vis", [TOWERS["eva02"], jeva.EVAVisionConfig(),
                                 jeva.EVAVisionConfig(rope_intp_freq=False)],
                         ids=["tiny", "eva02_l_336", "no_intp"])
def test_rope_tables_bit_equal(vis):
    mine = eva.rope_tables(eva.EVAVisionConfig(**dataclasses.asdict(vis)))
    for a, b in zip(mine, jeva.rope_tables(vis)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rotate_half_matches_jax(rng):
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(eva._rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jeva._rotate_half(jnp.asarray(x))))


def test_collapse_video_stem_bit_equal(rng):
    kernel = rng.normal(size=(8, 3, 2, 4, 4)).astype(np.float32)
    mine, theirs = imagebind.collapse_video_stem(kernel), jib.collapse_video_stem(kernel)
    assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


def test_resize_matches_jax(rng):
    """The antialiased bilinear resize equals `jax.image.resize` down by 2x
    and 3x and up; without antialiasing a downsample is off by whole units."""
    x = rng.normal(size=(2, 18, 18, 5)).astype(np.float32)
    for size in (6, 9, 36):
        ref = jax.image.resize(jnp.asarray(x), (2, size, size, 5), "bilinear")
        out = clip.resize_bilinear(torch.from_numpy(x), size)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
        if size < 18:
            plain = torch.nn.functional.interpolate(
                torch.from_numpy(x).permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                align_corners=False).permute(0, 2, 3, 1)
            assert np.abs(plain.numpy() - np.asarray(ref)).max() > 0.5


def test_pooler_projector_passes_features_through():
    """"pooler": no parameters and the identity, as the JAX projector."""
    from radvlm_tpu.config import ProjectorConfig
    from radvlm_tpu.models import projector as jproj
    from radvlm_tpu_torch.models.projector import Projector

    pcfg = ProjectorConfig(kind="pooler")
    proj = Projector(pcfg, 16, 16)
    assert not list(proj.parameters()) and not jproj.init_params(pcfg, 16, 16, jax.random.key(0))
    x = torch.randn(2, 3, 16)
    assert torch.equal(proj(x), x)
    np.testing.assert_array_equal(np.asarray(jproj.forward({}, pcfg, jnp.asarray(x.numpy()))),
                                  x.numpy())


def same_config(mine, theirs):
    assert type(mine).__name__ == type(theirs).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in ("tokens_per_tile", "feature_size", "patches_per_side", "head_dim",
                 "num_heads", "mean", "std"):
        assert getattr(mine, prop, None) == getattr(theirs, prop, None), prop


TOWER_NAMES = [
    ("google/siglip-so400m-patch14-384", {}),
    ("openai/clip-vit-large-patch14-336", {}),
    ("openai/clip-vit-large-patch14-336", dict(select_layer=-3)),
    ("openai/clip-vit-large-patch14-336", dict(s2=True, s2_scales=(336, 672, 1008))),
    ("laion/CLIP-ViT-L-14", {}),
    ("/abs/path/to/clip", {}),
    ("Lin-Chen/ShareGPT4V-7B_Pretrained_vit-large336-l12", {}),
    ("open_clip_hub:ViT-H-14-378-quickgelu", {}),
    ("open_clip_hub:ViT-H-14-quickgelu", dict(s2=True, s2_scales=(224, 448))),
    ("open_clip_hub:ViT-L-14-336-quickgelu", dict(select_layer=-1)),
    ("imagebind_huge", {}),
    ("EVA02-CLIP-L-14-336", {}),
    ("EVA02-CLIP-L-14", {}),
    ("EVA02-CLIP-B-16", {}),
    ("EVA-CLIP-8B", {}),
    ("EVA-CLIP-8B-plus", {}),
    ("BAAI/internal-eva02-clip-b-16", {}),
]


@pytest.mark.parametrize("name,kw", TOWER_NAMES, ids=[f"{n}{sorted(k.items())}"
                                                     for n, k in TOWER_NAMES])
def test_config_from_tower_name_matches_jax(name, kw):
    same_config(towers.config_from_tower_name(name, **kw),
                jtowers.config_from_tower_name(name, **kw))


def test_config_from_tower_name_errors_and_hf_dirs(tmp_path):
    d = tmp_path / "hfvision"
    d.mkdir()
    for data in ({"model_type": "clip_vision_model", "hidden_size": 64, "num_hidden_layers": 5,
                  "num_attention_heads": 4, "intermediate_size": 128, "image_size": 56,
                  "patch_size": 14},
                 {"vision_config": {"model_type": "siglip_vision_model", "hidden_size": 48}}):
        (d / "config.json").write_text(json.dumps(data))
        same_config(towers.config_from_tower_name(f"hf:{d}"),
                    jtowers.config_from_tower_name(f"hf:{d}"))
    (d / "config.json").write_text(json.dumps({"model_type": "beit"}))
    for fn in (towers.config_from_tower_name, jtowers.config_from_tower_name):
        with pytest.raises(ValueError, match="unsupported"):
            fn(f"hf:{d}")
        with pytest.raises(ValueError, match="negative"):
            fn("openai/clip-vit-large-patch14-336", select_layer=1)
        with pytest.raises(ValueError, match="unknown open_clip"):
            fn("open_clip_hub:ViT-nope")
        with pytest.raises(ValueError, match="Unknown vision tower"):
            fn("mystery-tower")
    assert towers._OPEN_CLIP_MODELS == jtowers._OPEN_CLIP_MODELS


@pytest.mark.parametrize("name", ["openai/clip-vit-large-patch14-336", "imagebind_huge",
                                  "EVA02-CLIP-L-14-336", "EVA-CLIP-8B",
                                  "open_clip_hub:ViT-H-14-378-quickgelu"])
def test_with_tower_matches_jax(name):
    mine = towers.with_tower(tcfg.tiny_test_config(), name)
    theirs = jtowers.with_tower(cfglib.tiny_test_config(), name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    same_config(mine.vision, theirs.vision)
    assert mine.anyres.tile_size == mine.vision.image_size
    assert (mine.image_aspect_ratio == "pad") == (name == "imagebind_huge")
    assert towers.kind(mine.vision) == jtowers.kind(theirs.vision)
    assert towers.mean_std(mine.vision) == jtowers.mean_std(theirs.vision)
    assert towers.feature_size(mine.vision) == jtowers.feature_size(theirs.vision)


def vlm_config(vis, **kw):
    base = cfglib.tiny_test_config(vocab_size=300)
    return dataclasses.replace(base, vision=vis,
                               anyres=dataclasses.replace(base.anyres, tile_size=vis.image_size),
                               **kw)


@pytest.mark.parametrize("name", ["clip", "clip_s2_2", "eva02", "imagebind"])
def test_radvlm_forward_with_tower_matches_jax(rng, name):
    """Tower + projector + merge + splice + decoder on a collated batch."""
    from radvlm_tpu.models import multimodal as jmm

    vis = TOWERS[name]
    cfg = vlm_config(vis, image_aspect_ratio="pad" if name == "imagebind" else "anyres_max_9")
    params = perturbed(jrad.init_params(cfg, jax.random.key(5)))
    tok = lambda s: [2 + b for b in s.encode()]
    imgs = [rng.integers(0, 255, (90, 70, 3), dtype=np.uint8),
            rng.integers(0, 255, (60, 130, 3), dtype=np.uint8)]
    samples = [jmm.build_sample(jmm.tokenize_with_images(tok, p), [im], cfg)
               for p, im in zip(["<image>\nhi", "a longer <image>\nprompt"], imgs)]
    batch = jmm.collate(samples, pad_to_multiple=32, left_pad=True)
    ref, _ = jrad.forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                          attn_impl="xla")
    model = convert.radvlm_from_jax(params, cfg, device="cpu")
    out, _ = radvlm.forward(model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                            attn_impl="xla")
    real = batch["segment_ids"] != 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], **TOL)


@pytest.mark.parametrize("name", ["clip", "eva02", "eva8b", "imagebind"])
def test_int8_tower_matches_jax_qmm(rng, name):
    """A tower quantized by the JAX package's `quantize_params` (its default
    patterns: q/k/v/o and fc1/fc2; EVA's swiglu stays dense) through the
    bridge: the port's `qmm` on the CPU equals the JAX `qmm`. The port's own
    `quantize_model` picks the same projections, to the same bytes."""
    vis = TOWERS[name]
    cfg = vlm_config(vis, image_aspect_ratio="pad")
    params = perturbed(jrad.init_params(cfg, jax.random.key(6)))
    qtree = np_tree(jquant.quantize_params(params))
    pixels = rng.normal(size=(2, vis.image_size, vis.image_size, 3)).astype(np.float32)
    ref = jtowers.forward(qtree["vision_tower"], vis, jnp.asarray(pixels), attn_impl="xla")
    model = convert.radvlm_from_jax(qtree, cfg, device="cpu")
    out = towers.forward(model.vision_tower, vis, torch.from_numpy(pixels), attn_impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    mine = quantize_model(convert.radvlm_from_jax(params, cfg, device="cpu"))
    a = convert.radvlm_to_tree(mine)["vision_tower"]
    b = qtree["vision_tower"]
    flat_a = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, a)))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))
