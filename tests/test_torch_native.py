"""The port's C++ host prep (`radvlm_tpu_torch/native`) against the JAX
package's and PIL, both libraries built into this module's own build
directory:

- the anyres tiler's tiles are bit-equal to `radvlm_tpu.native.anyres_tiles`
  on the same image and geometry, and within 2/255 of the port's PIL tiles;
  `image_ops.resize_plan` is the JAX `device_plan`;
- `decode_jpeg` equals the JAX decoder and PIL, grey and RGB; malformed
  bytes raise;
- RADVLM_NATIVE_ANYRES=1 and RADVLM_NATIVE_JPEG=1 route `image_ops` and
  `load_image` through the libraries; a library that fails to build logs
  the compiler's message at WARNING, and PIL serves.

No wall-clock assertion: chip_smoke.py's phase 15 times both routes.
"""

import io
import logging

import numpy as np
import pytest
from PIL import Image

from radvlm_tpu import native as jnative
from radvlm_tpu.ops.image_ops import device_plan
from radvlm_tpu_torch import kernels, native
from radvlm_tpu_torch.config import AnyResConfig
from radvlm_tpu_torch.data.loader import load_image
from radvlm_tpu_torch.ops import image_ops


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("native_build"))


@pytest.fixture
def built(build_dir, monkeypatch):
    """The port's libraries, built once into this module's build directory."""
    monkeypatch.setattr(kernels, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_libs", {})
    paths = native.build()  # a no-op once built: the sources are older
    assert all(p.startswith(build_dir) for p in paths.values())
    return paths


SHAPES = [(700, 520), (523, 461), (2500, 3000), (400, 560), (90, 70)]


@pytest.mark.parametrize("hw", SHAPES)
def test_tiles_equal_jax_and_near_pil(built, hw):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 255, size=hw + (3,), dtype=np.uint8)
    cfg = AnyResConfig()
    plan = image_ops.resize_plan((hw[1], hw[0]), cfg)
    jplan = device_plan((hw[1], hw[0]), cfg)
    assert plan == jplan
    args = (cfg.tile_size, (plan["best_w"], plan["best_h"]), (plan["new_w"], plan["new_h"]))
    ours = native.anyres_tiles(img, *args)
    np.testing.assert_array_equal(ours, jnative.anyres_tiles(img, *args))
    pil, size = image_ops.preprocess_anyres_host(img, cfg)
    assert ours.shape == pil.shape and ours.dtype == np.uint8 and size == (hw[1], hw[0])
    assert int(np.abs(ours.astype(int) - pil.astype(int)).max()) <= 2


def test_resize_equals_jax(built):
    img = np.random.default_rng(3).integers(0, 255, size=(523, 461, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_rgb(img, 384, 384),
                                  jnative.resize_rgb(img, 384, 384))


def _jpeg(arr, mode, quality=92):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_decode_equals_jax_and_pil(built, mode):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, size=(20, 18), dtype=np.uint8)
    img = np.asarray(Image.fromarray(base).resize((180, 200), Image.BILINEAR))
    arr = img if mode == "L" else np.stack([img, img[::-1], 255 - img], -1)
    data = _jpeg(arr, mode)
    ours = native.decode_jpeg(data)
    np.testing.assert_array_equal(ours, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_array_equal(ours, jnative.decode_jpeg(data))


def test_malformed_jpeg_raises(built):
    good = _jpeg(np.zeros((16, 16), np.uint8), "L")
    for bad in (b"not a jpeg", good[:20]):
        with pytest.raises(ValueError):
            native.decode_jpeg(bad)


def test_env_switches_round_trip(built, tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    cfg = AnyResConfig()
    img = rng.integers(0, 255, size=(600, 480, 3), dtype=np.uint8)
    pil, _ = image_ops.preprocess_anyres_host(img, cfg)
    monkeypatch.setenv("RADVLM_NATIVE_ANYRES", "1")
    routed, _ = image_ops.preprocess_anyres_host(img, cfg)
    normalized, _ = image_ops.preprocess_anyres_host(img, cfg, normalize=True)
    plan = image_ops.resize_plan((480, 600), cfg)
    np.testing.assert_array_equal(routed, native.anyres_tiles(
        img, cfg.tile_size, (plan["best_w"], plan["best_h"]), (plan["new_w"], plan["new_h"])))
    np.testing.assert_array_equal(normalized, image_ops.normalize_pixels(routed))
    assert int(np.abs(routed.astype(int) - pil.astype(int)).max()) <= 2

    path = tmp_path / "x.jpg"
    Image.fromarray(np.stack([rng.integers(0, 255, size=(64, 48), dtype=np.uint8)] * 3, -1)).save(
        path, "JPEG", quality=95)
    via_pil = load_image(str(path))
    calls = []
    decode = native.decode_jpeg
    monkeypatch.setattr(native, "decode_jpeg", lambda data: calls.append(1) or decode(data))
    monkeypatch.setenv("RADVLM_NATIVE_JPEG", "1")
    np.testing.assert_array_equal(load_image(str(path)), via_pil)
    assert calls == [1]


def test_failed_build_warns_and_pil_serves(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_commands",
                        lambda name, out: [["c++", "-x", "c++", "-c", "/dev/null", "-o", out,
                                            "-DNOT_A_FLAG", "--not-an-option"]])
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available() and not native.jpeg_available()
    assert any(r.levelno == logging.WARNING and "not-an-option" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    img = np.random.default_rng(1).integers(0, 255, size=(300, 200, 3), dtype=np.uint8)
    monkeypatch.setenv("RADVLM_NATIVE_ANYRES", "1")
    tiles, _ = image_ops.preprocess_anyres_host(img, AnyResConfig())
    monkeypatch.delenv("RADVLM_NATIVE_ANYRES")
    np.testing.assert_array_equal(tiles, image_ops.preprocess_anyres_host(img, AnyResConfig())[0])
