"""The port's image writers and its golden-check tool on the CPU.

  1. ``io/bmp.py``: byte-equal to PIL's ``Image.save`` of the same pixels
     (rows padded to 4 bytes, bottom up), and read back exactly by the
     port's stb_image decoder (``io/native.py``).  PIL is imported by the
     tests only, which skip where it is absent.
  2. ``io/jpeg.py``: decoded by PIL, within a mean absolute difference of
     2 levels of PIL's own quality-75 encoding decoded the same way, its
     PSNR against the source within 0.5 dB of that encoding's; the port's
     decoder reads it back within 2 levels of PIL's decode.  Byte equality
     with libjpeg is not asked: its integer DCT rounds otherwise.
  3. ``tools/golden_check.py --device=cpu``: cornell_box passes against
     statistics of the JAX package's render at a cut size (64x64, 8 spp,
     depth 4), fails against a shifted mean (exit 1), and an unknown scene
     exits 2.
"""

import io
import json

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zj
import zig_weekend_raytracer_tpu_torch as zt
from zig_weekend_raytracer_tpu_torch.io import native
from zig_weekend_raytracer_tpu_torch.io.bmp import encode_bmp
from zig_weekend_raytracer_tpu_torch.io.jpeg import encode_jpeg, quant_table
from zig_weekend_raytracer_tpu_torch.tools import golden_check
from zig_weekend_raytracer_tpu_torch.utils.goldengate import region_means


def _pil():
    return pytest.importorskip("PIL.Image", reason="PIL is absent: nothing to hold the bytes to")


def _images():
    """A seeded noisy gradient and a port render (cornell 24x24@4 d4)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:37, 0:53]
    grad = np.stack([128 + 90 * np.sin(xx / 6.0), 128 + 90 * np.cos(yy / 4.0),
                     (2 * xx + 3 * yy) % 256], -1)
    grad = np.clip(grad + rng.normal(0, 6, grad.shape), 0, 255).astype(np.uint8)
    scene = zt.models.load_scene("cornell_box", device="cpu")
    fb = zt.render.Renderer(samples_per_pixel=4, max_ray_bounce_depth=4).render(scene, 24, 24)
    return {"gradient": grad, "cornell": zt.io.encode_pixels(fb)}


@pytest.fixture(scope="module")
def images():
    return _images()


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (4, 4), (37, 53), (48, 65)])
def test_bmp_is_pils_bytes(shape):
    image = _pil()
    px = np.random.default_rng(shape[0] * 100 + shape[1]).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    buf = io.BytesIO()
    image.fromarray(px).save(buf, "BMP")
    data = encode_bmp(px)
    assert data == buf.getvalue()
    np.testing.assert_array_equal(native.decode_image(data), px)


@pytest.mark.parametrize("name", ["gradient", "cornell"])
def test_jpeg_matches_pils_quality_75(images, name):
    image = _pil()
    px = images[name]
    ours = encode_jpeg(px)
    buf = io.BytesIO()
    image.fromarray(px).save(buf, "JPEG")
    theirs = buf.getvalue()
    dec_ours = np.asarray(image.open(io.BytesIO(ours)).convert("RGB")).astype(np.int32)
    dec_theirs = np.asarray(image.open(io.BytesIO(theirs)).convert("RGB")).astype(np.int32)
    assert dec_ours.shape == px.shape
    assert np.abs(dec_ours - dec_theirs).mean() <= 2.0
    assert abs(_psnr(dec_ours, px) - _psnr(dec_theirs, px)) <= 0.5
    # the port's own decoder reads it back
    assert np.abs(native.decode_image(ours).astype(np.int32) - dec_ours).mean() <= 2.0


def test_jpeg_structure():
    """Quality 75 scales the Annex K tables by 50%; the file is baseline
    JFIF (SOI, APP0 "JFIF", SOF0 of 3 components 2x2/1x1/1x1, EOI)."""
    assert quant_table(np.array([16, 11, 99, 1])).tolist() == [8, 6, 50, 1]
    data = encode_jpeg(np.zeros((5, 9, 3), np.uint8))
    assert data[:4] == b"\xff\xd8\xff\xe0" and data[6:11] == b"JFIF\x00"
    assert data.endswith(b"\xff\xd9")
    sof = data.index(b"\xff\xc0")
    assert data[sof + 5 : sof + 9] == bytes([0, 5, 0, 9])
    assert data[sof + 10 : sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((2, 2, 3), np.float32))


@pytest.fixture(scope="module")
def cut_regions(tmp_path_factory):
    """scene_regions.json's layout (8 x 8 regions) for cornell_box at
    64x64, 8 spp, depth 4, from the JAX package's render: regions of 64
    pixels, in which one pixel of the floor / red-wall edge (the FMA
    witnesses of test_torch_render.py) moves no region past the gate."""
    cfg = {"width": 64, "height": 64, "spp": 8, "depth": 4}
    fb = np.asarray(zj.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=4,
                                       seed=0).render(zj.models.load_scene("cornell_box"), 64, 64))
    ref = {**cfg, "mean": float(fb.mean()), "region_means": region_means(fb, 8).tolist()}
    path = tmp_path_factory.mktemp("regions") / "regions.json"
    path.write_text(json.dumps({"grid": 8, "scenes": {"cornell_box": ref}}))
    return path, ref


def test_golden_check_passes_at_a_cut_size(cut_regions, monkeypatch, capsys):
    path, _ = cut_regions
    monkeypatch.setattr(golden_check, "REGIONS", str(path))
    assert golden_check.main(["--device=cpu", "cornell_box"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("cornell_box: pass") and "64x64@8 d4" in line and "on cpu" in line


def test_golden_check_exit_codes(cut_regions, tmp_path, monkeypatch, capsys):
    path, ref = cut_regions
    monkeypatch.setattr(golden_check, "REGIONS", str(path))
    assert golden_check.main(["--device=cpu", "bogus"]) == 2
    assert "unknown scene" in capsys.readouterr().err
    shifted = tmp_path / "shifted.json"
    shifted.write_text(json.dumps({"grid": 8, "scenes": {
        "cornell_box": {**ref, "mean": ref["mean"] * 1.05}}}))
    monkeypatch.setattr(golden_check, "REGIONS", str(shifted))
    assert golden_check.main(["--device=cpu"]) == 1
    assert "cornell_box: fail:global-mean" in capsys.readouterr().out
