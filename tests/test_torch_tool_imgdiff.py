"""The port's ``tools/imgdiff.py`` against the JAX package's (which decodes
with PIL; the port decodes with stb_image and its own plain-PPM reader and
imports no imaging package).

  1. On seeded framebuffers written by the port's PPM (P3) and PNG writers
     (and BMP), every statistic equals the JAX tool's to rtol 1e-12, and
     the printed lines are the JAX tool's, in the two- and three-image
     forms.
  2. On a JPEG of the same framebuffer, stb_image's and PIL's decoders
     differ (IDCT and chroma upsampling); the gap was measured once on
     this image (seed 3, 24x40, the port's JPEG writer at quality 75) and
     is the test's tolerance (see JPEG_*).
  3. A missing file exits 1 (``io/image.load_image`` would read magenta),
     an undecodable one exits 1, the wrong argument count exits 2 with the
     usage on stderr, as the JAX tool does.
"""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu_torch as zt
from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from tools import imgdiff as jtool
from zig_weekend_raytracer_tpu_torch.tools import imgdiff as ttool

# measured once on _framebuffer(3)'s JPEG: the largest linear-value gap
# between the two decoders 0.018408; against the PPM of the same
# framebuffer, the statistics' largest relative gap 1.688e-04 (the MSE)
JPEG_MAX_ABS = 0.019
JPEG_STATS_RTOL = 2e-4


def _framebuffer(seed, shape=(24, 40, 3)):
    return np.random.default_rng(seed).uniform(0.0, 1.2, shape).astype(np.float32)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgdiff")
    paths = {}
    for name, seed, ext in (("a", 3, "ppm"), ("b", 4, "png"), ("ref", 5, "png"),
                            ("c", 4, "bmp"), ("j", 3, "jpg")):
        paths[name] = str(d / f"{name}.{ext}")
        zt.io.write_image(paths[name], _framebuffer(seed))
    return paths


@pytest.mark.parametrize("pair", [("a", "b"), ("b", "ref"), ("a", "c"), ("a", "a")])
def test_stats_match_jax(images, pair):
    a, b = (images[k] for k in pair)
    got = ttool.stats(ttool.load_linear(a), ttool.load_linear(b))
    want = jtool.stats(jtool.load_linear(a), jtool.load_linear(b))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if pair == ("a", "a"):
        assert got["mse"] == 0.0 and got["psnr_db"] == float("inf")


@pytest.mark.parametrize("keys", [("a", "b"), ("a", "b", "ref")])
def test_lines_match_jax(images, capsys, keys):
    argv = [images[k] for k in keys]
    assert jtool.main(argv) == 0
    want = capsys.readouterr().out
    assert ttool.main(argv) == 0
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == len(keys) - 1


def test_decoders_agree_on_the_writers_lossless_files(images):
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(ttool.load_linear(images[k]), jtool.load_linear(images[k]))
    want = zt.io.encode_pixels(_framebuffer(3)).astype(np.float32) / 255.0
    np.testing.assert_array_equal(ttool.load_linear(images["a"]), want * want)


def test_jpeg_within_the_measured_decoder_gap(images):
    got, want = ttool.load_linear(images["j"]), jtool.load_linear(images["j"])
    gap = float(np.abs(got - want).max())
    assert 0 < gap <= JPEG_MAX_ABS
    # against the lossless file of the same framebuffer
    s_t = ttool.stats(got, ttool.load_linear(images["a"]))
    s_j = jtool.stats(want, jtool.load_linear(images["a"]))
    for k in s_j:
        assert s_t[k] == pytest.approx(s_j[k], rel=JPEG_STATS_RTOL), k


def test_missing_and_bad_files_exit_1(images, tmp_path, capsys):
    assert ttool.main([images["a"], str(tmp_path / "missing.png")]) == 1
    assert "missing.png" in capsys.readouterr().err
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    assert ttool.main([images["a"], str(bad)]) == 1
    short = tmp_path / "short.ppm"
    short.write_bytes(b"P3\n2 2\n255\n0 0 0\n")
    assert ttool.main([images["a"], str(short)]) == 1
    assert "error:" in capsys.readouterr().err


def test_usage_exits_2(images, capsys):
    assert ttool.main([images["a"]]) == jtool.main([images["a"]]) == 2
    assert "imgdiff" in capsys.readouterr().err


def test_shape_mismatch_raises(images, tmp_path):
    other = str(tmp_path / "small.png")
    zt.io.write_image(other, _framebuffer(1, (4, 4, 3)))
    with pytest.raises(SystemExit, match="shape mismatch"):
        ttool.main([images["a"], other])
