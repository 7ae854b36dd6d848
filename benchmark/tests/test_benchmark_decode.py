"""The reference's own image decoder (``benchmark/reference/io/decode.py``):
its texels equal the program's stb_image decode bit for bit, on the
repository's images and on JPEGs and PNGs made here; what it does not
decode raises ``ValueError`` naming the file; and a scene file with an image
texture compiles to the program's atlas and reads ``correct`` through
``benchmark/run.py``, while the bfloat16 control, which copies the whole
reference package, decoder included, does not."""

import json
import os
import re
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from benchmark.reference.io.decode import decode_image

from conftest import ROOT, TINY


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _png(px: np.ndarray, ctype: int, depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of (H, W, C) uint8 ``px`` whose rows cycle through the five
    filter types (PNG spec section 9)."""
    h, w, c = px.shape
    prev = np.zeros(w * c, np.int64)
    rows = []
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int64)
        a = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        pa, pb, pc = np.abs(prev - up_left), np.abs(a - up_left), np.abs(a + prev - 2 * up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, up_left))
        f = y % 5
        pred = (0, a, prev, (a + prev) >> 1, paeth)[f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


def _random(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _encoded_jpeg(w, h, seed):
    from zig_weekend_raytracer_tpu_torch.io.jpeg import encode_jpeg

    return encode_jpeg(_random((h, w, 3), seed))


# name -> (file bytes, the pixels it holds exactly, or None for a lossy file)
def _case(name):
    if name.startswith("assets/"):
        with open(os.path.join(ROOT, name), "rb") as f:
            return f.read(), None
    kind, size = name.split("_")
    w, h = (int(v) for v in size.split("x"))
    seed = w * 1000 + h
    if kind == "encoder":                 # the program's 4:2:0 encoder
        return _encoded_jpeg(w, h, seed), None
    if kind == "rgbids":                  # components named R, G, B: read as RGB
        data = _encoded_jpeg(w, h, seed)
        sof, sos = b"\x01\x22\x00\x02\x11\x01\x03\x11\x01", b"\x03\x01\x00\x02\x11\x03\x11"
        assert data.count(sof) == data.count(sos) == 1
        return data.replace(sof, b"R\x22\x00G\x11\x01B\x11\x01").replace(
            sos, b"\x03R\x00G\x11B\x11"), None
    channels = {"pngrgb": (3, 2), "pngrgba": (4, 6), "pnggrey": (1, 0)}
    if kind in channels:
        c, ctype = channels[kind]
        px = _random((h, w, c), seed)
        rgb = px[:, :, :3] if c >= 3 else np.repeat(px, 3, axis=2)
        return _png(px, ctype), rgb
    px = _random((h, w, 3), seed)        # ppm
    return b"P6\n# made here\n%d %d\n255\n" % (w, h) + px.tobytes(), px


CASES = ["assets/wap.jpg", "assets/me.jpg", "assets/earth.png", "encoder_37x23",
         "encoder_1x1", "encoder_16x16", "encoder_33x17", "encoder_2x40", "pngrgb_37x23",
         "rgbids_19x9", "pngrgba_9x7", "pnggrey_11x6", "ppm_7x3"]


@pytest.mark.parametrize("name", CASES)
def test_texels_equal_stb_image(name, tmp_path):
    from zig_weekend_raytracer_tpu_torch.io.native import decode_image as stb_decode

    data, exact = _case(name)
    path = tmp_path / os.path.basename(name).replace("_", ".")
    path.write_bytes(data)
    ours = decode_image(str(path))
    theirs = stb_decode(data)
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)
    if exact is not None:
        assert np.array_equal(ours, exact)


def _sof(marker: int, precision: int = 8, components: int = 1) -> bytes:
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(components))
    body = bytes([precision]) + struct.pack(">HH", 8, 8) + bytes([components]) + comps
    return b"\xff\xd8\xff" + bytes([marker]) + struct.pack(">H", 2 + len(body)) + body


UNSUPPORTED = {
    "progressive.jpg": (_sof(0xC2), "progressive"),
    "arithmetic.jpg": (_sof(0xC9), "arithmetic"),
    "twelve_bit.jpg": (_sof(0xC1, precision=12), "12-bit"),
    "cmyk.jpg": (_sof(0xC0, components=4), "CMYK"),
    "interlaced.png": (_png(_random((4, 4, 3), 1), 2, interlace=1), "interlaced"),
    "sixteen_bit.png": (_png(_random((4, 4, 3), 2), 2, depth=16), "16-bit"),
    "palette.png": (_png(_random((4, 4, 1), 3), 3), "colour type 3"),
    "grey_alpha.png": (_png(_random((4, 4, 2), 4), 4), "colour type 4"),
    "grey.pgm": (b"P5\n4 4\n255\n" + bytes(16), "not a JPEG, PNG"),
    "deep.ppm": (b"P6\n1 1\n65535\n" + bytes(6), "maxval"),
    "missing.jpg": (None, "cannot read"),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_what_is_not_decoded_raises_naming_the_file(name, tmp_path):
    data, what = UNSUPPORTED[name]
    path = tmp_path / name
    if data is not None:
        path.write_bytes(data)
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*" + re.escape(what)):
        decode_image(str(path))


def write_image_scene(directory) -> str:
    """A scene file with one image-textured sphere (a JPEG of the program's
    encoder beside it) and one quad under a sky; returns its path."""
    with open(os.path.join(directory, "tiny.jpg"), "wb") as f:
        f.write(_encoded_jpeg(37, 23, 7))
    doc = {
        "background": [0.7, 0.8, 1.0],
        "camera": {"look_from": [0, 1, -4], "look_at": [0, 0.5, 0], "vfov_degrees": 40},
        "textures": {"pic": {"image": "tiny.jpg"}, "grey": {"solid": [0.5, 0.5, 0.5]}},
        "materials": {"pic": {"lambertian": "pic"}, "floor": {"lambertian": "grey"}},
        "entities": [
            {"sphere": {"center": [0, 0.5, 0], "radius": 1, "material": "pic"}},
            {"quad": {"start": [-3, -0.5, -3], "edge_u": [6, 0, 0], "edge_v": [0, 0, 6],
                      "material": "floor"}},
        ],
    }
    path = os.path.join(directory, "tiny_image.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_image_scene_compiles_to_the_programs_atlas(tmp_path):
    import torch

    from benchmark import check, control
    from zig_weekend_raytracer_tpu_torch.models.scenefile import load_scene_file

    path = write_image_scene(str(tmp_path))
    program = load_scene_file(path, device="cpu").compiled
    low = control.low_precision_package()
    for package in (check.REFERENCE, low):
        ours = check.reference_scene(path, "cpu", package=package).compiled
        assert ours.has_image_textures and ours.image_dims == program.image_dims == ((37, 23),)
        assert torch.equal(ours.atlas_wh, program.atlas_wh)
        assert ours.atlas_packed.dtype == program.atlas_packed.dtype
        assert torch.equal(ours.atlas_packed, program.atlas_packed)
    assert f"{low}.io.decode" in sys.modules


def _checkout_with_image_cell(tmp_path) -> str:
    """The benchmark's files in ``tmp_path`` with one more cell: the image
    scene under the north star's traffic mix."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    write_image_scene(str(tmp_path / "benchmark" / "configs"))
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_image", "source": "made by this test",
                           "file": "benchmark/configs/tiny_image.json", "reduced": [],
                           "why": "one image-textured sphere and one quad"})
    doc["workloads"].append({"name": "tiny_image.north_star", "config": "tiny_image",
                             "traffic": "north_star", "chips": 1, "why": "image texels"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return "tiny_image.north_star"


def _in_checkout(tmp_path, args):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=env)


def test_image_scene_is_correct_through_run_py(tmp_path):
    cell = _checkout_with_image_cell(tmp_path)
    p = _in_checkout(tmp_path, ["benchmark/run.py", "--workload", cell, "--seed",
                                str(2**31 + 77), "--seconds", "0.2", "--device", "cpu",
                                "--traffic", json.dumps(TINY)])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["compared"]) == ["img_mean_rel", "img_max_rel"]


def test_image_scene_control_is_not_correct(tmp_path):
    cell = _checkout_with_image_cell(tmp_path)
    p = _in_checkout(tmp_path, ["benchmark/control.py", "--workload", cell,
                                "--program-seeds", "12", "--control-seeds", str(2**31 + 9),
                                "--seconds", "0.1", "--device", "cpu",
                                "--traffic", json.dumps(TINY)])
    assert p.returncode == 0, p.stderr[-3000:]
    out = [json.loads(l) for l in p.stdout.strip().splitlines() if l.startswith("{")]
    roles = [o["role"] for o in out[::2]]
    program, low = out[1], out[3]
    assert roles == ["program", "control"]
    assert program["correct"] is True
    assert low["correct"] is False and low["failed"] >= 1
