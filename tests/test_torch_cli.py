"""The port's CLI on the CPU, against the JAX package's CLI.

  1. Every flag parses to the same ``UserArgs`` values as the JAX parser
     (enums by value), and the usage text is identical.
  2. ``--help`` exits 0 and bad flags exit 1, both with the usage text on
     stderr.
  3. ``--shard=samples`` and ``--shard=rows`` on ``ZWRT_CPU_DEVICES=8``
     write the PPM of the in-process ``render_sharded`` on 8 CPU entries,
     byte for byte, and pixels within +-1 level on at most 1% of those of
     the JAX CLI's PPM for the same flags (its 8 virtual CPU devices;
     emissive 16x16 as in 4.); with ``--adaptive`` and ``--checkpoint``
     ``--shard=samples`` writes the in-process sharded renders' bytes
     (cornell 8x8); an unknown mode exits 1.  The JAX CLI's
     combination rules exit 1 with its messages.  The estimator and
     driver flags (``--russian_roulette``, ``--clamp_indirect``,
     ``--adaptive``, ``--checkpoint``, ``--supersample``) write the PPM of
     the same render made in process, byte for byte; ``--checkpoint`` run
     twice resumes; a ``--scene_file``
     of cornell writes ``--scene=cornell_box``'s bytes, and a bad file
     exits 1 with the JAX CLI's message.
  4. ``main([... emissive 16x16 ...], device="cpu")`` logs the three stage
     lines and the ``stats:`` line, and writes a PPM whose pixels equal
     those of the JAX CLI's PPM for the same flags, to +-1 level on at most
     1% of pixels; a ``--texture_lut`` render takes the whole-render path.
  5. The native writer's bytes equal the numpy encoder's and the JAX
     package's writer's for a seeded framebuffer; a failed write raises.
     ``--image_out_path=x.jpg|x.jpeg|x.BMP`` writes the image, which the
     port's decoder reads back: a BMP to the PPM's pixels, a JPEG to
     within its loss; ``write_image`` writes .png, .jpg, .jpeg and .bmp.
  6. ``--profile=host`` prints the zone table, with the bounce kernel's
     counters and driver spans on an image scene without a LUT; the device
     table's zones are the kernels' names.
  7. ``--aov`` writes three PNGs whose pixels (decoded with PIL, here only)
     equal those the JAX package's ``write_aovs`` writes for the same
     buffers; ``--denoise`` runs the AOV pass and the filter; ``--stats``
     counts the AOV pass's paths as the JAX package's tests/test_aov.py
     expects; the PNG encoder's files decode to their pixels; and the port
     never imports PIL (nor JAX) on these paths.
"""

import dataclasses
import enum
import json
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
from zig_weekend_raytracer_tpu import cli as jcli
from zig_weekend_raytracer_tpu.io import ppm as jppm
from zig_weekend_raytracer_tpu_torch import cli as tcli
from zig_weekend_raytracer_tpu_torch.io import native as tnative
from zig_weekend_raytracer_tpu_torch.io import ppm as tppm
from zig_weekend_raytracer_tpu_torch.io.jpeg import write_jpeg
from zig_weekend_raytracer_tpu_torch.render import integrator
from zig_weekend_raytracer_tpu_torch.utils import profiler
from zig_weekend_raytracer_tpu_torch.utils.argparser import ArgParser, ParseArgsError

STAGES = ("scene initialized", "scene rendered", "scene written to file")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(args) -> dict:
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(args).items()}


def _read_ppm(path) -> np.ndarray:
    tok = open(path, "rb").read().split()
    assert tok[0] == b"P3" and tok[3] == b"255"
    w, h = int(tok[1]), int(tok[2])
    return np.array([int(t) for t in tok[4:]], np.int32).reshape(h, w, 3)


# ---- 1. flags and usage ----

@pytest.mark.parametrize("argv", [
    ["--image_width=4", "--image_height=3"],
    ["--image_width=400", "--image_height=200", "--image_out_path=x.png",
     "--thread_pool_size=3", "--scene=rtw_final", "--samples_per_pixel=64",
     "--ray_bounce_max_depth=8", "--sampler=stratified", "--seed=7",
     "--asset_dir=/a", "--texture_lut=32768", "--stats=true", "--profile=device"],
    ["--image_width=1", "--image_height=1", "--scene_file=s.json", "--shard=rows",
     "--russian_roulette=3", "--clamp_indirect=2.5", "--adaptive=1",
     "--checkpoint=c.npz", "--checkpoint_batch_spp=4", "--denoise=2",
     "--supersample=2", "--aov=true", "--stats=false", "--profile=true"],
    ["--image_width=8", "--image_height=8", "--scene=earth", "--sampler=independent"],
])
def test_flags_parse_as_jax(argv):
    assert [f.name for f in dataclasses.fields(tcli.UserArgs)] == [
        f.name for f in dataclasses.fields(jcli.UserArgs)]
    assert _values(ArgParser(tcli.UserArgs).parse(argv)) == _values(
        ArgParser(jcli.UserArgs).parse(argv))


def test_usage_is_jax_usage():
    assert ArgParser(tcli.UserArgs).usage() == ArgParser(jcli.UserArgs).usage()
    assert [s.value for s in tcli.SceneType] == [s.value for s in jcli.SceneType]


# ---- 2. help and bad flags ----

def test_help_exits_0(capsys):
    assert tcli.main(["--help"], device="cpu") == 0
    assert capsys.readouterr().err == ArgParser(tcli.UserArgs).usage() + "\n"


@pytest.mark.parametrize("argv", [
    ["--image_width=8", "--image_height=8", "--scene=bogus"],
    ["--image_width=8"],
    ["--image_width=8", "--image_height=8", "--nope=1"],
    ["--image_width=eight", "--image_height=8"],
])
def test_bad_flags_exit_1_with_usage(argv, capsys):
    assert tcli.main(argv, device="cpu") == 1
    err = capsys.readouterr().err
    assert ArgParser(tcli.UserArgs).usage() in err and "error:" in err
    with pytest.raises(ParseArgsError):
        ArgParser(jcli.UserArgs).parse(argv)


def test_bad_profile_mode_exits_1(capsys):
    assert tcli.main(["--image_width=8", "--image_height=8", "--profile=gpu"], device="cpu") == 1
    assert "unknown --profile mode" in capsys.readouterr().err


# ---- 3. --shard, combination rules, the freed flags ----

CORNELL_FILE = os.path.join(REPO, "zig_weekend_raytracer_tpu_torch", "models", "cornell_box.json")


SHARD_FLAGS = ["--image_width=16", "--image_height=16", "--samples_per_pixel=2",
               "--ray_bounce_max_depth=3"]


@pytest.mark.parametrize("flag,n", [("--shard=samples", 8), ("--shard=rows", 8)])
def test_later_slice_flags_exit_1(flag, n, tmp_path, monkeypatch):
    """``--shard`` renders (the name is the test's from when it exited 1)."""
    from zig_weekend_raytracer_tpu_torch import models
    from zig_weekend_raytracer_tpu_torch.parallel import make_mesh, render_sharded

    monkeypatch.setenv("ZWRT_CPU_DEVICES", str(n))
    out = tmp_path / "t.ppm"
    assert tcli.main(SHARD_FLAGS + [flag, f"--image_out_path={out}"], device="cpu") == 0
    want = render_sharded(models.load_scene("emissive", device="cpu"), 16, 16, 2, 3,
                          mesh=make_mesh(n, device="cpu"), shard=flag.split("=")[1])
    tppm.write_ppm(str(tmp_path / "want.ppm"), want.numpy())
    assert out.read_bytes() == (tmp_path / "want.ppm").read_bytes()
    assert jcli.main(SHARD_FLAGS + [flag, f"--image_out_path={tmp_path / 'j.ppm'}"]) == 0
    got, jax_px = _read_ppm(out), _read_ppm(tmp_path / "j.ppm")
    diff = np.abs(got - jax_px).max(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("flag", ["--adaptive=4", "--checkpoint"])
def test_shard_flag_combines_with_drivers(flag, tmp_path, monkeypatch):
    from zig_weekend_raytracer_tpu_torch import models
    from zig_weekend_raytracer_tpu_torch.parallel import make_mesh, render_adaptive_sharded
    from zig_weekend_raytracer_tpu_torch.render import Renderer
    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer

    monkeypatch.setenv("ZWRT_CPU_DEVICES", "3")
    scene = models.load_scene("cornell_box", device="cpu")
    mesh = make_mesh(3, device="cpu")
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=8",
            "--ray_bounce_max_depth=4", "--scene=cornell_box", "--shard=samples",
            f"--image_out_path={tmp_path / 't.ppm'}"]
    if flag == "--checkpoint":
        argv += [f"--checkpoint={tmp_path / 'c.npz'}", "--checkpoint_batch_spp=4"]
        r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=4)
        want = ProgressiveRenderer(r, str(tmp_path / "ref.npz"), shard="samples",
                                   mesh=mesh).render(scene, 8, 8, batch_spp=4)
    else:
        argv.append(flag)
        want = render_adaptive_sharded(scene, 8, 8, 8, 4, mesh=mesh, pilot_spp=4).numpy()
    assert tcli.main(argv, device="cpu") == 0
    tppm.write_ppm(str(tmp_path / "want.ppm"), want)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "want.ppm").read_bytes()


def test_unknown_shard_mode_exits_1(tmp_path, capsys):
    argv = SHARD_FLAGS + ["--shard=tiles", f"--image_out_path={tmp_path / 'x.ppm'}"]
    assert tcli.main(argv, device="cpu") == 1
    assert "error: unknown --shard mode 'tiles'" in capsys.readouterr().err
    assert not (tmp_path / "x.ppm").exists()


@pytest.mark.parametrize("flags", [
    ["--checkpoint=c.npz", "--adaptive=1"],
    ["--checkpoint=c.npz", "--checkpoint_batch_spp=0"],
    ["--supersample=0"],
    ["--supersample=2", "--adaptive=1"],
    ["--supersample=2", "--checkpoint=c.npz"],
    ["--supersample=2", "--shard=rows"],
    ["--supersample=3", "--samples_per_pixel=8"],
])
def test_combination_rules_exit_1_as_jax(flags, tmp_path, capsys):
    argv = ["--image_width=4", "--image_height=4", "--samples_per_pixel=4",
            f"--image_out_path={tmp_path / 'x.ppm'}"] + flags
    assert tcli.main(argv, device="cpu") == 1
    got = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error:")]
    assert jcli.main(argv) == 1
    want = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error:")]
    assert got == want and len(got) == 1
    assert not (tmp_path / "x.ppm").exists()


def _in_process(flag, tmp_path):
    """The framebuffer the CLI's render of ``flag`` must write: the same
    render made in this process (cornell 8x8, 8 spp, depth 4)."""
    from zig_weekend_raytracer_tpu_torch import models
    from zig_weekend_raytracer_tpu_torch.render import Renderer
    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer

    scene = models.load_scene("cornell_box", device="cpu")
    name, _, value = flag[2:].partition("=")
    opts = {}
    if name == "russian_roulette":
        opts = {"russian_roulette": int(value)}
    if name == "clamp_indirect":
        opts = {"clamp_indirect": float(value)}
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=4, **opts)
    if name == "adaptive":
        return r.render_adaptive(scene, 8, 8).numpy()
    if name == "checkpoint":
        return ProgressiveRenderer(r, str(tmp_path / "ref.npz")).render(scene, 8, 8, batch_spp=4)
    if name == "supersample":
        return r.render_supersampled(scene, 8, 8, k=int(value)).numpy()
    return r.render(scene, 8, 8)


@pytest.mark.parametrize("flag", [
    "--russian_roulette=2", "--clamp_indirect=0.5", "--adaptive=1", "--checkpoint",
    "--supersample=2",
])
def test_freed_flags_write_the_in_process_render(flag, tmp_path):
    out = tmp_path / "t.ppm"
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=8",
            "--ray_bounce_max_depth=4", "--scene=cornell_box", f"--image_out_path={out}"]
    if flag == "--checkpoint":
        argv += [f"--checkpoint={tmp_path / 'c.npz'}", "--checkpoint_batch_spp=4"]
    else:
        argv.append(flag)
    assert tcli.main(argv, device="cpu") == 0
    tppm.write_ppm(str(tmp_path / "want.ppm"), _in_process(flag, tmp_path))
    assert out.read_bytes() == (tmp_path / "want.ppm").read_bytes()


def test_checkpoint_flag_resumes(tmp_path, caplog):
    ck = tmp_path / "c.npz"
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=8",
            "--ray_bounce_max_depth=4", "--scene=cornell_box", f"--checkpoint={ck}",
            "--checkpoint_batch_spp=4"]
    assert tcli.main(argv + [f"--image_out_path={tmp_path / 'a.ppm'}"], device="cpu") == 0
    assert int(np.load(ck)["samples_done"]) == 8
    with caplog.at_level(logging.INFO, logger="zwrt"):
        assert tcli.main(argv + [f"--image_out_path={tmp_path / 'b.ppm'}"], device="cpu") == 0
    assert any("resuming render from checkpoint: 8/8" in r.getMessage() for r in caplog.records)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()


def test_scene_file_flag_writes_the_builtin_scene(tmp_path):
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=4",
            "--ray_bounce_max_depth=4"]
    assert tcli.main(argv + [f"--scene_file={CORNELL_FILE}",
                             f"--image_out_path={tmp_path / 'f.ppm'}"], device="cpu") == 0
    assert tcli.main(argv + ["--scene=cornell_box", f"--image_out_path={tmp_path / 'b.ppm'}"],
                     device="cpu") == 0
    assert (tmp_path / "f.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()


def test_scene_file_error_is_clean_as_jax(tmp_path, capsys):
    argv = ["--image_width=4", "--image_height=4", f"--scene_file={tmp_path}/missing.json",
            f"--image_out_path={tmp_path / 'x.ppm'}"]
    assert tcli.main(argv, device="cpu") == 1
    got = capsys.readouterr().err
    assert jcli.main(argv) == 1
    want = capsys.readouterr().err
    assert got.startswith(f"error: --scene_file {tmp_path}/missing.json: ") and got == want
    assert not (tmp_path / "x.ppm").exists()


@pytest.mark.parametrize("ext", ["jpg", "jpeg", "BMP"])
def test_refused_image_formats_exit_1_before_the_render(ext, tmp_path, capsys, caplog):
    """.jpg, .jpeg and .bmp in any case are written (the name is the
    test's from when the CLI refused them): exit 0 with the three stage
    lines, and the file decodes (the port's stb_image) to the pixels of
    the same render's PPM, exactly for a BMP, within a JPEG's loss."""
    out = tmp_path / f"x.{ext}"
    flags = ["--image_width=16", "--image_height=16", "--samples_per_pixel=2",
             "--ray_bounce_max_depth=3"]
    with caplog.at_level(logging.INFO, logger="zwrt"):
        assert tcli.main(flags + [f"--image_out_path={out}"], device="cpu") == 0
    assert [r.getMessage().split("\t")[1] for r in caplog.records
            if r.name == "zwrt"] == list(STAGES)
    assert tcli.main(flags + [f"--image_out_path={tmp_path / 'x.ppm'}"], device="cpu") == 0
    want = _read_ppm(tmp_path / "x.ppm")
    got = tnative.decode_image(out.read_bytes()).astype(np.int32)
    assert got.shape == want.shape == (16, 16, 3)
    if ext == "BMP":
        np.testing.assert_array_equal(got, want)
    else:
        assert out.read_bytes()[:3] == b"\xff\xd8\xff" and np.abs(got - want).mean() < 8


# ---- 4. renders ----

def test_emissive_cli_matches_jax_cli(tmp_path, capsys, caplog):
    flags = ["--image_width=16", "--image_height=16", "--samples_per_pixel=2",
             "--ray_bounce_max_depth=3"]
    with caplog.at_level(logging.INFO, logger="zwrt"):
        assert tcli.main(flags + [f"--image_out_path={tmp_path / 't.ppm'}", "--stats=true"],
                         device="cpu") == 0
    logged = [r.getMessage() for r in caplog.records if r.name == "zwrt"]
    assert [m.split("\t")[1] for m in logged] == list(STAGES)
    assert capsys.readouterr().out.startswith("stats: 512 paths in ")
    assert jcli.main(flags + [f"--image_out_path={tmp_path / 'j.ppm'}"]) == 0
    got, want = _read_ppm(tmp_path / "t.ppm"), _read_ppm(tmp_path / "j.ppm")
    assert got.shape == want.shape == (16, 16, 3) and got.max() > 0
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_texture_lut_flag_takes_the_whole_render_path(tmp_path):
    calls, passes = integrator.render_fused_reference.calls, integrator.trace_paths_regen.passes
    out = tmp_path / "s.ppm"
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=1",
            "--ray_bounce_max_depth=2", "--scene=shrek_quads", "--texture_lut=8192",
            f"--image_out_path={out}"]
    assert tcli.main(argv, device="cpu") == 0
    assert integrator.render_fused_reference.calls > calls
    assert integrator.trace_paths_regen.passes == passes
    assert _read_ppm(out).shape == (8, 8, 3)


# ---- 5. the writer ----

def test_native_writer_bytes(tmp_path):
    fb = np.random.default_rng(5).uniform(-0.1, 1.3, (7, 11, 3)).astype(np.float32)
    fb[0, 0, 0] = np.nan
    pixels = tppm.encode_pixels(fb)
    np.testing.assert_array_equal(pixels, jppm.encode_pixels(fb))
    tppm.write_ppm(str(tmp_path / "t.ppm"), fb, n_threads=3)
    jppm.write_ppm(str(tmp_path / "j.ppm"), fb)
    got = (tmp_path / "t.ppm").read_bytes()
    assert got == tppm.encode_ppm_bytes(pixels) == (tmp_path / "j.ppm").read_bytes()
    tppm.write_image(str(tmp_path / "w.ppm"), fb)
    assert (tmp_path / "w.ppm").read_bytes() == got
    with pytest.raises(OSError, match="native PPM write failed at open"):
        tnative.write_ppm(str(tmp_path / "missing" / "x.ppm"), pixels)
    with pytest.raises(ValueError, match="uint8"):
        tnative.write_ppm(str(tmp_path / "f.ppm"), fb)


# ---- 6. profiler ----

def test_profile_host_prints_zones(tmp_path, capsys):
    profiler.reset_zones()
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=1",
            "--ray_bounce_max_depth=2", "--scene=cornell_box", "--profile=host",
            f"--image_out_path={tmp_path / 'c.ppm'}"]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].split()[:2] == ["zone", "count"]
    assert "Renderer::render" in out and "rayColorLine" in out
    assert not profiler.profiling_enabled()  # restored after the run
    profiler.reset_zones()


def test_profile_host_prints_k2_counters_and_regen_spans(tmp_path, capsys):
    # an image-textured sphere (a seeded image, no LUT: the bounce kernel's
    # regenerating mode) under a quad light, as a scene file
    img = np.random.default_rng(22).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    write_jpeg(str(tmp_path / "tex.jpg"), img)
    doc = {"background": [0.2, 0.2, 0.3],
           "camera": {"look_from": [0, 0.5, 4], "look_at": [0, 0, 0]},
           "textures": {"tex": {"image": "tex.jpg"}, "lamp": {"solid": [4, 4, 4]}},
           "materials": {"tex": {"lambertian": "tex"}, "lamp": {"diffuse_light": "lamp"}},
           "entities": [
               {"sphere": {"center": [0, 0, 0], "radius": 1, "material": "tex"}},
               {"quad": {"start": [-1, 2, -1], "edge_u": [2, 0, 0], "edge_v": [0, 0, 2],
                         "material": "lamp"}, "light": True}]}
    (tmp_path / "atlas.json").write_text(json.dumps(doc))
    profiler.reset_zones()
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=2",
            "--ray_bounce_max_depth=2", f"--scene_file={tmp_path / 'atlas.json'}",
            f"--image_out_path={tmp_path / 'a.ppm'}", "--profile=host"]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    for name in ("render.regen.launch", "render.regen.launch.wait", "render.regen.poll",
                 "k2.launches", "k2.lane_work", "k2.warp_work"):
        assert name in out, name
    profiler.reset_zones()


def test_device_zones_are_kernel_names():
    agg = profiler.aggregate_device_events([
        ("void zwrt::fused_render_kernel<true>(zwrt::Params, ...)", 1500.0),
        ("void zwrt::fused_render_kernel<false>(zwrt::Params, ...)", 500.0),
        ("void zwrt::bounce_kernel<false>(...)", 250.0),
        ("zwrt::closest_hit_kernel(...)", 100.0),
    ])
    assert agg == {"fused_render_kernel": (2, 2.0), "bounce_kernel": (1, 0.25),
                   "closest_hit_kernel": (1, 0.1)}
    table = profiler.format_device_summary(agg)
    assert table.splitlines()[1].startswith("fused_render_kernel") and "TOTAL" in table


# ---- 7. the AOV pass, the denoiser and PNG output ----

def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def test_aov_flag_writes_jax_pngs(tmp_path, caplog):
    from zig_weekend_raytracer_tpu.render import aov as jaov
    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs

    out = tmp_path / "a.ppm"
    argv = ["--image_width=12", "--image_height=10", "--samples_per_pixel=1",
            "--ray_bounce_max_depth=2", "--scene=cornell_box", "--aov=true",
            f"--image_out_path={out}"]
    with caplog.at_level(logging.INFO, logger="zwrt"):
        assert tcli.main(argv, device="cpu") == 0
    stages = [r.getMessage().split("\t")[-1] for r in caplog.records if r.name == "zwrt"]
    assert stages == ["scene initialized", "scene rendered", "aovs rendered (4 spp)",
                      "scene written to file", "aovs written"]
    scene = tcli.load_scene("cornell_box", device="cpu")
    aovs = {k: v.numpy() for k, v in render_aovs(scene, 12, 10, spp=4).items()}
    want = jaov.write_aovs(str(tmp_path / "j.ppm"), aovs)
    for name, ref in zip(("albedo", "normal", "depth"), want):
        got = _png(f"{out}.{name}.png")
        assert got.shape == ((10, 12, 3) if name != "depth" else (10, 12))
        np.testing.assert_array_equal(got, _png(ref), err_msg=name)
    assert _read_ppm(out).shape == (10, 12, 3)


def test_denoise_flag_runs(tmp_path, caplog):
    out = tmp_path / "d.png"
    argv = ["--image_width=16", "--image_height=16", "--samples_per_pixel=2",
            "--ray_bounce_max_depth=3", "--scene=cornell_box", "--denoise=2",
            f"--image_out_path={out}"]
    with caplog.at_level(logging.INFO, logger="zwrt"):
        assert tcli.main(argv, device="cpu") == 0
    stages = [r.getMessage().split("\t")[-1] for r in caplog.records if r.name == "zwrt"]
    assert "aovs rendered (4 spp)" in stages and "denoised" in stages
    img = _png(out)
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert not (tmp_path / "d.png.albedo.png").exists()


@pytest.mark.parametrize("flags,total,split", [
    (["--denoise=1"], "384", True), (["--aov=true"], "384", True), ([], "128", False),
])
def test_stats_counts_the_aov_pass(flags, total, split, tmp_path, capsys):
    argv = ["--image_width=8", "--image_height=8", "--samples_per_pixel=2",
            "--ray_bounce_max_depth=2", "--scene=cornell_box", "--stats=true",
            f"--image_out_path={tmp_path / 's.ppm'}", *flags]
    assert tcli.main(argv, device="cpu") == 0
    stats = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("stats:")]
    assert len(stats) == 1
    # 8 x 8 x 2 beauty paths, plus 8 x 8 x 4 of the AOV pass
    assert stats[0].startswith(f"stats: {total} paths in ")
    assert ("aov pass 256 paths" in stats[0] and "beauty 128 paths" in stats[0]) == split


@pytest.mark.parametrize("shape", [(5, 7, 3), (6, 4), (1, 1, 3)])
def test_png_encoder_decodes_to_its_pixels(shape, tmp_path):
    from zig_weekend_raytracer_tpu_torch.io import png

    px = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    png.write_png(str(tmp_path / "p.png"), px)
    np.testing.assert_array_equal(_png(tmp_path / "p.png"), px)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(px.astype(np.float32))


def test_write_image_png_and_refused_formats(tmp_path):
    """Every format of the JAX package's write_image (the name is the
    test's from when the port refused three): .png and .bmp decode to the
    encoded pixels, .jpg and .jpeg to a JPEG of them."""
    fb = np.random.default_rng(3).uniform(0, 1, (4, 5, 3)).astype(np.float32)
    tppm.write_image(str(tmp_path / "w.png"), fb)
    np.testing.assert_array_equal(_png(tmp_path / "w.png"), jppm.encode_pixels(fb))
    tppm.write_image(str(tmp_path / "w.bmp"), fb)
    np.testing.assert_array_equal(_png(tmp_path / "w.bmp"), jppm.encode_pixels(fb))
    for ext in ("jpg", "jpeg"):
        tppm.write_image(str(tmp_path / f"w.{ext}"), fb)
        got = _png(tmp_path / f"w.{ext}")
        assert got.shape == (4, 5, 3) and got.dtype == np.uint8


_NO_PIL = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("PIL", "jax", "jaxlib", "zig_weekend_raytracer_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import zig_weekend_raytracer_tpu_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)
    from zig_weekend_raytracer_tpu_torch import cli
    out = sys.argv[1]
    rc = cli.main(["--image_width=6", "--image_height=6", "--samples_per_pixel=1",
                   "--ray_bounce_max_depth=2", "--scene=cornell_box", "--aov=true",
                   "--denoise=1", "--image_out_path=" + out], device="cpu")
    assert rc == 0, rc
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ok")
    """
)


def test_port_never_imports_pil(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PIL, str(tmp_path / "n.png")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "n.png", "n.png.albedo.png", "n.png.depth.png", "n.png.normal.png"]
