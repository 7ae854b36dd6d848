"""The PyTorch port imports without JAX and without the JAX package.

A subprocess installs a meta-path hook that refuses ``jax``, ``jaxlib``,
``zig_weekend_raytracer_tpu`` and the repository's JAX ``tools`` before
anything is imported, then imports ``zig_weekend_raytracer_tpu_torch``,
every module in it, and ``chip_smoke``.  The modules of the tree-scene,
image-texture, CLI, FP32-peak, sample-allocation and sharding slices are
named, so that the walk cannot miss them.  A second subprocess runs the
entry points that import lazily (the adaptive, progressive and
supersampled renders, the scene-file loader, the CLI's freed flags, the
sharded renders and ``--shard``, the fixed-depth wavefront of a nested
checker scene, ``texture_value``, the .bmp and .jpg writers, and the user
tools ``scenebench``, ``shard_overhead``, ``lut_quality``,
``quality_prodres`` and ``imgdiff``) with the same hook."""

import os
import subprocess
import sys
import textwrap

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "zig_weekend_raytracer_tpu", "tools")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
"""

_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import zig_weekend_raytracer_tpu_torch as pkg
    names = [pkg.__name__]
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)
        names.append(mod.name)
    for name in ("math.aabb", "math.interval", "geometry.bvh", "ops.closest_hit",
                 "ops.trace", "models.balls", "render.renderer", "io.native",
                 "io.image", "textures", "ops.bounce", "models.earth",
                 "models.shrek_quads", "models.rtw_final", "utils.workcount",
                 "utils.roofline", "cli", "utils.profiler", "utils.argparser",
                 "utils.timer", "io.ppm", "models.emissive", "tools",
                 "tools.fp32_peak", "render.progressive", "render.adaptive",
                 "render.adaptive_device", "models.scenefile", "parallel",
                 "parallel.mesh", "parallel.render", "io.bmp", "io.jpeg",
                 "tools.golden_check", "tools.scenebench", "tools.shard_overhead",
                 "tools.lut_quality", "tools.quality_prodres", "tools.imgdiff",
                 "tools.bench"):
        assert pkg.__name__ + "." + name in names, name
    import chip_smoke
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print(len(names))
    """
)


_RUN = _BLOCK + textwrap.dedent(
    """
    import os, tempfile
    import numpy as np
    import torch
    import zig_weekend_raytracer_tpu_torch as zt
    from zig_weekend_raytracer_tpu_torch import cli
    from zig_weekend_raytracer_tpu_torch.render.progressive import ProgressiveRenderer

    scene = zt.models.load_scene_file(os.path.join(
        "zig_weekend_raytracer_tpu_torch", "models", "cornell_box.json"), device="cpu")
    r = zt.render.Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, russian_roulette=1,
                           clamp_indirect=2.0, balance_min_spp=1, regen_min_wave=1)
    r.render(scene, 4, 4)
    r.render_adaptive(scene, 4, 4)
    r.render_supersampled(scene, 4, 4, k=2)
    mesh = zt.parallel.make_mesh(2, device="cpu")
    for shard in ("samples", "rows"):
        zt.parallel.render_sharded(scene, 4, 4, 8, max_depth=3, mesh=mesh, shard=shard)
        zt.parallel.render_adaptive_sharded(scene, 4, 4, 8, max_depth=3, mesh=mesh, shard=shard)
    b = zt.scene.SceneBuilder()
    img = b.image_texture(np.full((2, 2, 3), 200, np.uint8))
    inner = b.checkerboard(2.0, b.solid_color((1, 0, 0)), img)
    b.add(b.quad((-4, -4, 0), (8, 0, 0), (0, 8, 0),
                 b.lambertian(b.checkerboard(0.25, inner, b.solid_color((0, 0, 1))))))
    b.set_camera(zt.scene.Camera(look_from=(0, 0, 9), look_at=(0, 0, 0)))
    b.set_background((1.0, 1.0, 1.0))
    nested = b.compile(device="cpu")
    bounces = zt.render.integrator.trace_paths.bounces
    fb = zt.render.Renderer(samples_per_pixel=2, max_ray_bounce_depth=2).render(nested, 4, 4)
    assert zt.render.integrator.trace_paths.bounces > bounces
    zero = torch.zeros(3)
    zt.textures.texture_value(nested.compiled, torch.tensor([0, 1, 2], dtype=torch.int32),
                              zero, zero, zt.math.v3.V3(zero, zero, zero))
    with tempfile.TemporaryDirectory() as tmp:
        for ext in ("bmp", "jpg"):
            zt.io.write_image(os.path.join(tmp, "n." + ext), fb)
        ProgressiveRenderer(r, os.path.join(tmp, "c.npz")).render(scene, 4, 4, batch_spp=4)
        ProgressiveRenderer(r, os.path.join(tmp, "s.npz"), shard="rows", mesh=mesh).render(
            scene, 4, 4, batch_spp=4)
        assert cli.main(["--image_width=4", "--image_height=4", "--samples_per_pixel=4",
                         "--adaptive=1", "--russian_roulette=1",
                         "--image_out_path=" + os.path.join(tmp, "a.ppm")], device="cpu") == 0
        assert cli.main(["--image_width=4", "--image_height=4", "--samples_per_pixel=4",
                         "--shard=samples", "--image_out_path=" + os.path.join(tmp, "s.ppm")],
                        device="cpu") == 0
        from zig_weekend_raytracer_tpu_torch.tools import (
            imgdiff, lut_quality, quality_prodres, scenebench, shard_overhead)
        tiny = ["4", "4", "2", "2", "1", "--device=cpu"]
        assert scenebench.main(["cornell_box", *tiny, "--denoise=1"]) == 0
        assert shard_overhead.main(tiny) == 0
        assert lut_quality.main(["shrek_quads", "64", "--spp=2", "--size=4", "--depth=2",
                                 "--device=cpu"]) == 0
        assert quality_prodres.main(["cornell_box", "--size=4", "--spp=2", "--seeds=1",
                                     "--ref_spp=2", "--device=cpu"]) == 0
        assert imgdiff.main([os.path.join(tmp, "a.ppm"), os.path.join(tmp, "s.ppm")]) == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("ran")
    """
)


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_port_imports_with_jax_blocked():
    proc = _run(_SCRIPT)
    assert proc.returncode == 0, proc.stderr
    # the package, its subpackages and every module in them
    assert int(proc.stdout.strip().splitlines()[-1]) >= 30, proc.stdout


def test_slice_entry_points_run_with_jax_blocked():
    proc = _run(_RUN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ran"
