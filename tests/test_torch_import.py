"""The PyTorch port imports without JAX and without the JAX package.

A subprocess installs a meta-path hook that refuses ``jax``, ``jaxlib``,
``zig_weekend_raytracer_tpu`` and the repository's JAX ``tools`` before
anything is imported, then imports ``zig_weekend_raytracer_tpu_torch``,
every module in it, and ``chip_smoke``.  The modules of the tree-scene,
image-texture, CLI and FP32-peak slices are named, so that the walk cannot
miss them."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
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
                 "tools.fp32_peak"):
        assert pkg.__name__ + "." + name in names, name
    import chip_smoke
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    # the package, its subpackages and every module in them
    assert int(proc.stdout.strip().splitlines()[-1]) >= 30, proc.stdout
