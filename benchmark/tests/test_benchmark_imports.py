"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: each runs here in a child
process whose importer refuses those names, compared by whole top-level
name (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from benchmark import harness

from conftest import ROOT, TINY

BLOCKER = '''
import sys, importlib.abc
BLOCKED = set({blocked!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
'''
JAX = ["jax", "jaxlib", "flax", "zig_weekend_raytracer_tpu"]


def _child(body: str, blocked):
    code = BLOCKER.format(blocked=blocked, root=ROOT) + body
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_harness_runs_with_jax_blocked():
    body = f'''
import time
from benchmark import harness
argv = ["--workload", "balls.canonical", "--seed", "77", "--seconds", "0.2",
        "--trace", "1", "--device", "cpu", "--traffic", {json.dumps(json.dumps(TINY))}]
rc = harness.main(argv, time.perf_counter())
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print("TOPS", " ".join(tops))
raise SystemExit(rc)
'''
    p = _child(body, JAX)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = next(l for l in p.stdout.splitlines() if l.startswith("TOPS")).split()[1:]
    assert "zig_weekend_raytracer_tpu_torch" in tops
    assert not set(tops) & set(JAX)


def test_reference_imports_nothing_of_the_program():
    body = f'''
import pkgutil, importlib, json
import benchmark.reference as R
for m in pkgutil.walk_packages(R.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
from benchmark import check, control, roofline, spec
cell = spec.resolve(spec.load_spec(), "balls.canonical")
t = {{**cell.traffic, **json.loads({json.dumps(json.dumps(TINY))})}}
scene = check.reference_scene(cell.config_path, "cpu")
xs, ys = check.pixel_sample(5, t["width"], t["height"], t["check_block"])
out = check.reference_pixels(scene, t, 5, xs, ys)
low = control.low_precision_package()
check.reference_pixels(check.reference_scene(cell.config_path, "cpu", package=low), t, 5,
                       xs, ys, package=low)
assert out.shape[1] == 3
print("TOPS", " ".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
'''
    p = _child(body, JAX + ["zig_weekend_raytracer_tpu_torch"])
    assert p.returncode == 0, p.stderr[-3000:]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zig_weekend_raytracer_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert "zig_weekend_raytracer_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
