"""The port's ``tools/scenebench.py`` against the JAX package's, on the CPU
at 8x8, 4 spp, depth 4, one rep: the plain run on cornell_box, balls and
rtw_final, and each flag on cornell_box (``--rr=3``, ``--clamp=10``,
``--adaptive``, ``--shard=samples``, ``--supersample=2``, ``--denoise=3``).

  1. The port's framebuffer (``bench``'s return) against the JAX function
     that the JAX tool calls with the same arguments (``render_device``,
     ``render_adaptive`` under ``pallas_interpret``: JAX's XLA path has no
     adaptive driver and renders uniformly, ``render_sharded`` on JAX's
     mesh, ``render_supersampled``), within rtol 1e-5 / atol 1e-6 on every
     pixel but the named witnesses, where XLA's contracted multiply-adds
     send a path across a grazing hit that the port's unfused arithmetic
     does not: EDGE_PIXELS (the floor/red-wall edge, the image diagonal's
     last quarter: test_torch_parallel.py's ``_edge``, and (7, 7) of
     test_torch_supersample.py), BALLS_PIXELS and RTW_PIXELS, whose lanes
     equal JAX's unfused chain (tests/test_torch_rtw_samplers_witness.py).
  2. The two printed lines agree in scene, size, spp, depth, tag and
     ``nan``; their means agree to the 4 printed decimals but for what the
     witness pixels move (their summed difference over the image's values).
  3. ``--denoise``: the AOV buffers equal JAX's pass run eagerly and differ
     from the jitted pass the JAX tool ran only where that one contracts
     multiply-adds (tests/test_torch_aov.py's witness), the port's filter on the JAX tool's own inputs within rtol 1e-5 /
     atol 1e-6 of JAX's filter (tests/test_torch_denoise.py's bound), and
     the JAX tool's denoise line's mean is that filter's mean.
  4. Flags and devices: the JAX tool's combination rules and messages, an
     unknown flag refused, and without a card the default device exits 1.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_reference_native import reference_decodes_with_stb  # noqa: F401
import zig_weekend_raytracer_tpu as zj
from tools import scenebench as jtool
from zig_weekend_raytracer_tpu.parallel import make_mesh as jmesh
from zig_weekend_raytracer_tpu.parallel import render_sharded as jsharded
from zig_weekend_raytracer_tpu.render import aov as jaov
from zig_weekend_raytracer_tpu.render import denoise as jden
from zig_weekend_raytracer_tpu_torch.render import denoise as tden
from zig_weekend_raytracer_tpu_torch.tools import scenebench as ttool

RTOL, ATOL = 1e-5, 1e-6
SIZE, SPP, DEPTH = 8, 4, 4
ARGS = [str(SIZE), str(SIZE), str(SPP), str(DEPTH), "1"]
EDGE_PIXELS = ((6, 6), (7, 7))
BALLS_PIXELS = ((2, 3),)
RTW_PIXELS = ((4, 2), (3, 3), (4, 3), (6, 5), (7, 5), (0, 6))
WITNESSES = {"cornell_box": EDGE_PIXELS, "balls": BALLS_PIXELS, "rtw_final": RTW_PIXELS}

CASES = {
    "cornell_box": ("cornell_box", []),
    "balls": ("balls", []),
    "rtw_final": ("rtw_final", []),
    "rr": ("cornell_box", ["--rr=3"]),
    "clamp": ("cornell_box", ["--clamp=10"]),
    "adaptive": ("cornell_box", ["--adaptive"]),
    "shard": ("cornell_box", ["--shard=samples"]),
    "supersample": ("cornell_box", ["--supersample=2"]),
    "denoise": ("cornell_box", ["--denoise=3"]),
}


def _jax_fb(scene_name, flags):
    """The framebuffer of the JAX function that the JAX tool calls."""
    scene = zj.models.load_scene(scene_name)
    opts = dict(f[2:].split("=") if "=" in f else (f[2:], "1") for f in flags)
    r = zj.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH,
                           russian_roulette=int(opts.get("rr", 0)),
                           clamp_indirect=float(opts.get("clamp", 0.0)))
    if "--adaptive" in flags:
        return np.asarray(r.render_adaptive(scene, SIZE, SIZE))
    if "shard" in opts:
        return np.asarray(jsharded(scene, SIZE, SIZE, SPP, max_depth=DEPTH, mesh=jmesh(),
                                   shard=opts["shard"]))
    if "supersample" in opts:
        return np.asarray(r.render_supersampled(scene, SIZE, SIZE, k=int(opts["supersample"])))
    return np.asarray(r.render_device(scene, SIZE, SIZE))


def _head(line):
    """(scene size@spp depth tag, nan, mean) of a tool line."""
    head, rest = line.split(": best ")
    fields = dict(kv.split("=") for kv in rest.split(", ")[-2:])
    return head, fields["nan"], float(fields["mean"])


def _keep(witnesses):
    keep = np.ones((SIZE, SIZE), bool)
    for x, y in witnesses:
        keep[y, x] = False
    return keep


def _run_both(monkeypatch, capsys, scene_name, flags):
    monkeypatch.setattr(sys, "argv", ["scenebench.py", scene_name, *ARGS, *flags])
    jtool.main()
    want = capsys.readouterr().out.splitlines()
    out = ttool.bench([scene_name, *ARGS, *flags, "--device=cpu"])
    got = capsys.readouterr().out.splitlines()
    return out, got, want


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_tool(request, monkeypatch, capsys, case):
    scene_name, flags = CASES[case]
    if case == "adaptive":
        request.getfixturevalue("pallas_interpret")
    out, got, want = _run_both(monkeypatch, capsys, scene_name, flags)
    assert len(got) == len(want) == (2 if case == "denoise" else 1)
    fb_t, fb_j = out["fb"].numpy(), _jax_fb(scene_name, flags)
    assert fb_t.shape == fb_j.shape == (SIZE, SIZE, 3) and np.isfinite(fb_t).all()
    keep = _keep(WITNESSES[scene_name])
    np.testing.assert_allclose(fb_t[keep], fb_j[keep], rtol=RTOL, atol=ATOL)

    (head_t, nan_t, mean_t), (head_j, nan_j, mean_j) = _head(got[0]), _head(want[0])
    assert head_t == head_j and nan_t == nan_j == "False"
    assert f"{fb_t.mean():.4f}" == f"{mean_t:.4f}"
    moved = np.abs(fb_t - fb_j)[~keep].sum() / fb_t.size
    assert abs(mean_t - mean_j) <= moved + 1e-4 + 1e-7


def test_denoise_inputs_and_filter_match_jax(monkeypatch, capsys):
    """The --denoise line: its AOV pass and filter against JAX's on the
    JAX tool's own inputs, recorded while it runs."""
    seen = {}
    real_aovs, real_den = jaov.render_aovs, jden.denoise

    def aovs(*a, **k):
        seen["aovs"] = {n: np.array(v) for n, v in real_aovs(*a, **k).items()}
        return seen["aovs"]

    def den(color, a, **k):
        seen["color"], seen["iterations"] = np.array(color), k["iterations"]
        seen["dn"] = np.asarray(real_den(color, a, **k))
        return seen["dn"]

    monkeypatch.setattr(jaov, "render_aovs", aovs)
    monkeypatch.setattr(jden, "denoise", den)
    out, got, want = _run_both(monkeypatch, capsys, "cornell_box", ["--denoise=3"])
    assert seen["iterations"] == 3
    assert got[1].split(": aov pass")[0] == want[1].split(": aov pass")[0] == "  denoise(3)"

    from zig_weekend_raytracer_tpu_torch.models import load_scene
    from zig_weekend_raytracer_tpu_torch.render.aov import render_aovs

    # the port's AOV pass equals JAX's run eagerly, and differs from the
    # jitted pass the JAX tool ran only where that one contracts
    # multiply-adds (tests/test_torch_aov.py's witness)
    aov_t = render_aovs(load_scene("cornell_box", device="cpu"), SIZE, SIZE, seed=0)
    with jax.disable_jit():
        eager = real_aovs(zj.models.load_scene("cornell_box"), SIZE, SIZE, seed=0)
    close = lambda a, b: np.isclose(a, b, rtol=RTOL, atol=ATOL)
    for name, jit_aov in seen["aovs"].items():
        port_aov, eager_aov = aov_t[name].numpy(), np.asarray(eager[name])
        assert close(port_aov, eager_aov).all(), name
        np.testing.assert_array_equal(close(port_aov, jit_aov), close(eager_aov, jit_aov),
                                      err_msg=name)
    on_jax_inputs = tden.denoise(torch.from_numpy(seen["color"]),
                                 {n: torch.from_numpy(v) for n, v in seen["aovs"].items()},
                                 iterations=3).numpy()
    np.testing.assert_allclose(on_jax_inputs, seen["dn"], rtol=RTOL, atol=ATOL)
    mean_j = float(want[1].rsplit("mean=", 1)[1])
    assert abs(on_jax_inputs.mean() - mean_j) <= 0.5e-4 + 1e-6
    assert f"{out['denoised'].numpy().mean():.4f}" == got[1].rsplit("mean=", 1)[1]


@pytest.mark.parametrize("flags,message", [
    (["--supersample=2", "--adaptive"], "--supersample combines only with plain renders"),
    (["--supersample=2", "--shard=rows"], "--supersample combines only with plain renders"),
    (["--shard=columns"], "--shard='columns': expected 'samples' or 'rows'"),
    (["--bogus=1"], "unknown flags ['bogus']"),
])
def test_flag_rules_match_jax(monkeypatch, flags, message):
    monkeypatch.setattr(sys, "argv", ["scenebench.py", "cornell_box", *ARGS, *flags])
    with pytest.raises(SystemExit) as want:
        jtool.main()
    with pytest.raises(SystemExit) as got:
        ttool.bench(["cornell_box", *ARGS, *flags, "--device=cpu"])
    assert str(got.value).startswith(message) and str(want.value).startswith(message)


def test_device(capsys):
    if not torch.cuda.is_available():
        assert ttool.main(["cornell_box", *ARGS]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="expected 'cuda' or 'cpu'"):
        ttool.main(["cornell_box", *ARGS, "--device=tpu"])
