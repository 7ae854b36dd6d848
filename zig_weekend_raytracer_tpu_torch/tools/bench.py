"""The north-star harness on the card (counterpart of the repository's root
``bench.py``): one command that says how fast the card renders, and
whether the image is right.

    python -m zig_weekend_raytracer_tpu_torch.tools.bench [scene [w h spp depth]]
        [--texture_lut=N] [--device=cuda|cpu]

By default it renders the north star, cornell_box at 400x400, 1024 spp,
depth 10, Sobol, seed 0.  Other configurations take ``tools/scenebench.py``'s
positional arguments (the north star's values where left out) and a texture
LUT's texel budget; the tree walk comes from the environment, as everywhere
in the package (``ZWRT_TRAV``, ``ZWRT_UNI_TREE``, ``ZWRT_LEAF_GROUPS``).

The parent probes the card in a child interpreter (``torch.cuda`` under a
hard timeout, retried as the root harness retries a backend that hangs or
raises), then measures in a second child under a timeout and relays its
last JSON line and exit code, so that a hung launch cannot hang the
caller.  The child:

  1. renders once to warm up (``warmup_s``: it builds the kernels the first
     time; the first render of a brute scene measures the per-pixel costs
     that the cost-sorted plan orders lanes by, a tree scene's builds its
     coherent plan);
  2. times three ``Renderer.render_device`` calls, each ended by
     ``torch.cuda.synchronize()`` (``times_s``); ``value`` is W·H·spp over
     the best, in Mpaths/s;
  3. gates the image: no NaN, and at the north star a maximum above 1 (the
     light is seen) and the region gate of
     ``tests/golden/bench_cornell_regions.json``; elsewhere the scene's
     region gate of ``tests/golden/scene_regions.json``, rendered untimed
     at that file's configuration (seed 0) through the same kernel, walk
     and LUT, as ``tools/golden_check.py`` does.  A failed gate has no
     speed: every measured field is null and the exit code 1;
  4. counts the bounce iterations per path (``iters_per_path``) from the
     production work counter at 64 spp, as the root harness does;
  5. times the render kernel alone at the renderer's lanes, the best of
     three CUDA-event times (``kernel_ms``): K1 (``ops/fused_render.py``)
     where it takes the scene, else K2's regenerating mode
     (``ops/bounce.py``); ``host_ms`` is the best render's wall time less
     ``kernel_ms``, the render driver's share;
  6. prices the kernel's bound (``utils/roofline.py:render_bound``) from
     the plain version's work counts, one sample on every lane of those
     lanes (trees walked by the cond walk), scaled to the kernel's bounce
     count, at the class rates that K5 measures in the same process
     (``tools/fp32_peak.py:class_rates``): ``bound_ms``, ``bound_by``,
     ``peak_source`` and ``roofline_share`` = bound_ms / kernel_ms.

The last line of standard output is one JSON object: ``metric``,
``value``, ``unit``, ``vs_baseline``, ``correctness``, ``iters_per_path``,
``kernel`` ("K1" or "K2 regenerating"), ``kernel_ms``, ``bound_ms``,
``bound_by``, ``roofline_share``, ``peak_source``, ``host_ms``,
``warmup_s``, ``times_s``, ``launches`` (the run's kernel launches by
kernel: K3c is the coherent plan's key launch beside K3's closest hits) and ``device`` (the card's name and power limit as ``nvidia-smi``
gives them); an error adds ``error`` and ``detail``.  ``vs_baseline`` is
``value`` / 160 Mpaths/s, the goal that ``BASELINE.json`` states (400 x
400 x 1000 paths in one second): a target, not a measurement of any device.

Exit codes: 0 the gate passed; 1 it failed; 2 a usage error or a scene the
harness does not take (nested checkers, which render on the fixed-depth
path; a scene without a region golden); 75 (EX_TEMPFAIL) no card, or the
measurement hung or died.  No number is ever measured on the CPU in the
card's place.  ``--device=cpu`` runs in process on the kernels' plain
versions, for the tests: every measured field is null there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import scenebench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden", "bench_cornell_regions.json")
REGIONS = os.path.join(ROOT, "tests", "golden", "scene_regions.json")
NORTH_STAR = ("cornell_box", 400, 400, 1024, 10)
FLAGS = ("texture_lut", "device")
# BASELINE.json's goal: 400 x 400 x 1000 paths in one second
GOAL_MPATHS = 400 * 400 * 1000 / 1e6
PROBE_SPP = 64
TIMED_RENDERS = 3
# "infrastructure unavailable", apart from 1, a failed gate on a live card
EX_TEMPFAIL = 75
PROBE_TIMEOUT_S = 75
PROBE_ATTEMPTS = 3
PROBE_RETRY_SLEEP_S = 45
CHILD_TIMEOUT_S = 45 * 60
KEYS = ("metric", "value", "unit", "vs_baseline", "correctness", "iters_per_path", "kernel",
        "kernel_ms", "bound_ms", "bound_by", "roofline_share", "peak_source", "host_ms",
        "warmup_s", "times_s", "launches", "device")
_PROBE = ("import torch; print('card ' + torch.cuda.get_device_name(0) "
          "if torch.cuda.is_available() else 'none')")
_CHILD = ("import sys; from zig_weekend_raytracer_tpu_torch.tools import bench; "
          "sys.exit(bench.child(sys.argv[1:]))")


@dataclasses.dataclass(frozen=True)
class Config:
    scene: str
    width: int
    height: int
    spp: int
    depth: int
    texture_lut: int
    device: str

    @property
    def north_star(self) -> bool:
        return (self.scene, self.width, self.height, self.spp, self.depth) == NORTH_STAR

    @property
    def metric(self) -> str:
        lut = f" LUT {self.texture_lut}" if self.texture_lut else ""
        where = "1 GPU; north-star config" if self.north_star else "1 GPU"
        return (f"{self.scene}{lut} {self.width}x{self.height} @{self.spp}spp "
                f"depth{self.depth} path throughput ({where})")


def parse(argv) -> Config:
    """The configuration ``argv`` asks for; a usage error raises
    SystemExit with its message."""
    args, opts = scenebench.parse(argv, FLAGS)
    if len(args) > len(NORTH_STAR):
        raise SystemExit(f"at most {len(NORTH_STAR)} arguments (scene w h spp depth), "
                         f"got {args}")
    try:
        nums = [int(a) for a in args[1:]] + list(NORTH_STAR[len(args) or 1:])
        lut = int(opts.get("texture_lut", 0))
    except ValueError as e:
        raise SystemExit(f"expected integers: {e}") from None
    if min(nums) < 1 or lut < 0:
        raise SystemExit(f"sizes, spp and depth must be positive, got {nums}")
    device = opts.get("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device={device!r}: expected 'cuda' or 'cpu'")
    return Config(args[0] if args else NORTH_STAR[0], *nums, lut, device)


def record(cfg: Config, **fields) -> dict:
    """The output line: every key, null where not given."""
    return {**dict.fromkeys(KEYS), "metric": cfg.metric, "unit": "Mpaths/s", **fields}


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_renders(renderer, scene, width: int, height: int, sync, n: int = TIMED_RENDERS):
    """One warmup render and ``n`` timed renders of ``scene``, each ended
    by ``sync``; (warmup s, [render s], last framebuffer)."""
    t0 = time.perf_counter()
    renderer.render_device(scene, width, height)
    sync()
    warm_s = time.perf_counter() - t0
    times, fb = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        fb = renderer.render_device(scene, width, height)
        sync()
        times.append(time.perf_counter() - t0)
    return warm_s, times, fb


def cuda_time_ms(fn, repeats: int = 1):
    """Best CUDA-event time of ``fn`` in ms over ``repeats`` runs, and the
    last run's result."""
    import torch

    best, out = float("inf"), None
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def check_regions(fb) -> str:
    """The north star's gate: the framebuffer against the committed region
    statistics of ``GOLDEN`` (``utils/goldengate.py``); 'pass (...)' or
    'fail:<detail>'."""
    from ..utils.goldengate import check_framebuffer

    with open(GOLDEN) as f:
        ref = json.load(f)
    return check_framebuffer(np.asarray(fb), ref["mean"], np.asarray(ref["region_means"]))


def gate(cfg: Config, fb) -> str:
    """The verdict on a timed framebuffer: NaNs fail; at the north star a
    maximum of at most 1 fails (the light must be seen), then
    ``check_regions``; elsewhere the scene's region gate of ``REGIONS``
    at that file's configuration (``golden_check.check_scene``)."""
    from .golden_check import check_scene

    fb = fb.cpu().numpy()
    if np.isnan(fb).any():
        return "fail:nan in the framebuffer"
    if cfg.north_star:
        if fb.max() <= 1.0:
            return f"fail:max {fb.max()} <= 1 (the light is not seen)"
        return check_regions(fb)
    with open(REGIONS) as f:
        ref = json.load(f)["scenes"][cfg.scene]
    return check_scene(cfg.scene, ref, cfg.device, texture_lut=cfg.texture_lut or None)


def iterations_per_path(scene, width: int, height: int, depth: int,
                        spp_probe: int = PROBE_SPP) -> float:
    """Mean bounce iterations per path from the production work counter
    (``trace_paths_regen``'s, the one the sorted plan orders lanes by):
    every pixel of the image renders ``spp_probe`` Sobol samples (a render
    of ``spp_probe`` spp), seed 0."""
    import torch

    from ..render.camera import camera_consts
    from ..render.integrator import trace_paths_regen
    from ..sampling.sampler import SamplerKind

    cs = scene.compiled
    n_pix = width * height
    idx = torch.arange(n_pix, dtype=torch.int32, device=cs.device)
    py, px = (idx // width).contiguous(), (idx % width).contiguous()
    _, work = trace_paths_regen(
        cs, camera_consts(scene.camera, width, height), 0, px, py, torch.zeros_like(idx),
        torch.full_like(idx, spp_probe), sampler=SamplerKind.SOBOL, width=width, height=height,
        spp=spp_probe, stride=1, max_depth=depth, has_dof=scene.camera.has_depth_of_field,
        want_work=True,
    )
    return int(work.sum(dtype=torch.int64)) / (n_pix * spp_probe)


@contextlib.contextmanager
def cond_walk():
    """The plain trace walks the per-kind trees with the cond walk (the
    fewest boxes for the same hits) inside the block."""
    prev = os.environ.get("ZWRT_TRAV")
    os.environ["ZWRT_TRAV"] = "cond"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["ZWRT_TRAV"]
        else:
            os.environ["ZWRT_TRAV"] = prev


def plain_counts(renderer, scene, width: int, height: int) -> dict:
    """Work counts (``utils/workcount.py``) of the plain version on every
    lane of ``renderer.render_lanes``, one sample each, the lanes' samples
    spread over their windows: lane i renders the (i mod n)-th of its n
    samples."""
    import torch

    from ..dtypes import T_MIN
    from ..render.camera import camera_consts
    from ..render.integrator import render_fused_reference
    from ..utils import workcount

    px, py, s0, s1, stride = renderer.render_lanes(scene, width, height)
    n = torch.clamp((s1 - s0 + stride - 1) // stride, min=1)
    lane = torch.arange(px.shape[0], dtype=s0.dtype, device=s0.device)
    first = s0 + lane % n * stride
    with cond_walk(), workcount.counting() as counts:
        render_fused_reference(
            scene.compiled, px, py, first, torch.minimum(first + 1, s1), renderer.seed, T_MIN,
            camera_consts=camera_consts(scene.camera, width, height),
            sampler=renderer.sampler, width=width, height=height,
            spp=renderer.samples_per_pixel, stride=stride,
            max_depth=renderer.max_ray_bounce_depth, has_dof=scene.camera.has_depth_of_field,
        )
    return dict(counts)


def _launch_counters():
    from ..ops import bounce, closest_hit, fused_render
    from . import fp32_peak

    return {"K1": (fused_render.render_fused,), "K2": (bounce.bounce, bounce.bounce_regen),
            "K3": (closest_hit.closest_hit,), "K3c": (closest_hit.coherent_keys,),
            "K5": (fp32_peak.chain,)}


def reset_launches() -> None:
    for hosts in _launch_counters().values():
        for host in hosts:
            host.launches = (dict.fromkeys(host.launches, 0) if isinstance(host.launches, dict)
                             else 0)


def launches() -> dict:
    """Kernel launches since ``reset_launches``, by kernel."""
    total = lambda v: sum(v.values()) if isinstance(v, dict) else v
    return {k: sum(total(h.launches) for h in hosts)
            for k, hosts in _launch_counters().items()}


def measure(cfg: Config) -> tuple:
    """The measurement of ``cfg`` in this process: (output line, exit code,
    details), the details holding the last framebuffer (``fb``, a tensor
    on the device), the plain counts (``counts``), the kernel's bounces
    (``kernel_work``) and the lane bytes (``lane_bytes``) of the bound."""
    import torch

    from ..models import load_scene
    from ..ops.bounce import supports_bounce_kernel, supports_fused_render
    from ..ops.trace import walk_of
    from ..render.renderer import Renderer
    from ..utils import roofline
    from . import fp32_peak

    on_card = cfg.device == "cuda"
    reset_launches()
    device = card_name() if on_card else "cpu"
    scene = load_scene(cfg.scene, device=cfg.device, texture_lut=cfg.texture_lut or None)
    cs = scene.compiled
    kernel = "K1" if supports_fused_render(cs) else "K2 regenerating"
    out = record(cfg, kernel=kernel, device=device)
    if not supports_bounce_kernel(cs):
        return {**out, "kernel": None, "error": "unsupported-scene",
                "detail": "nested checkers render on the fixed-depth path, which runs "
                          "no render kernel"}, 2, {}
    if not cfg.north_star:
        with open(REGIONS) as f:
            goldens = json.load(f)["scenes"]
        if cfg.scene not in goldens:
            return {**out, "error": "no-golden",
                    "detail": f"{cfg.scene} has no region golden in {REGIONS}; the file "
                              f"has {sorted(goldens)}"}, 2, {}
    renderer = Renderer(samples_per_pixel=cfg.spp, max_ray_bounce_depth=cfg.depth, seed=0)
    if renderer.regen_geometry(cfg.width, cfg.height, cfg.spp)[1] < cfg.height:
        return {**out, "error": "unsupported-config",
                "detail": f"{cfg.width}x{cfg.height}@{cfg.spp} renders in more than one band, "
                          "whose kernel the harness does not time"}, 2, {}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    warm_s, times, fb = timed_renders(renderer, scene, cfg.width, cfg.height, sync)
    details = {"fb": fb}
    out["correctness"] = gate(cfg, fb)
    if not out["correctness"].startswith("pass"):
        return {**out, "launches": launches()}, 1, details

    iters = iterations_per_path(scene, cfg.width, cfg.height, cfg.depth)
    rates = fp32_peak.class_rates() if on_card else None
    call = renderer.kernel_call(scene, cfg.width, cfg.height)
    if on_card:
        kernel_ms, (_, work) = cuda_time_ms(call, 3)
    else:
        kernel_ms, (_, work) = None, call()
    counts = plain_counts(renderer, scene, cfg.width, cfg.height)
    kernel_work = int(work.sum(dtype=torch.int64))
    lane_bytes = work.shape[0] * roofline.LANE_BYTES[kernel.split()[0]]
    bound = roofline.render_bound(cs, counts, kernel_work, lane_bytes,
                                  scene.camera.has_depth_of_field, cfg.spp, walk=walk_of(cs),
                                  ops_rate=rates)
    details.update(counts=counts, kernel_work=kernel_work, lane_bytes=lane_bytes)
    out.update(iters_per_path=iters, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
               peak_source=bound["peak_source"], launches=launches())
    if on_card:
        best = min(times)
        value = cfg.width * cfg.height * cfg.spp / best / 1e6
        out.update(value=value, vs_baseline=value / GOAL_MPATHS, kernel_ms=kernel_ms,
                   roofline_share=bound["bound_ms"] / kernel_ms,
                   host_ms=best * 1e3 - kernel_ms, warmup_s=warm_s, times_s=times)
    return out, 0, details


def child(argv) -> int:
    """The measuring child: prints the line, returns the exit code."""
    out, rc, _ = measure(parse(argv))
    print(json.dumps(out), flush=True)
    return rc


def probe_card(timeout_s: float = PROBE_TIMEOUT_S):
    """("card", name), ("none", None) when torch answers that there is no
    card, or ("failed", None) when the probe hung or raised: a fresh
    interpreter asks ``torch.cuda`` under a hard timeout, so that a driver
    that hangs cannot hang this process."""
    try:
        res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return "failed", None
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        return "failed", None
    answer = lines[-1].strip()
    if answer == "none":
        return "none", None
    return ("card", answer[len("card "):]) if answer.startswith("card ") else ("failed", None)


def _unavailable(cfg: Config, detail: str) -> int:
    print(json.dumps(record(cfg, error="gpu-unavailable", detail=detail)), flush=True)
    return EX_TEMPFAIL


def main(argv=None) -> int:
    """Parent: probe the card, then measure in a child under a timeout."""
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        cfg = parse(argv)
    except SystemExit as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if cfg.device == "cpu":
        return child(argv)
    for attempt in range(PROBE_ATTEMPTS):
        status, _ = probe_card()
        if status != "failed":
            break
        if attempt < PROBE_ATTEMPTS - 1:
            print(f"bench: card probe attempt {attempt + 1} failed; retrying in "
                  f"{PROBE_RETRY_SLEEP_S} s", file=sys.stderr)
            time.sleep(PROBE_RETRY_SLEEP_S)
    if status == "failed":
        return _unavailable(cfg, f"card probe failed {PROBE_ATTEMPTS}x (timeout "
                                 f"{PROBE_TIMEOUT_S} s each): torch.cuda hung or raised")
    if status == "none":
        return _unavailable(cfg, "torch.cuda.is_available() is False: no card, and the "
                                 "harness measures nothing on the CPU in its place")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (env.get("PYTHONPATH"), ROOT) if p)
    try:
        res = subprocess.run([sys.executable, "-c", _CHILD, *argv], capture_output=True,
                             text=True, timeout=CHILD_TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired:
        return _unavailable(cfg, f"the measuring child exceeded {CHILD_TIMEOUT_S} s (a launch "
                                 "or build hung)")
    sys.stderr.write(res.stderr)
    line = None
    for text in res.stdout.splitlines():
        try:
            json.loads(text)
            line = text
        except ValueError:
            sys.stderr.write(text + "\n")
    if line is None:
        return _unavailable(cfg, f"the measuring child died without a JSON line "
                                 f"(rc={res.returncode}); stderr tail: "
                                 f"{res.stderr.strip()[-400:]}")
    print(line, flush=True)
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
