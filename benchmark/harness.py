"""One run of one cell of the port's benchmark.

A run builds the system under test from the cell's files (``Program``):
the port's scene from the configuration's scene file, through the port's
own scene-file entry, and one ``Renderer`` at the traffic mix's image
size, samples per pixel and depth.  A request is one new image:
``Renderer.render_device`` with the renderer's seed set to the request's
own render seed (``check.request_seed(--seed, request index)``), as a
service that keeps its renderer serves a stream of new images; the
client waits for the image before it sends the next: a closed loop of one
client.

Set-up (``setup_s``, from process start) loads the port and the scene and
runs the mix's ``warmup`` requests, which build every kernel.  The window
then sends requests until ``--seconds`` have passed and at least
``check_requests`` were served, each timed by CUDA events from the call
to the end of its last device operation.  During a window the harness
only records those events and offers each output to ``check.Keeper``,
which keeps references to a seeded sample of them.  With ``--trace 1`` a
window of the mix's ``trace_seconds`` follows under the profiler
(``devtrace.py``).  Then the kept outputs' checked pixels are read, the
program's state is freed and ``check.py`` compares them with the
reference.

Each metric the cell reports is read by ``benchmark/metrics/<name>.py``
from the ``Run`` record: with ``--trace 0`` the end-to-end ones, with
``--trace 1`` the per-layer ones.  The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error.

Exit codes: 0 a result was printed; 2 usage, an unknown cell or a missing
program; 3 no card, or fewer cards than the cell asks for; 4 JAX or the
JAX package was loaded.  ``--device cpu`` runs the port's plain versions
for the tests and reports no device number.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from typing import Optional

from . import check, spec
from .spec import Cell

EXIT_USAGE, EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3, 4
FORBIDDEN = ("jax", "jaxlib", "flax", "zig_weekend_raytracer_tpu")
PORT = "zig_weekend_raytracer_tpu_torch"


def forbidden_modules() -> list:
    """JAX and the JAX package among the loaded modules, compared by whole
    top-level name (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a metric reader reads of one run."""

    traffic: dict
    setup_s: float
    window_s: float                  # the measured window, host clock
    requests: int                    # requests completed in it
    paths_per_request: int           # camera paths of one image
    latency_ms: list                 # each request's, CUDA events
    trace: Optional[dict] = None     # devtrace.summarize of the traced window
    traced_requests: int = 0
    k1_bound_ms: Optional[float] = None


class Program:
    """The port as the cell drives it: one request renders one image at the
    render seed it is given."""

    def __init__(self, cell: Cell, run_seed: int, device: str):
        from zig_weekend_raytracer_tpu_torch.models.scenefile import load_scene_file
        from zig_weekend_raytracer_tpu_torch.render.renderer import Renderer

        t = cell.traffic
        self.width, self.height = t["width"], t["height"]
        self.scene = load_scene_file(cell.config_path, device=device)
        self.renderer = Renderer(samples_per_pixel=t["spp"], max_ray_bounce_depth=t["depth"])

    def request(self, render_seed: int):
        """The image of ``render_seed``, on the device, not synchronized."""
        self.renderer.seed = render_seed
        return self.renderer.render_device(self.scene, self.width, self.height)


def stream(program, cuda: bool, run_seed: int, first: int, seconds: float, min_requests: int,
           keeper: check.Keeper, annotate: bool = False):
    """Closed-loop requests ``first``, ``first + 1``, ... until ``seconds``
    have passed and ``min_requests`` were served.  Returns (per-request
    latencies in ms, the window's host seconds)."""
    import torch

    events = []
    record = (lambda: torch.profiler.record_function("bench.render")) if annotate else (
        contextlib.nullcontext)
    i = first
    t0 = time.perf_counter()
    while len(events) < min_requests or time.perf_counter() - t0 < seconds:
        render_seed = check.request_seed(run_seed, i)
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            with record():
                image = program.request(render_seed)
            ev1.record()
            ev1.synchronize()
            events.append((ev0, ev1))
        else:
            h0 = time.perf_counter()
            with record():
                image = program.request(render_seed)
            events.append(time.perf_counter() - h0)
        keeper.offer(i, render_seed, image)
        i += 1
    window_s = time.perf_counter() - t0
    lat = [e[0].elapsed_time(e[1]) for e in events] if cuda else [s * 1e3 for s in events]
    return lat, window_s


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the tests: the port's plain versions on the CPU, no device number
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # for the tests: JSON merged over the cell's traffic mix (a tiny size)
    p.add_argument("--traffic", default=None)
    return p.parse_args(argv)


def _err(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def main(argv, t_start: float, program_cls=Program) -> int:
    """One run; ``program_cls`` puts another system in the program's place
    (``control.py``'s lower-precision reference)."""
    args = parse_args(argv)
    try:
        cell = spec.resolve(spec.load_spec(), args.workload)
    except (KeyError, OSError, ValueError) as e:
        _err(f"cannot resolve the cell: {e}")
        return EXIT_USAGE
    if args.traffic:
        cell = dataclasses.replace(cell, traffic={**cell.traffic, **json.loads(args.traffic)})
    t = cell.traffic

    import torch

    cpu = args.device == "cpu"
    if not cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        _err(f"{cell.name} needs {cell.chips} CUDA card(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return EXIT_NO_CARD
    try:
        __import__(PORT)
    except ImportError as e:
        _err(f"the program ({PORT}) does not import: {e}")
        return EXIT_USAGE

    from . import devtrace, roofline

    device = "cpu" if cpu else "cuda"
    n_check = int(t["check_requests"])
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    program = program_cls(cell, args.seed, device)
    warmup = int(t["warmup"])
    for i in range(warmup):
        program.request(check.request_seed(args.seed, i))
    if not cpu:
        torch.cuda.synchronize()
    keeper = check.Keeper(args.seed, n_check)
    setup_s = time.perf_counter() - t_start

    latency, window_s = stream(program, not cpu, args.seed, warmup, args.seconds, n_check,
                               keeper)
    run = Run(traffic=t, setup_s=setup_s, window_s=window_s, requests=len(latency),
              paths_per_request=t["width"] * t["height"] * t["spp"], latency_ms=latency)
    if args.trace:
        first = warmup + len(latency)
        (traced, _), run.trace = devtrace.profile(
            lambda: stream(program, not cpu, args.seed, first, float(t["trace_seconds"]), 1,
                           keeper, annotate=True))
        run.traced_requests = len(traced)

    found = forbidden_modules()
    if found:
        _err(f"forbidden modules loaded in the measuring process: {', '.join(found)}")
        return EXIT_FORBIDDEN
    if cpu:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": None}
    else:
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": cell.chips, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    if run.trace is not None:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
    xs, ys = check.pixel_sample(args.seed, t["width"], t["height"], int(t["check_block"]))
    seen = keeper.seen
    kept = keeper.gather(xs, ys)
    del program, keeper
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()

    result = check.check(t, cell.config_path, kept, xs, ys, device, count=bool(args.trace))
    if result["counts"] is not None:
        ref_scene = result["scene"]
        run.k1_bound_ms = roofline.k1_bound(
            ref_scene.compiled, result["counts"], result["n_pixels"],
            ref_scene.camera.has_depth_of_field, t["spp"], t["width"], t["height"])["ms"]

    metrics = {}
    if not cpu:
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = spec.load_reader(m["name"])(run)
            if value is None and not args.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = result["compared"]
    correct = all(v <= lim for v, lim in compared.values()) and result["failed"] == 0
    line = {"correct": correct, "attempted": seen, "failed": result["failed"],
            "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
