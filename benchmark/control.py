"""The readings that the limits of ``check.py`` are set from.

    python3 benchmark/control.py --workload <cell> --program-seeds a,b,... \
        --control-seeds c,d,e [--seconds 2]

Each seed is one run of the harness in this process (``harness.main``),
whose last line carries the numbers compared and ``correct``.  A program
seed runs the port, as the benchmark does, with a short window: its
numbers are the program's readings.  A control seed runs the control in
the program's place (``LowPrecisionProgram``): the reference computed in
bfloat16, the precision below the float32 that the configurations state,
through the harness's own window, keeper and comparison; its line has to
read ``correct`` false.  Before each run's line this prints
``{"role": "program" | "control", "seed": n}``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import pkgutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPE_VAR = "ZWRT_REFERENCE_DTYPE"
LOW = "bfloat16"


def low_precision_package(dtype: str = LOW) -> str:
    """The name of a second copy of ``benchmark/reference`` whose modules
    were all imported with ``ZWRT_REFERENCE_DTYPE=<dtype>``, so that it
    computes in ``dtype`` beside the float32 reference in this process."""
    name = f"benchmark_reference_{dtype}"
    if name in sys.modules:
        return name
    path = os.path.join(ROOT, "benchmark", "reference")
    mod_spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    old = os.environ.get(DTYPE_VAR)
    os.environ[DTYPE_VAR] = dtype
    try:
        module = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = module
        mod_spec.loader.exec_module(module)
        for info in pkgutil.walk_packages([path], prefix=name + "."):
            importlib.import_module(info.name)
    finally:
        if old is None:
            os.environ.pop(DTYPE_VAR, None)
        else:
            os.environ[DTYPE_VAR] = old
    return name


class LowPrecisionProgram:
    """The control in the program's place: each request is the bfloat16
    reference's image at the request's render seed, worked out at the
    pixels that the run's check reads (the rest of the image stays 0)."""

    def __init__(self, cell, run_seed: int, device: str):
        import torch

        from benchmark import check

        t = cell.traffic
        self.traffic = t
        self.package = low_precision_package()
        self.scene = check.reference_scene(cell.config_path, device, package=self.package)
        xs, ys = check.pixel_sample(run_seed, t["width"], t["height"], int(t["check_block"]))
        self.xs, self.ys = xs, ys
        self.iy = torch.as_tensor(ys, device=device)
        self.ix = torch.as_tensor(xs, device=device)
        self.device = device

    def request(self, render_seed: int):
        import torch

        from benchmark import check

        t = self.traffic
        vals = check.reference_pixels(self.scene, t, render_seed, self.xs, self.ys,
                                      package=self.package)
        image = torch.zeros((t["height"], t["width"], 3), dtype=torch.float32,
                            device=self.device)
        image[self.iy, self.ix] = vals.to(torch.float32)
        return image


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--traffic", default=None)
    args = p.parse_args(argv)

    from benchmark import harness

    traffic = json.loads(args.traffic) if args.traffic else {}
    runs = [("program", s) for s in _seeds(args.program_seeds)]
    runs += [("control", s) for s in _seeds(args.control_seeds)]
    for role, seed in runs:
        print(json.dumps({"role": role, "seed": seed}), flush=True)
        # the control builds no kernel: it needs no warm-up
        t = traffic if role == "program" else {**traffic, "warmup": 0}
        argv_run = ["--workload", args.workload, "--seed", str(seed), "--seconds",
                    str(args.seconds), "--device", args.device, "--traffic", json.dumps(t)]
        cls = harness.Program if role == "program" else LowPrecisionProgram
        rc = harness.main(argv_run, time.perf_counter(), program_cls=cls)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
        os.path.abspath(__file__))]
    sys.exit(main())
