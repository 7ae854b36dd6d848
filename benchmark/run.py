"""Run one cell of the port's benchmark on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``harness.py`` says what a run does).  The
program's kernel build already lives inside the checkout; this entry keeps
Triton's and PyTorch's extension caches there too, at fixed paths, before
anything imports torch."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory, on the import path
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
    os.path.abspath(__file__))]
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
