"""Torch's CPU threads when the suite runs under pytest-xdist.

The suite runs one pytest-xdist worker process per core or so (``-n 6``
on an 8-core host).  Torch's CPU ops take one OpenMP thread per core in
every process by default, so six workers run 48 threads on eight cores,
and the port's plain versions, whose elementwise ops span every lane, then
run tens of times slower than alone: six concurrent cornell renders at
64x64, 32 spp, depth 10 (tests/test_torch_render.py's golden render) took
691 s with torch's default threads and 14 s with one thread each, against
6.5 s for one alone (an 8-core CPU host).

Every xdist worker imports every test module while it collects, before it
runs any test, so the thread count set here, at import, holds for the whole
worker: the cores this process may use, shared out among the workers.  It
changes no test's inputs or tolerances.  Run without xdist, torch keeps its
default.

It applies only when the workers collect this file: a run over the whole
``tests/`` directory (or every ``tests/test_torch_*.py``).  A run of
``pytest -n 6`` over a few other files keeps torch's default of one thread
per core in each worker and is slow again; name this file among them to
share the cores there too.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))


def threads_per_worker(workers: int) -> int:
    """Torch intra-op threads for one of ``workers`` processes sharing this
    process's cores; 0 (torch's default) for a single process."""
    if workers <= 1:
        return 0
    return max(1, len(os.sched_getaffinity(0)) // workers)


if threads_per_worker(WORKERS):
    torch.set_num_threads(threads_per_worker(WORKERS))


def test_threads_per_worker_share_the_cores():
    cores = len(os.sched_getaffinity(0))
    assert threads_per_worker(1) == threads_per_worker(0) == 0
    assert threads_per_worker(6) == max(1, cores // 6)
    assert threads_per_worker(10 * cores) == 1
    if WORKERS > 1:
        assert torch.get_num_threads() == threads_per_worker(WORKERS)
