"""The port's benchmark: a harness driven by ``BENCHMARK.json`` (``run.py``),
its scene data (``configs/``), traffic mixes (``traffic/``), per-layer
metric readers (``metrics/``), the frozen roofline arithmetic
(``roofline.py``) and a plain PyTorch reference (``reference/``) that
decides whether a run's images are correct."""
