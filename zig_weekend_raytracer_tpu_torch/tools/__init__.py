"""Command-line tools of the port: the card's measurements (``fp32_peak``,
``span_sweep``, ``golden_check``) and the JAX package's user tools
(``scenebench``, ``shard_overhead``, ``lut_quality``, ``quality_prodres``,
``imgdiff``).  Those that render take ``--device=cuda|cpu`` (default the
card; ``cpu`` runs the kernels' plain versions and exists for the tests)."""

from __future__ import annotations

import sys

import torch

DEVICES = ("cuda", "cpu")


def card_missing(device: str, tool: str) -> bool:
    """True, after an error line on stderr, when ``device`` is the card and
    there is none: a tool that renders never falls back to the CPU.  Another
    value than ``DEVICES`` exits with a message."""
    if device not in DEVICES:
        raise SystemExit(f"--device={device!r}: expected 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        print(f"error: CUDA is not available: {tool} renders on the card "
              "(--device=cpu runs the plain versions)", file=sys.stderr)
        return True
    return False


def synchronizer(device: str):
    """The call that ends a timed interval on ``device``: the card returns
    before its work is done; the CPU's work is done when the call returns."""
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)
