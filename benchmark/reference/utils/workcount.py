"""Work counts of the plain versions, for the kernels' roofline bounds.

Off by default.  Inside ``with counting() as c:`` the plain closest hit
(``ops/trace.py``) and the plain integrator (``render/integrator.py``)
add what they do for the lanes the kernels would run: camera rays,
bounces, misses, hits by material, texel fetches, brute primitive tests,
tree node tests, leaf visits and leaf-slot tests.  ``utils/roofline.py``
turns the counts into operations.  Each ``add`` of a tensor sum syncs the
device, so callers test ``enabled()`` before they compute one.
"""

from __future__ import annotations

import collections
import contextlib

_counts = None


@contextlib.contextmanager
def counting():
    """Collect counts into a fresh ``collections.Counter`` for the block."""
    global _counts
    prev = _counts
    _counts = collections.Counter()
    try:
        yield _counts
    finally:
        _counts = prev


def enabled() -> bool:
    return _counts is not None


def add(key: str, n) -> None:
    if _counts is not None:
        _counts[key] += int(n)
