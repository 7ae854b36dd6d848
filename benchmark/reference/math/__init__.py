"""Vector math: SoA 3-vectors over torch tensors, intervals and the AABB
slab test."""

from . import aabb, interval, v3
from .v3 import V3
