"""Vector math: SoA 3-vectors over torch tensors."""

from . import v3
from .v3 import V3
