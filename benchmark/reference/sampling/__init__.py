"""Sampling: content-addressed PCG4D streams, distribution helpers and the
pixel-sampler framework (independent / stratified / Sobol-Owen)."""

from . import hashrng
from . import sobol
from .sampler import SamplerKind, pixel_offsets, sample_dimension
