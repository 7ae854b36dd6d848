"""Sharded rendering over a 1-D device mesh (counterpart of ``parallel/``):
one process drives every device of a mesh (a tuple of ``torch.device``,
``make_mesh``), sharding the samples or the rows of an image."""

from .mesh import AXIS, SHARD_MODES, make_mesh, resolve_mesh
from .render import render_adaptive_sharded, render_batch_sharded, render_sharded
