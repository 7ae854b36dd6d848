"""Primitive geometry: sphere and quad intersection, UVs and light PDFs, and
the group-tree build."""

from . import bvh, quad, sphere
