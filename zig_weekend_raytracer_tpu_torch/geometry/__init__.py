"""Primitive geometry: sphere and quad intersection, UVs and light PDFs."""

from . import quad, sphere
