"""Utilities: the region-statistics correctness gate."""

from .goldengate import check_framebuffer, region_means
