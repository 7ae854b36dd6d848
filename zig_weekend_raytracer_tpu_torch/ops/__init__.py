"""Hot-path ops: closest hit (plain versions here, the kernel in
``closest_hit``), shade-record fetch, and the fused render kernel with its
build."""

from .shade import ShadeAttrs, shade_attrs
from .trace import Hit
