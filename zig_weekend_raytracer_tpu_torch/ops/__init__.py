"""Hot-path ops: closest hit (plain versions here, the kernel in
``closest_hit``), shade-record fetch, the fused render kernel, the bounce
kernel of image scenes, and their build."""

from .shade import ShadeAttrs, shade_attrs
from .trace import Hit
