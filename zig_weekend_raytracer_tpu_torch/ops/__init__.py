"""Hot-path ops: brute closest hit, shade-record fetch, and the fused
render kernel with its build."""

from .shade import ShadeAttrs, shade_attrs
from .trace import Hit, closest_hit_brute
