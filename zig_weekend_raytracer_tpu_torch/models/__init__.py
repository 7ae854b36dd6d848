"""The scene library.  The port has ``cornell_box``, ``balls``,
``shrek_quads``, ``earth`` and ``rtw_final``; ``emissive`` follows in a
later slice (ROADMAP.md)."""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from ..scene import Scene
from .balls import load_scene_balls
from .cornell_box import load_scene_cornell_box
from .earth import load_scene_earth
from .rtw_final import load_scene_rtw_final
from .shrek_quads import load_scene_shrek_quads

# The repository's image assets (wap.jpg, me.jpg, earth.png).
DEFAULT_ASSET_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "assets")
)

SCENE_BUILDERS: Dict[str, Callable[..., Scene]] = {
    "cornell_box": load_scene_cornell_box,
    "balls": load_scene_balls,
    "shrek_quads": load_scene_shrek_quads,
    "earth": load_scene_earth,
    "rtw_final": load_scene_rtw_final,
}
_LATER_SLICES = {"emissive": 2}


def load_scene(
    name: str, seed: int = 0, asset_dir: Optional[str] = None, device="cuda"
) -> Scene:
    """Build a scene with its tables on ``device``: the card unless asked
    for the CPU (``device="cpu"`` runs the kernels' plain versions); a CUDA
    device without a GPU raises."""
    name = getattr(name, "value", name)
    if name in _LATER_SLICES:
        raise NotImplementedError(
            f"scene {name!r} is slice {_LATER_SLICES[name]} of the port "
            "(ROADMAP.md)"
        )
    if name not in SCENE_BUILDERS:
        raise ValueError(f"unknown scene {name!r}")
    return SCENE_BUILDERS[name](
        seed=seed, asset_dir=asset_dir or DEFAULT_ASSET_DIR, device=device
    )
