"""The scene library.  The port has ``cornell_box`` and ``balls``; the
other scenes of the JAX package follow in later slices (ROADMAP.md)."""

from __future__ import annotations

from typing import Callable, Dict

from ..scene import Scene
from .balls import load_scene_balls
from .cornell_box import load_scene_cornell_box

SCENE_BUILDERS: Dict[str, Callable[..., Scene]] = {
    "cornell_box": load_scene_cornell_box,
    "balls": load_scene_balls,
}
_LATER_SLICES = {
    "emissive": 2, "earth": 4, "shrek_quads": 4, "rtw_final": 4,
}


def load_scene(name: str, device="cpu") -> Scene:
    """Build a scene with its tables on ``device``."""
    name = getattr(name, "value", name)
    if name in _LATER_SLICES:
        raise NotImplementedError(
            f"scene {name!r} is slice {_LATER_SLICES[name]} of the port "
            "(ROADMAP.md)"
        )
    if name not in SCENE_BUILDERS:
        raise ValueError(f"unknown scene {name!r}")
    return SCENE_BUILDERS[name](device=device)
