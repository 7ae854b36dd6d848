"""The scene library (counterpart of ``models/__init__.py``): the six
built-in scenes, constant for constant, ``SceneType``, the CLI's
``--scene`` choices in the JAX package's order, ``load_scene_file``, the
JSON scene files of ``--scene_file``, and the nested-checker scene
(``models/nested.py``: ``load_scene`` takes it, ``--scene`` does not)."""

from __future__ import annotations

import enum
import os
from typing import Callable, Dict, Optional

from ..scene import Scene
from .balls import load_scene_balls
from .cornell_box import load_scene_cornell_box
from .earth import load_scene_earth
from .emissive import load_scene_emissive
from .nested import load_scene_nested
from .rtw_final import load_scene_rtw_final
from .scenefile import load_scene_file
from .shrek_quads import load_scene_shrek_quads

# The repository's image assets (wap.jpg, me.jpg, earth.png).
DEFAULT_ASSET_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "assets")
)


class SceneType(enum.Enum):
    """--scene choices (reference: src/scene.zig:18-24, plus earth)."""

    BALLS = "balls"
    SHREK_QUADS = "shrek_quads"
    EMISSIVE = "emissive"
    CORNELL_BOX = "cornell_box"
    RTW_FINAL = "rtw_final"
    EARTH = "earth"


SCENE_BUILDERS: Dict[str, Callable[..., Scene]] = {
    "balls": load_scene_balls,
    "shrek_quads": load_scene_shrek_quads,
    "emissive": load_scene_emissive,
    "cornell_box": load_scene_cornell_box,
    "rtw_final": load_scene_rtw_final,
    "earth": load_scene_earth,
    "nested": load_scene_nested,
}


def load_scene(
    name, seed: int = 0, asset_dir: Optional[str] = None, device="cuda",
    texture_lut: Optional[int] = None,
) -> Scene:
    """Build a scene (a name or a ``SceneType``) with its tables on
    ``device``: the card unless asked for the CPU (``device="cpu"`` runs
    the kernels' plain versions); a CUDA device without a GPU raises.
    ``texture_lut`` is the texel budget of the texture LUT
    (``SceneBuilder.compile``; None reads ``ZWRT_TEX_LUT``)."""
    name = getattr(name, "value", name)
    if name not in SCENE_BUILDERS:
        raise ValueError(f"unknown scene {name!r}")
    return SCENE_BUILDERS[name](
        seed=seed, asset_dir=asset_dir or DEFAULT_ASSET_DIR, device=device,
        texture_lut=texture_lut,
    )
