"""The nested-checker scene: the upstream's Book-1 final scene
(``models/balls.py``, ``src/scene.zig:68-174``) with its ground checker
nested, as the upstream's ``CheckerboardTexture`` allows by recursing into
two sub-textures (``src/texture.zig:96-119``): the ground checker's even
cells hold a checker of the ground's two colours at the README's inner
scale, 2.0.  It has no counterpart in the JAX package's library and no
``--scene`` choice: ``load_scene("nested")`` builds it, and
``benchmark/configs/nested.json`` is the same scene as a scene file.
Every scene with a checker of checkers renders on the fixed-depth
wavefront (``ops/bounce.py:supports_bounce_kernel``)."""

from __future__ import annotations

from ..scene import Scene
from .balls import balls_builder

INNER_SCALE = 2.0


def load_scene_nested(seed: int = 0, asset_dir: str = "", device="cuda",
                      texture_lut=None) -> Scene:
    return balls_builder(seed, INNER_SCALE).compile(name="nested", device=device,
                                                    texture_lut=texture_lut)
