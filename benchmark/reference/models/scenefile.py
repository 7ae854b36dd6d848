"""Declarative JSON scene files over ``SceneBuilder``: the benchmark's
scene data, which the port reads through its own scene-file entry
(``models/scenefile.py:load_scene_file``), compiled here by the reference.
An image texture names a file beside the scene file, which the reference
decodes itself (``io/decode.py``); a file it cannot decode, or a missing
one, raises ``ValueError``.

Schema (all vectors are 3-element lists; names are user-chosen keys):

    {
      "background": [0, 0, 0],
      "camera": {"look_from": [278, 278, -800], "look_at": [278, 278, 0],
                 "vfov_degrees": 40,            // + view_up, focus_dist,
                 "defocus_angle_degrees": 0},   //   all Camera fields
      "textures": {
        "red":   {"solid": [0.65, 0.05, 0.05]},
        "check": {"checker": {"inv_scale": 0.32, "even": "red", "odd": "w"}},
        "earth": {"image": "earth.png"}         // path, relative to the file
      },
      "materials": {
        "wall":  {"lambertian": "red"},         // texture name
        "fog":   {"isotropic": "w"},
        "shiny": {"metal": {"albedo": [0.8, 0.8, 0.8], "fuzz": 0.1}},
        "glass": {"dielectric": 1.5},
        "lamp":  {"diffuse_light": "bright"}
      },
      "entities": [                              // each may set "light": true
        {"sphere": {"center": [0,0,0], "radius": 2, "material": "glass"}},
        {"moving_sphere": {"center0": ..., "center1": ..., "radius": ...,
                           "material": ...}},
        {"quad": {"start": ..., "edge_u": ..., "edge_v": ...,
                  "material": "wall"}, "light": true},
        {"box": {"a": [...], "b": [...], "material": "wall"}},
        {"translate": {"offset": [1, 2, 3], "child": { ...entity... }}},
        {"rotate_y": {"angle_degrees": 15, "child": { ...entity... }}},
        {"collection": {"children": [ ...entities... ], "bvh": false}}
      ],
      "use_bvh": {"enable": true, "min_prims": 32}   // optional
    }
"""

from __future__ import annotations

import json
import os

from ..io.decode import decode_image
from ..scene import Camera, Scene, SceneBuilder


def _vec(v, what: str):
    if not (isinstance(v, (list, tuple)) and len(v) == 3):
        raise ValueError(f"{what} must be a 3-element list, got {v!r}")
    return tuple(float(x) for x in v)


def _build_textures(b: SceneBuilder, spec: dict, base_dir: str) -> dict:
    """Two passes, so that a checker can name any texture whatever the
    declaration order."""
    ids: dict = {}
    checkers = []
    for name, t in spec.items():
        if not isinstance(t, dict) or len(t) != 1:
            raise ValueError(f"texture {name!r}: expected one kind key")
        (kind, val), = t.items()
        if kind == "solid":
            ids[name] = b.solid_color(_vec(val, f"texture {name!r} solid"))
        elif kind == "image":
            ids[name] = b.image_texture(decode_image(os.path.join(base_dir, str(val))))
        elif kind == "checker":
            checkers.append((name, val))
        else:
            raise ValueError(f"texture {name!r}: unknown kind {kind!r}")
    for name, val in checkers:
        try:
            even, odd = ids[val["even"]], ids[val["odd"]]
        except KeyError as e:
            raise ValueError(
                f"texture {name!r}: checker child {e} not defined (checker "
                "children must not themselves be checkers in a scene file)"
            ) from None
        ids[name] = b.checkerboard(float(val["inv_scale"]), even, odd)
    return ids


def _build_materials(b: SceneBuilder, spec: dict, tex: dict) -> dict:
    def tex_id(name, what):
        if name not in tex:
            raise ValueError(f"material {what!r}: unknown texture {name!r}")
        return tex[name]

    ids: dict = {}
    for name, m in spec.items():
        if not isinstance(m, dict) or len(m) != 1:
            raise ValueError(f"material {name!r}: expected one kind key")
        (kind, val), = m.items()
        if kind == "lambertian":
            ids[name] = b.lambertian(tex_id(val, name))
        elif kind == "isotropic":
            ids[name] = b.isotropic(tex_id(val, name))
        elif kind == "diffuse_light":
            ids[name] = b.diffuse_light(tex_id(val, name))
        elif kind == "metal":
            ids[name] = b.metal(
                _vec(val["albedo"], f"material {name!r} albedo"),
                float(val.get("fuzz", 0.0)),
            )
        elif kind == "dielectric":
            ids[name] = b.dielectric(float(val))
        else:
            raise ValueError(f"material {name!r}: unknown kind {kind!r}")
    return ids


def _build_entity(b: SceneBuilder, e: dict, mats: dict, top: bool = False):
    if not top and e.get("light"):
        # a nested light would miss the light list without a word
        raise ValueError(
            '"light": true is only supported on top-level entities — '
            "lift the emitter out of its translate/rotate_y/collection"
        )
    spec = {k: v for k, v in e.items() if k != "light"}
    if len(spec) != 1:
        raise ValueError(f"entity: expected one kind key, got {sorted(spec)}")
    (kind, val), = spec.items()

    def mat(name):
        if name not in mats:
            raise ValueError(f"{kind}: unknown material {name!r}")
        return mats[name]

    if kind == "sphere":
        return b.sphere(
            _vec(val["center"], "sphere center"), float(val["radius"]),
            mat(val["material"]),
        )
    if kind == "moving_sphere":
        return b.moving_sphere(
            _vec(val["center0"], "moving_sphere center0"),
            _vec(val["center1"], "moving_sphere center1"),
            float(val["radius"]), mat(val["material"]),
        )
    if kind == "quad":
        return b.quad(
            _vec(val["start"], "quad start"),
            _vec(val["edge_u"], "quad edge_u"),
            _vec(val["edge_v"], "quad edge_v"),
            mat(val["material"]),
        )
    if kind == "box":
        return b.box(
            _vec(val["a"], "box a"), _vec(val["b"], "box b"),
            mat(val["material"]),
        )
    if kind == "translate":
        return b.translate(
            _vec(val["offset"], "translate offset"),
            _build_entity(b, val["child"], mats),
        )
    if kind == "rotate_y":
        return b.rotate_y(
            float(val["angle_degrees"]), _build_entity(b, val["child"], mats)
        )
    if kind == "collection":
        return b.collection(
            [_build_entity(b, c, mats) for c in val["children"]],
            bvh=bool(val.get("bvh", False)),
        )
    raise ValueError(f"entity: unknown kind {kind!r}")


def load_scene_file(path: str, name: str | None = None, device="cuda",
                    texture_lut=None) -> Scene:
    """Parse a JSON scene file and compile it (see the module docstring
    for the schema) with its tables on ``device``, the card unless asked
    for the CPU; ``texture_lut`` as ``SceneBuilder.compile`` takes it.
    Relative image-texture paths resolve against the file's directory."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: top level must be an object")

    b = SceneBuilder()
    base_dir = os.path.dirname(os.path.abspath(path))

    if "background" in doc:
        b.set_background(_vec(doc["background"], "background"))
    cam_spec = doc.get("camera")
    if not isinstance(cam_spec, dict):
        raise ValueError(f"{path}: a 'camera' object is required")
    allowed = {
        "look_from", "look_at", "view_up", "vfov_degrees", "focus_dist",
        "defocus_angle_degrees",
    }
    unknown = set(cam_spec) - allowed
    if unknown:
        raise ValueError(f"{path}: unknown camera fields {sorted(unknown)}")
    cam_kwargs = dict(cam_spec)
    for k in ("look_from", "look_at", "view_up"):
        if k in cam_kwargs:
            cam_kwargs[k] = _vec(cam_kwargs[k], f"camera {k}")
    b.set_camera(Camera(**cam_kwargs))

    tex = _build_textures(b, doc.get("textures", {}), base_dir)
    mats = _build_materials(b, doc.get("materials", {}), tex)

    lights = []
    for e in doc.get("entities", []):
        node = b.add(_build_entity(b, e, mats, top=True))
        if e.get("light"):
            lights.append(node)
    if lights:
        b.set_lights(lights)

    bvh = doc.get("use_bvh")
    if bvh:
        b.use_bvh(bool(bvh.get("enable", True)),
                  min_prims=int(bvh.get("min_prims", 32)))

    return b.compile(name=name or os.path.basename(path), device=device,
                     texture_lut=texture_lut)
