"""Scene description and compilation to flat tables of torch tensors
(counterpart of ``scene.py``).

``SceneBuilder`` mirrors the JAX package's construction surface and its
host build is the same numpy code, so every table comes out bit-identical;
only the last step differs, where the tables become tensors on the scene's
explicit ``device``.  ``compiled_from_arrays`` builds the same
``CompiledScene`` from another build's tables (the JAX scene's, in the
tests), so both renderers can start from identical state.

``SceneBuilder.use_bvh`` builds the per-kind group trees that the
closest-hit and render kernels walk (``geometry/bvh.py``), for each kind
with at least ``TREE_MIN_PRIMS`` primitives.  Image textures are packed
into one atlas of r | g << 8 | b << 16 texels and, with a texel budget
(``compile(texture_lut=N)`` or ``ZWRT_TEX_LUT``), into the texture LUT as
well: every image box-downsampled to at most N texels and stored unpadded
in one flat table, which the whole-render kernel reads.  Image-textured
emitters are ordinary materials.  With ``ZWRT_UNI_TREE`` set at compile,
a scene whose two kinds both have trees also gets the unified both-kind
tree (``uni_tree_*``), which the render and bounce kernels then walk in
place of the two per-kind trees; the per-kind trees stay for the
first-hit probe.  A checker of checkers cannot flatten into one shade
record: the scene sets ``has_nested_checker``, the record's ``texid``
column names its texture and the renderer takes the fixed-depth wavefront
(``render/renderer.py:_render_band``), whose shading walks the texture
table (``textures.py:texture_value``).
"""

from __future__ import annotations

import math as _math
import weakref
from dataclasses import dataclass, field, fields
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import real, real_np
from .math.v3 import V3

# Type codes (tagged-union tags become table codes).
MAT_LAMBERTIAN = 0
MAT_ISOTROPIC = 1
MAT_METAL = 2
MAT_DIELECTRIC = 3
MAT_DIFFUSE_LIGHT = 4

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

PRIM_SPHERE = 0
PRIM_QUAD = 1

# Primitive count from which the JAX package builds group trees for a kind.
TREE_MIN_PRIMS = 64

_F = real_np
_I = np.int32

# ---------------------------------------------------------------------------
# Camera (host-side)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Camera:
    """Look-at camera with optional defocus (depth of field)."""

    look_from: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    view_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 40.0
    focus_dist: float = 10.0
    defocus_angle_degrees: float = 0.0
    # Raster-grid shift in pixel units applied to pixel00 (default none).
    raster_shift: Tuple[float, float] = (0.0, 0.0)

    def basis(self):
        lf = np.asarray(self.look_from, np.float64)
        la = np.asarray(self.look_at, np.float64)
        vup = np.asarray(self.view_up, np.float64)
        w = lf - la
        w = w / np.linalg.norm(w)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        return u, v, w

    @property
    def has_depth_of_field(self) -> bool:
        return self.defocus_angle_degrees > 0.0

    def defocus_disk(self):
        u, v, _ = self.basis()
        radius = self.focus_dist * _math.tan(
            _math.radians(self.defocus_angle_degrees / 2.0)
        )
        return u * radius, v * radius

    def viewport(self, width: int, height: int):
        """Returns (pixel00_loc, pixel_delta_u, pixel_delta_v) as f32."""
        u, v, w = self.basis()
        aspect = width / height
        theta = _math.radians(self.vfov_degrees)
        h = _math.tan(theta / 2.0)
        vp_height = 2.0 * h * self.focus_dist
        vp_width = vp_height * aspect
        vp_u = vp_width * u
        vp_v = -vp_height * v
        lf = np.asarray(self.look_from, np.float64)
        upper_left = lf - self.focus_dist * w - vp_u / 2 - vp_v / 2
        du = vp_u / width
        dv = vp_v / height
        pixel00 = (
            upper_left + 0.5 * (du + dv)
            + self.raster_shift[0] * du + self.raster_shift[1] * dv
        )
        return pixel00.astype(_F), du.astype(_F), dv.astype(_F)


# ---------------------------------------------------------------------------
# Host-side entity nodes (flattened away at compile time)
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    pass


@dataclass
class SphereNode(_Node):
    center: np.ndarray
    radius: float
    material: int
    move_to: Optional[np.ndarray] = None  # animated endpoint (motion blur)


@dataclass
class QuadNode(_Node):
    start: np.ndarray
    edge_u: np.ndarray
    edge_v: np.ndarray
    material: int


@dataclass
class ListNode(_Node):
    children: List[_Node] = field(default_factory=list)


@dataclass
class TranslateNode(_Node):
    offset: np.ndarray
    child: _Node


@dataclass
class RotateYNode(_Node):
    angle_degrees: float
    child: _Node


# ---------------------------------------------------------------------------
# Compiled scene
# ---------------------------------------------------------------------------

# Tensor fields the slice reads; V3 fields hold three (S,) tensors.
V3_FIELDS = (
    "sph_center", "sph_move", "quad_start", "quad_u", "quad_v",
    "quad_normal", "quad_w", "mat_albedo", "tex_rgb", "background",
)
ARRAY_FIELDS = (
    "sph_center", "sph_radius", "sph_move", "sph_uv_cos", "sph_uv_sin",
    "sph_mat",
    "quad_start", "quad_u", "quad_v", "quad_normal", "quad_w", "quad_offset",
    "quad_area", "quad_mat",
    "mat_type", "mat_tex", "mat_albedo", "mat_fuzz", "mat_refract",
    "tex_type", "tex_rgb", "tex_inv_scale", "tex_even", "tex_odd", "tex_img",
    "background", "shade_rows", "atlas_packed", "atlas_wh",
)
STATIC_FIELDS = (
    "n_spheres", "n_quads", "n_materials", "n_textures", "has_moving",
    "needs_gauss", "lights", "light_params", "background_rgb",
    "has_image_textures", "image_dims", "has_emissive_image", "tex_lut_dims",
    "has_nested_checker",
)
# Per-kind group trees (``CompiledScene.sph_tree_*`` / ``quad_tree_*``):
# node boxes, links and the leaf-slot attribute tuple (7 sphere or 13 quad
# f32 columns, then the i32 original index of each slot).
TREE_FIELDS = (
    "sph_tree_box", "sph_tree_link", "sph_tree_attrs",
    "quad_tree_box", "quad_tree_link", "quad_tree_attrs",
)
TREE_STATIC_FIELDS = (
    "has_sph_tree", "has_quad_tree", "sph_leaf_span", "quad_leaf_span",
)
# The unified both-kind tree (``CompiledScene.uni_*``): node boxes, links
# [miss, first leaf group or -1, leaf kind or -1] and each kind's
# leaf-slot attribute tuple, laid out as the per-kind trees' attributes.
UNI_FIELDS = ("uni_tree_box", "uni_tree_link", "uni_sph_attrs", "uni_quad_attrs")
UNI_STATIC_FIELDS = ("has_uni_tree", "uni_leaf_span")
@dataclass(frozen=True, eq=False)
class CompiledScene:
    """SoA scene tables as tensors on ``device``, plus static metadata.

    ``eq=False`` keeps identity hashing: the renderer's cost-map cache keys
    scenes weakly by object."""

    sph_center: V3
    sph_radius: torch.Tensor
    sph_move: V3
    sph_uv_cos: torch.Tensor
    sph_uv_sin: torch.Tensor
    sph_mat: torch.Tensor
    quad_start: V3
    quad_u: V3
    quad_v: V3
    quad_normal: V3
    quad_w: V3
    quad_offset: torch.Tensor
    quad_area: torch.Tensor
    quad_mat: torch.Tensor
    mat_type: torch.Tensor
    mat_tex: torch.Tensor
    mat_albedo: V3
    mat_fuzz: torch.Tensor
    mat_refract: torch.Tensor
    tex_type: torch.Tensor
    tex_rgb: V3
    tex_inv_scale: torch.Tensor
    tex_even: torch.Tensor
    tex_odd: torch.Tensor
    # each texture's atlas image id (0 unless an image)
    tex_img: torch.Tensor
    background: V3
    # (n_spheres + n_quads, 32) per-prim shading records (ops/shade.py)
    shade_rows: torch.Tensor
    # (I, h_max, w_max) int32 atlas of r | g << 8 | b << 16 texels, each
    # image top-left aligned (magenta 1x1 without images), and each image's
    # (width, height) as (I, 2) int32
    atlas_packed: torch.Tensor
    atlas_wh: torch.Tensor
    device: torch.device
    # Per-kind group trees (geometry/bvh.py:build_group_tree): node boxes
    # (n_nodes, 6) f32 [min xyz, max xyz], links (n_nodes, 2) i32 [miss
    # link, first leaf group or -1], and the leaf-slot attributes as flat
    # (n_groups * 8,) tensors: spheres cx cy cz r^2 mx my mz, quads sx sy sz
    # nx ny nz A = v x w, B = w x u, offset; the last entry is each slot's
    # original primitive index (i32).  Padding slots are unhittable.
    # Placeholders ((1, 6), (1, 2), ()) when the kind has no tree.
    sph_tree_box: torch.Tensor
    sph_tree_link: torch.Tensor
    sph_tree_attrs: tuple
    quad_tree_box: torch.Tensor
    quad_tree_link: torch.Tensor
    quad_tree_attrs: tuple
    # The unified tree (geometry/bvh.py:build_group_tree_unified) when
    # has_uni_tree: boxes (n_nodes, 6), links (n_nodes, 3) [miss link,
    # first leaf group or -1, leaf kind or -1], and the sphere and quad
    # leaf-slot attributes as in ``*_tree_attrs``.  Placeholders ((1, 6),
    # (1, 3), (), ()) otherwise.
    uni_tree_box: torch.Tensor
    uni_tree_link: torch.Tensor
    uni_sph_attrs: tuple
    uni_quad_attrs: tuple
    n_spheres: int = 0
    n_quads: int = 0
    n_materials: int = 0
    n_textures: int = 0
    has_moving: bool = False
    # True iff a material consumes the per-bounce gaussian triple
    # (isotropic scatter or fuzzy metal).
    needs_gauss: bool = True
    # Importance-sampled light list ((kind, idx), ...) and its geometry:
    # (PRIM_SPHERE, (cx, cy, cz, r)) or (PRIM_QUAD, (sx, sy, sz, ux, uy, uz,
    # vx, vy, vz, nx, ny, nz, wx, wy, wz, offset, area)).
    lights: Tuple[Tuple[int, int], ...] = ()
    light_params: Tuple = ()
    background_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # True iff a texture, or a checker's child, is an image
    has_image_textures: bool = False
    # static (width, height) of each atlas image
    image_dims: Tuple[Tuple[int, int], ...] = ((1, 1),)
    # True iff an emissive material's texture is an image (or a checker
    # with an image child)
    has_emissive_image: bool = False
    # The texture LUT (None / () without one): every image, box-downsampled
    # to the budget, as flat int32 r | g << 8 | b << 16 texels, each image
    # 128-aligned, and its static (width, height, base offset)
    tex_lut_tab: Optional[torch.Tensor] = None
    tex_lut_dims: Tuple[Tuple[int, int, int], ...] = ()
    # True iff a checker has a checker child: the kernels' shade record
    # cannot hold its colours, so the fixed-depth wavefront renders it
    has_nested_checker: bool = False
    has_sph_tree: bool = False
    has_quad_tree: bool = False
    # Leaf spans in groups of 8 slots (geometry/bvh.py:pick_leaf_span),
    # recorded so that tree layout and traversal always agree.
    sph_leaf_span: int = 32
    quad_leaf_span: int = 32
    has_uni_tree: bool = False
    uni_leaf_span: int = 32

    @property
    def n_lights(self) -> int:
        return len(self.lights)

    @property
    def has_lights(self) -> bool:
        return len(self.lights) > 0


@dataclass(frozen=True)
class Scene:
    """A compiled scene plus its host-side render parameters."""

    compiled: CompiledScene
    camera: Camera
    background: Tuple[float, float, float]
    name: str = "scene"


def compiled_from_arrays(fields: dict, static: dict, device) -> CompiledScene:
    """Build a ``CompiledScene`` on ``device`` from another build's tables.

    ``fields`` maps each name in ``ARRAY_FIELDS`` to a numpy array (a V3
    field as its (3, S) stack, e.g. ``np.asarray(cs.sph_center)`` of a JAX
    scene), may map the names in ``TREE_FIELDS`` to a scene's group trees
    (``*_tree_attrs`` as a tuple of arrays) and, when ``static`` says
    ``has_uni_tree``, the names in ``UNI_FIELDS`` to the unified tree; when
    ``static`` has a nonempty ``tex_lut_dims``, ``fields`` maps
    ``tex_lut_tab`` to the texture LUT in any shape (the JAX scene's
    (R, 128) table is taken flat).  ``static`` maps each name in
    ``STATIC_FIELDS`` to its value, may carry ``TREE_STATIC_FIELDS`` and
    ``UNI_STATIC_FIELDS``, and may carry the JAX scene's other feature
    flags, which are ignored.  A CUDA ``device`` without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"scene device {device}: CUDA is not available (pass device='cpu' "
            "for the plain versions)"
        )

    def tensor(a):
        a = np.asarray(a)
        dtype = real if a.dtype.kind == "f" else torch.int32
        if a.dtype == np.uint32:  # the atlas: 24-bit texels fit int32
            a = a.astype(np.int32)
        return torch.tensor(a, dtype=dtype, device=device)

    kw = {}
    for name in ARRAY_FIELDS:
        a = np.asarray(fields[name])
        kw[name] = V3(*(tensor(a[i]) for i in range(3))) if name in V3_FIELDS else tensor(a)
    for name in STATIC_FIELDS:
        kw[name] = static[name]
    kw["tex_lut_dims"] = tuple((int(w), int(h), int(base)) for w, h, base in kw["tex_lut_dims"])
    if kw["tex_lut_dims"]:
        kw["tex_lut_tab"] = tensor(np.asarray(fields["tex_lut_tab"]).reshape(-1))
    for kind in ("sph", "quad"):
        has_tree = bool(static.get(f"has_{kind}_tree", False))
        kw[f"has_{kind}_tree"] = has_tree
        kw[f"{kind}_leaf_span"] = int(static.get(f"{kind}_leaf_span", 32))
        if has_tree:
            box = np.asarray(fields[f"{kind}_tree_box"], _F)
            link = np.asarray(fields[f"{kind}_tree_link"], _I)
            attrs = tuple(np.asarray(a) for a in fields[f"{kind}_tree_attrs"])
        else:
            box, link, attrs = np.zeros((1, 6), _F), np.zeros((1, 2), _I), ()
        kw[f"{kind}_tree_box"] = tensor(box)
        kw[f"{kind}_tree_link"] = tensor(link)
        kw[f"{kind}_tree_attrs"] = tuple(tensor(a) for a in attrs)
    kw["has_uni_tree"] = bool(static.get("has_uni_tree", False))
    kw["uni_leaf_span"] = int(static.get("uni_leaf_span", 32))
    if kw["has_uni_tree"]:
        box = np.asarray(fields["uni_tree_box"], _F)
        link = np.asarray(fields["uni_tree_link"], _I)
        sph, quad = (tuple(np.asarray(a) for a in fields[f"uni_{k}_attrs"])
                     for k in ("sph", "quad"))
    else:
        box, link, sph, quad = np.zeros((1, 6), _F), np.zeros((1, 3), _I), (), ()
    kw["uni_tree_box"] = tensor(box)
    kw["uni_tree_link"] = tensor(link)
    kw["uni_sph_attrs"] = tuple(tensor(a) for a in sph)
    kw["uni_quad_attrs"] = tuple(tensor(a) for a in quad)
    kw["lights"] = tuple((int(k), int(i)) for k, i in kw["lights"])
    kw["light_params"] = tuple(
        (int(k), tuple(float(v) for v in p)) for k, p in kw["light_params"]
    )
    kw["background_rgb"] = tuple(float(v) for v in kw["background_rgb"])
    kw["has_image_textures"] = bool(kw["has_image_textures"])
    kw["has_nested_checker"] = bool(kw["has_nested_checker"])
    kw["image_dims"] = tuple((int(w), int(h)) for w, h in kw["image_dims"])
    # the tensors' device carries the index ("cuda" -> "cuda:0")
    return CompiledScene(device=kw["shade_rows"].device, **kw)


# Copies made by ``compiled_on``, keyed weakly on the source scene: each a
# {device: CompiledScene} dict that dies with its scene.
_ON_DEVICE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _to_device(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, V3):
        return V3(*(_to_device(v, device) for v in value))
    if isinstance(value, tuple):
        return tuple(_to_device(v, device) for v in value)
    return value


def compiled_on(cs: CompiledScene, device: torch.device) -> CompiledScene:
    """``cs`` with every tensor on ``device`` (an indexed device, as
    ``CompiledScene.device`` is) and every other field as it is: ``cs``
    itself on its own device, else a copy made once per (scene, device)."""
    if device == cs.device:
        return cs
    per = _ON_DEVICE.get(cs)
    if per is None:
        per = _ON_DEVICE.setdefault(cs, {})
    out = per.get(device)
    if out is None:
        kw = {f.name: _to_device(getattr(cs, f.name), device) for f in fields(cs)}
        kw["device"] = device
        out = per[device] = CompiledScene(**kw)
    return out


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

def _rot_y(angle_degrees: float) -> np.ndarray:
    """Object->world Y-rotation."""
    th = _math.radians(angle_degrees)
    c, s = _math.cos(th), _math.sin(th)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


class SceneBuilder:
    """Host-side scene construction producing flat tables."""

    def __init__(self) -> None:
        self._textures: List[dict] = []
        self._images: List[np.ndarray] = []
        self._materials: List[dict] = []
        self._roots: List[_Node] = []
        self._lights: List[_Node] = []
        self._camera: Optional[Camera] = None
        self._background = (0.0, 0.0, 0.0)
        self._root_bvh = False
        self._bvh_min_prims = 32

    # -- textures ----------------------------------------------------------
    def solid_color(self, rgb) -> int:
        self._textures.append({"kind": TEX_SOLID, "rgb": tuple(rgb)})
        return len(self._textures) - 1

    def checkerboard(self, inv_scale: float, tex_even: int, tex_odd: int) -> int:
        self._textures.append(
            {"kind": TEX_CHECKER, "inv_scale": inv_scale,
             "even": tex_even, "odd": tex_odd}
        )
        return len(self._textures) - 1

    def image_texture(self, image: np.ndarray) -> int:
        """``image`` is (H, W, 3) uint8."""
        self._images.append(np.ascontiguousarray(image[..., :3], dtype=np.uint8))
        self._textures.append({"kind": TEX_IMAGE, "img": len(self._images) - 1})
        return len(self._textures) - 1

    # -- materials ----------------------------------------------------------
    def lambertian(self, texture: int) -> int:
        self._materials.append({"type": MAT_LAMBERTIAN, "tex": texture})
        return len(self._materials) - 1

    def isotropic(self, texture: int) -> int:
        self._materials.append({"type": MAT_ISOTROPIC, "tex": texture})
        return len(self._materials) - 1

    def metal(self, albedo, fuzz: float) -> int:
        self._materials.append(
            {"type": MAT_METAL, "albedo": tuple(albedo), "fuzz": float(fuzz)}
        )
        return len(self._materials) - 1

    def dielectric(self, refraction_index: float) -> int:
        self._materials.append(
            {"type": MAT_DIELECTRIC, "refract": float(refraction_index)}
        )
        return len(self._materials) - 1

    def diffuse_light(self, texture: int) -> int:
        self._materials.append({"type": MAT_DIFFUSE_LIGHT, "tex": texture})
        return len(self._materials) - 1

    # -- entities ------------------------------------------------------------
    def sphere(self, center, radius: float, material: int) -> SphereNode:
        return SphereNode(np.asarray(center, np.float64), float(radius), material)

    def moving_sphere(self, center0, center1, radius: float, material: int) -> SphereNode:
        return SphereNode(
            np.asarray(center0, np.float64), float(radius), material,
            move_to=np.asarray(center1, np.float64),
        )

    def quad(self, start, edge_u, edge_v, material: int) -> QuadNode:
        return QuadNode(
            np.asarray(start, np.float64),
            np.asarray(edge_u, np.float64),
            np.asarray(edge_v, np.float64),
            material,
        )

    def box(self, point_a, point_b, material: int) -> ListNode:
        """Six quads spanning two opposite corners."""
        a = np.asarray(point_a, np.float64)
        b = np.asarray(point_b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        d = mx - mn
        dx = np.array([d[0], 0, 0])
        dy = np.array([0, d[1], 0])
        dz = np.array([0, 0, d[2]])
        faces = [
            (np.array([mn[0], mn[1], mx[2]]), dx, dy),    # front
            (np.array([mx[0], mn[1], mx[2]]), -dz, dy),   # right
            (np.array([mx[0], mn[1], mn[2]]), -dx, dy),   # back
            (np.array([mn[0], mn[1], mn[2]]), dz, dy),    # left
            (np.array([mn[0], mx[1], mx[2]]), dx, -dz),   # top
            (np.array([mn[0], mn[1], mn[2]]), dx, dz),    # bottom
        ]
        return ListNode([QuadNode(p, u, v, material) for p, u, v in faces])

    def collection(self, children: Sequence[_Node], bvh: bool = False) -> ListNode:
        """``bvh`` is accepted as the JAX package accepts it: the compile
        flattens every collection and builds trees over the whole scene."""
        return ListNode(list(children))

    def translate(self, offset, child: _Node) -> TranslateNode:
        return TranslateNode(np.asarray(offset, np.float64), child)

    def rotate_y(self, angle_degrees: float, child: _Node) -> RotateYNode:
        return RotateYNode(float(angle_degrees), child)

    # -- scene assembly -------------------------------------------------------
    def add(self, node: _Node) -> _Node:
        self._roots.append(node)
        return node

    def set_lights(self, lights: Sequence[_Node]) -> None:
        """Entities to importance-sample; collections expand to leaves."""
        self._lights = list(lights)

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera

    def set_background(self, rgb) -> None:
        self._background = tuple(rgb)

    def use_bvh(self, enable: bool = True, min_prims: int = 32) -> None:
        """Request acceleration trees over the flattened primitives: from
        ``min_prims`` primitives on, each kind with at least
        ``TREE_MIN_PRIMS`` primitives gets a group tree; the rest stays
        brute force."""
        self._root_bvh = enable
        self._bvh_min_prims = min_prims

    # -- compile --------------------------------------------------------------
    def compile(self, name: str = "scene", *, device="cuda",
                texture_lut: Optional[int] = None) -> Scene:
        """The scene's tables on ``device`` (the card unless asked for the
        CPU; a CUDA device without a GPU raises).  ``texture_lut`` > 0 also
        packs the images into the texture LUT at that texel budget (a
        budget of at least an image's size keeps it exact); None takes the
        budget from ``ZWRT_TEX_LUT``, as the JAX package does."""
        texture_lut = texture_lut or 0
        spheres: List[dict] = []
        quads: List[dict] = []
        prim_of_node: dict = {}

        def walk(node: _Node, R: np.ndarray, t: np.ndarray, yrot: float):
            if isinstance(node, SphereNode):
                c = R @ node.center + t
                move = (
                    R @ (node.move_to - node.center)
                    if node.move_to is not None
                    else np.zeros(3)
                )
                prim_of_node[id(node)] = (PRIM_SPHERE, len(spheres))
                spheres.append(
                    {"center": c, "radius": node.radius, "move": move,
                     "mat": node.material, "yrot": yrot}
                )
            elif isinstance(node, QuadNode):
                prim_of_node[id(node)] = (PRIM_QUAD, len(quads))
                quads.append(
                    {"start": R @ node.start + t, "u": R @ node.edge_u,
                     "v": R @ node.edge_v, "mat": node.material}
                )
            elif isinstance(node, ListNode):
                for ch in node.children:
                    walk(ch, R, t, yrot)
            elif isinstance(node, TranslateNode):
                # a translate nested inside a rotate offsets in the rotated
                # frame: world = R @ (p + offset)
                walk(node.child, R, t + R @ node.offset, yrot)
            elif isinstance(node, RotateYNode):
                walk(node.child, R @ _rot_y(node.angle_degrees), t,
                     yrot + node.angle_degrees)
            else:
                raise TypeError(f"unknown node type {type(node)}")

        for root in self._roots:
            walk(root, np.eye(3), np.zeros(3), 0.0)

        light_entries: List[Tuple[int, int]] = []

        def collect_light(node: _Node):
            if isinstance(node, ListNode):
                for ch in node.children:
                    collect_light(ch)
            elif id(node) not in prim_of_node:
                raise ValueError("light entity was never added to the scene")
            else:
                light_entries.append(prim_of_node[id(node)])

        for ln in self._lights:
            collect_light(ln)

        build_trees = (
            self._root_bvh and (len(spheres) + len(quads)) >= self._bvh_min_prims
        )
        compiled = _compile_tables(
            spheres, quads, self._materials, self._textures, self._images,
            light_entries, self._background, device, build_trees,
            int(texture_lut),
        )
        camera = self._camera or Camera(look_from=(0, 0, 9), look_at=(0, 0, 0))
        return Scene(
            compiled=compiled, camera=camera,
            background=self._background, name=name,
        )


def _morton_code(points: np.ndarray) -> np.ndarray:
    """30-bit 3D Morton codes for an (N, 3) point cloud (normalized to its
    own bounding box)."""
    lo = points.min(0)
    span = np.maximum(points.max(0) - lo, 1e-12)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def _morton_sort(prims: list, center_fn):
    """Primitive tables are stored in Morton order, as the JAX package
    stores them; returns (sorted_prims, old->new index map)."""
    if len(prims) < 2:
        return prims, {i: i for i in range(len(prims))}
    pts = np.stack([center_fn(p) for p in prims])
    order = np.argsort(_morton_code(pts), kind="stable")
    perm = {int(old): new for new, old in enumerate(order)}
    return [prims[i] for i in order], perm


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _shade_block(materials, textures, mat_id: int) -> list:
    """The 14 shading columns of one material's record (ops/shade.py)."""
    m = materials[mat_id] if materials else {"type": MAT_LAMBERTIAN}
    mt = m["type"]
    tex_kind, img, img2, texid = TEX_SOLID, -1, -1, 0
    rgb, rgb2 = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    inv_scale, fz, refract = 0.0, 0.0, 1.0
    if mt == MAT_METAL:
        rgb = m.get("albedo", (0, 0, 0))
        fz = m.get("fuzz", 0.0)
    elif mt == MAT_DIELECTRIC:
        refract = m.get("refract", 1.5)
    else:  # lambertian / isotropic / diffuse-light: texture-driven
        texid = m.get("tex", 0)
        t = textures[texid] if textures else {"kind": TEX_SOLID, "rgb": (0, 0, 0)}
        if t["kind"] == TEX_SOLID:
            rgb = t["rgb"]
        elif t["kind"] == TEX_CHECKER:
            tex_kind = TEX_CHECKER
            inv_scale = t["inv_scale"]

            def child_rgb_img(tid):
                # an image child gets the neutral albedo and its image id;
                # the atlas colour replaces it at the hit.  A checker child
                # leaves its slots unread: the general walk shades it
                child = textures[tid]
                if child["kind"] == TEX_IMAGE:
                    return (1.0, 1.0, 1.0), child["img"]
                if child["kind"] == TEX_CHECKER:
                    return (1.0, 1.0, 1.0), -1
                return child["rgb"], -1

            rgb, img = child_rgb_img(t["even"])
            rgb2, img2 = child_rgb_img(t["odd"])
        else:
            tex_kind = TEX_IMAGE
            img = t["img"]
    return [float(mt), float(tex_kind), float(img), *map(float, rgb),
            *map(float, rgb2), float(inv_scale), float(fz),
            float(refract), float(img2), float(texid)]


def _leaf_attrs(slots, cols_and_fills):
    """Leaf-slot-ordered attribute arrays; -1 slots get the unhittable fill
    value.  The last array is each slot's original primitive index."""
    padm = slots < 0
    safe = np.where(padm, 0, slots)
    out = [np.where(padm, fill, col[safe]).astype(_F) for col, fill in cols_and_fills]
    out.append(np.where(padm, 0, slots).astype(_I))
    return tuple(out)


def _cross32(a, b):
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    return np.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], axis=1)


def _group_trees(sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v,
                 quad_normal, quad_w, quad_offset, n_s, n_q, build_trees):
    """The per-kind group trees, as the JAX package builds them: boxes from
    the float32 tables, padded on thin axes in float64, a tree for each
    kind with at least TREE_MIN_PRIMS primitives; and, when both kinds
    have one and ``ZWRT_UNI_TREE`` is set, the unified tree over both."""
    from .geometry.bvh import build_group_tree, build_group_tree_unified, pick_leaf_span
    from .math.aabb import aabb_pad_to_minimum

    out = {"sph_leaf_span": pick_leaf_span(n_s), "quad_leaf_span": pick_leaf_span(n_q)}
    sph_lo = np.minimum(sph_center[:n_s] - sph_radius[:n_s, None],
                        sph_center[:n_s] + sph_move[:n_s] - sph_radius[:n_s, None])
    sph_hi = np.maximum(sph_center[:n_s] + sph_radius[:n_s, None],
                        sph_center[:n_s] + sph_move[:n_s] + sph_radius[:n_s, None])
    c0 = quad_start[:n_q]
    c1 = c0 + quad_u[:n_q]
    c2 = c0 + quad_v[:n_q]
    c3 = c1 + quad_v[:n_q]
    quad_lo = np.minimum(np.minimum(c0, c1), np.minimum(c2, c3))
    quad_hi = np.maximum(np.maximum(c0, c1), np.maximum(c2, c3))
    qa = _cross32(quad_v[:n_q], quad_w[:n_q])
    qb = _cross32(quad_w[:n_q], quad_u[:n_q])
    cols = {
        "sph": [
            (sph_center[:n_s, 0], 1e30), (sph_center[:n_s, 1], 1e30),
            (sph_center[:n_s, 2], 1e30), (sph_radius[:n_s] ** 2, 0.0),
            (sph_move[:n_s, 0], 0.0), (sph_move[:n_s, 1], 0.0),
            (sph_move[:n_s, 2], 0.0),
        ],
        # zero normal -> parallel -> unhittable padding; A and B in f32
        # with v3.cross's operation order
        "quad": [
            (quad_start[:n_q, 0], 0.0), (quad_start[:n_q, 1], 0.0),
            (quad_start[:n_q, 2], 0.0),
            (quad_normal[:n_q, 0], 0.0), (quad_normal[:n_q, 1], 0.0),
            (quad_normal[:n_q, 2], 0.0),
            (qa[:, 0], 0.0), (qa[:, 1], 0.0), (qa[:, 2], 0.0),
            (qb[:, 0], 0.0), (qb[:, 1], 0.0), (qb[:, 2], 0.0),
            (quad_offset[:n_q], 0.0),
        ],
    }
    padded = {"sph": aabb_pad_to_minimum(sph_lo, sph_hi),
              "quad": aabb_pad_to_minimum(quad_lo, quad_hi)}
    for kind, n in (("sph", n_s), ("quad", n_q)):
        has_tree = build_trees and n >= TREE_MIN_PRIMS
        out[f"has_{kind}_tree"] = has_tree
        if has_tree:
            tr = build_group_tree(*padded[kind], leaf_groups=out[f"{kind}_leaf_span"])
            out[f"{kind}_tree_box"] = tr["node_box"]
            out[f"{kind}_tree_link"] = tr["node_link"]
            out[f"{kind}_tree_attrs"] = _leaf_attrs(tr["prim_slots"], cols[kind])
    out["has_uni_tree"] = False
    out["uni_leaf_span"] = pick_leaf_span(n_s + n_q)
    if out["has_uni_tree"]:
        tr = build_group_tree_unified(
            np.concatenate([padded["sph"][0], padded["quad"][0]]),
            np.concatenate([padded["sph"][1], padded["quad"][1]]),
            np.concatenate([np.zeros(n_s, _I), np.ones(n_q, _I)]),
            np.concatenate([np.arange(n_s, dtype=_I), np.arange(n_q, dtype=_I)]),
            leaf_groups=out["uni_leaf_span"],
        )
        out["uni_tree_box"] = tr["node_box"]
        out["uni_tree_link"] = tr["node_link"]
        out["uni_sph_attrs"] = _leaf_attrs(tr["sph_slots"], cols["sph"])
        out["uni_quad_attrs"] = _leaf_attrs(tr["quad_slots"], cols["quad"])
    return out


def _box_downsample(im: np.ndarray, max_texels: int) -> np.ndarray:
    """Box-average an (H, W, 3) u8 image down until h*w <= max_texels
    (edge-padded to an integer factor).  Identity when it already fits."""
    h, w = im.shape[:2]
    if h * w <= max_texels:
        return im
    s = int(np.ceil(np.sqrt(h * w / max_texels)))
    while (-(-h // s)) * (-(-w // s)) > max_texels:
        s += 1
    hp, wp = -(-h // s) * s, -(-w // s) * s
    pad = np.pad(im, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    box = pad.reshape(hp // s, s, wp // s, s, 3).mean(axis=(1, 3))
    return np.rint(box).astype(np.uint8)


def _build_tex_lut(images, max_texels: int):
    """Pack (possibly downsampled) images into one flat int32 LUT of
    r | g << 8 | b << 16 texels, each image 128-aligned as in the JAX
    package (whose (R, 128) table holds the same values in rows), and the
    static ((w, h, base), ...) dims."""
    dims = []
    chunks = []
    base = 0
    for im in images:
        ds = _box_downsample(np.asarray(im), max_texels)
        h, w = ds.shape[:2]
        packed = (
            ds[..., 0].astype(np.uint32)
            | (ds[..., 1].astype(np.uint32) << 8)
            | (ds[..., 2].astype(np.uint32) << 16)
        ).reshape(-1)
        dims.append((int(w), int(h), int(base)))
        aligned = -(-packed.size // 128) * 128
        if aligned != packed.size:
            packed = np.concatenate(
                [packed, np.zeros(aligned - packed.size, np.uint32)]
            )
        chunks.append(packed)
        base += aligned
    return np.concatenate(chunks).astype(np.int32), tuple(dims)


def _checker_children(textures, t) -> list:
    if t["kind"] != TEX_CHECKER:
        return []
    return [textures[t["even"]], textures[t["odd"]]]


def _atlas(images):
    """(atlas_packed (I, h_max, w_max) uint32, atlas_wh (I, 2) int32): each
    image top-left aligned and packed r | g << 8 | b << 16; the magenta 1x1
    debug image when there are none."""
    if images:
        h_max = max(im.shape[0] for im in images)
        w_max = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), h_max, w_max, 3), np.uint8)
        atlas_wh = np.zeros((len(images), 2), _I)
        for i, im in enumerate(images):
            atlas[i, : im.shape[0], : im.shape[1]] = im
            atlas_wh[i] = (im.shape[1], im.shape[0])
    else:
        atlas = np.full((1, 1, 1, 3), (255, 0, 255), np.uint8)
        atlas_wh = np.array([[1, 1]], _I)
    a = atlas.astype(np.uint32)
    return a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16), atlas_wh


def _compile_tables(
    spheres, quads, materials, textures, images, light_entries, background,
    device, build_trees, lut_budget,
) -> CompiledScene:
    spheres, sph_perm = _morton_sort(
        spheres, lambda s: np.asarray(s["center"], np.float64)
    )
    quads, quad_perm = _morton_sort(
        quads,
        lambda q: np.asarray(q["start"], np.float64)
        + 0.5 * (np.asarray(q["u"], np.float64) + np.asarray(q["v"], np.float64)),
    )
    lights = tuple(
        (int(k), int(sph_perm[i] if k == PRIM_SPHERE else quad_perm[i]))
        for k, i in light_entries
    )

    n_s, n_q = len(spheres), len(quads)
    # Tables padded to a multiple of 8 (>= 8) as in the JAX package; dummy
    # prims are unhittable.
    s_pad = max(8, _round_up(max(n_s, 1), 8))
    q_pad = max(8, _round_up(max(n_q, 1), 8))

    sph_center = np.full((s_pad, 3), 1e30, _F)
    sph_radius = np.zeros((s_pad,), _F)
    sph_move = np.zeros((s_pad, 3), _F)
    sph_uv_cos = np.ones((s_pad,), _F)
    sph_uv_sin = np.zeros((s_pad,), _F)
    sph_mat = np.zeros((s_pad,), _I)
    for i, s in enumerate(spheres):
        sph_center[i] = s["center"]
        sph_radius[i] = s["radius"]
        sph_move[i] = s["move"]
        th = _math.radians(s["yrot"])
        sph_uv_cos[i] = _math.cos(th)
        sph_uv_sin[i] = _math.sin(th)
        sph_mat[i] = s["mat"]

    quad_start = np.zeros((q_pad, 3), _F)
    quad_u = np.zeros((q_pad, 3), _F)
    quad_v = np.zeros((q_pad, 3), _F)
    quad_normal = np.zeros((q_pad, 3), _F)  # zero normal => parallel => miss
    quad_w = np.zeros((q_pad, 3), _F)
    quad_offset = np.zeros((q_pad,), _F)
    quad_area = np.zeros((q_pad,), _F)
    quad_mat = np.zeros((q_pad,), _I)
    for i, q in enumerate(quads):
        n_raw = np.cross(q["u"], q["v"])
        nn = float(n_raw @ n_raw)
        n_unit = n_raw / _math.sqrt(nn)
        quad_start[i] = q["start"]
        quad_u[i] = q["u"]
        quad_v[i] = q["v"]
        quad_normal[i] = n_unit
        quad_w[i] = n_raw / nn
        quad_offset[i] = float(n_unit @ q["start"])
        quad_area[i] = _math.sqrt(nn)
        quad_mat[i] = q["mat"]

    n_m = max(len(materials), 1)
    mat_type = np.zeros((n_m,), _I)
    mat_tex = np.zeros((n_m,), _I)
    mat_albedo = np.zeros((n_m, 3), _F)
    mat_fuzz = np.zeros((n_m,), _F)
    mat_refract = np.ones((n_m,), _F)
    for i, m in enumerate(materials):
        mat_type[i] = m["type"]
        mat_tex[i] = m.get("tex", 0)
        mat_albedo[i] = m.get("albedo", (0, 0, 0))
        mat_fuzz[i] = m.get("fuzz", 0.0)
        mat_refract[i] = m.get("refract", 1.0)

    n_t = max(len(textures), 1)
    tex_type = np.zeros((n_t,), _I)
    tex_rgb = np.zeros((n_t, 3), _F)
    tex_inv_scale = np.zeros((n_t,), _F)
    tex_even = np.zeros((n_t,), _I)
    tex_odd = np.zeros((n_t,), _I)
    tex_img = np.zeros((n_t,), _I)
    for i, t in enumerate(textures):
        tex_type[i] = t["kind"]
        if t["kind"] == TEX_SOLID:
            tex_rgb[i] = t["rgb"]
        elif t["kind"] == TEX_CHECKER:
            tex_inv_scale[i] = t["inv_scale"]
            tex_even[i] = t["even"]
            tex_odd[i] = t["odd"]
        else:
            tex_img[i] = t["img"]

    from .ops.shade import SHADE_BLOCK, build_shade_rows, dedupe_material_ids

    def shade(prims):
        if not prims:
            return np.zeros((0, SHADE_BLOCK), _F)
        return np.array(
            [_shade_block(materials, textures, p["mat"]) for p in prims], _F
        ).reshape(len(prims), SHADE_BLOCK)

    shade_rows = build_shade_rows(
        {
            "cx": sph_center[:n_s, 0], "cy": sph_center[:n_s, 1],
            "cz": sph_center[:n_s, 2],
            "mx": sph_move[:n_s, 0], "my": sph_move[:n_s, 1],
            "mz": sph_move[:n_s, 2],
            "r": sph_radius[:n_s],
            "uv_cos": sph_uv_cos[:n_s], "uv_sin": sph_uv_sin[:n_s],
        },
        {
            "sx": quad_start[:n_q, 0], "sy": quad_start[:n_q, 1],
            "sz": quad_start[:n_q, 2],
            "nx": quad_normal[:n_q, 0], "ny": quad_normal[:n_q, 1],
            "nz": quad_normal[:n_q, 2],
            "wx": quad_w[:n_q, 0], "wy": quad_w[:n_q, 1],
            "wz": quad_w[:n_q, 2],
            "ux": quad_u[:n_q, 0], "uy": quad_u[:n_q, 1],
            "uz": quad_u[:n_q, 2],
            "vx": quad_v[:n_q, 0], "vy": quad_v[:n_q, 1],
            "vz": quad_v[:n_q, 2],
        },
        shade(spheres),
        shade(quads),
    )
    if shade_rows.shape[0] == 0:
        shade_rows = np.zeros((1, shade_rows.shape[1]), _F)
    dedupe_material_ids(shade_rows)

    light_params = []
    for kind, idx in lights:
        if kind == PRIM_SPHERE:
            light_params.append((
                PRIM_SPHERE,
                (float(sph_center[idx, 0]), float(sph_center[idx, 1]),
                 float(sph_center[idx, 2]), float(sph_radius[idx])),
            ))
        else:
            light_params.append((
                PRIM_QUAD,
                tuple(float(v) for v in (
                    *quad_start[idx], *quad_u[idx], *quad_v[idx],
                    *quad_normal[idx], *quad_w[idx],
                    quad_offset[idx], quad_area[idx],
                )),
            ))

    trees = _group_trees(
        sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v,
        quad_normal, quad_w, quad_offset, n_s, n_q, build_trees,
    )
    bg = np.asarray(background, _F)
    atlas_packed, atlas_wh = _atlas(images)
    tex_lut_tab, tex_lut_dims = None, ()
    if lut_budget > 0 and images:
        tex_lut_tab, tex_lut_dims = _build_tex_lut(images, lut_budget)
    fields = {
        **{k: v for k, v in trees.items() if k in TREE_FIELDS + UNI_FIELDS},
        "sph_center": sph_center.T, "sph_radius": sph_radius,
        "sph_move": sph_move.T, "sph_uv_cos": sph_uv_cos,
        "sph_uv_sin": sph_uv_sin, "sph_mat": sph_mat,
        "quad_start": quad_start.T, "quad_u": quad_u.T, "quad_v": quad_v.T,
        "quad_normal": quad_normal.T, "quad_w": quad_w.T,
        "quad_offset": quad_offset, "quad_area": quad_area,
        "quad_mat": quad_mat,
        "mat_type": mat_type, "mat_tex": mat_tex, "mat_albedo": mat_albedo.T,
        "mat_fuzz": mat_fuzz, "mat_refract": mat_refract,
        "tex_type": tex_type, "tex_rgb": tex_rgb.T,
        "tex_inv_scale": tex_inv_scale, "tex_even": tex_even,
        "tex_odd": tex_odd, "tex_img": tex_img,
        "background": bg, "shade_rows": shade_rows,
        "atlas_packed": atlas_packed, "atlas_wh": atlas_wh,
        "tex_lut_tab": tex_lut_tab,
    }
    static = {
        "n_spheres": n_s,
        "n_quads": n_q,
        "n_materials": len(materials),
        "n_textures": len(textures),
        "has_moving": any(np.any(s["move"] != 0) for s in spheres),
        "needs_gauss": any(
            m["type"] == MAT_ISOTROPIC
            or (m["type"] == MAT_METAL and float(m.get("fuzz", 0.0)) > 0.0)
            for m in materials
        ),
        "lights": lights,
        "light_params": tuple(light_params),
        "background_rgb": tuple(float(v) for v in background),
        "has_image_textures": any(
            t["kind"] == TEX_IMAGE
            or any(c["kind"] == TEX_IMAGE for c in _checker_children(textures, t))
            for t in textures
        ),
        "image_dims": tuple((int(w), int(h)) for w, h in atlas_wh),
        "has_emissive_image": any(
            m["type"] == MAT_DIFFUSE_LIGHT
            and textures
            and (
                textures[m.get("tex", 0)]["kind"] == TEX_IMAGE
                or any(c["kind"] != TEX_SOLID
                       for c in _checker_children(textures, textures[m.get("tex", 0)]))
            )
            for m in materials
        ),
        "tex_lut_dims": tex_lut_dims,
        "has_nested_checker": any(
            c["kind"] == TEX_CHECKER for t in textures for c in _checker_children(textures, t)
        ),
        **{k: trees[k] for k in TREE_STATIC_FIELDS + UNI_STATIC_FIELDS},
    }
    return compiled_from_arrays(fields, static, device)
