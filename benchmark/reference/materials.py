"""Material helpers for the masked integrator (counterpart of
``materials.py``): emission, the scattering PDF, the specular test and
Schlick Fresnel.  The integrator and the kernels inline emission and the
specular test; ``emitted`` and ``is_specular`` are the JAX package's public
names for them."""

from __future__ import annotations

import math

import torch

from .math import v3
from .math.v3 import V3
from .scene import MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_METAL
from .textures import texture_value

INV_4PI = 1.0 / (4.0 * math.pi)
INV_PI = 1.0 / math.pi


def emitted(scene, mat_type, mat_id, front, u, v, point: V3) -> V3:
    """Emission colour at each hit: the material's texture where it is a
    diffuse light and the hit is on the front face, black elsewhere."""
    tex = texture_value(scene, scene.mat_tex[mat_id.to(torch.int64)], u, v, point)
    emits = (mat_type == MAT_DIFFUSE_LIGHT) & front
    return V3.where(emits, tex, V3.zeros(emits.shape, emits.device))


def scattering_pdf(mat_type, normal: V3, scattered_dir: V3) -> torch.Tensor:
    """PDF of the material's own scatter distribution for an outgoing
    direction: lambertian max(0, cos/pi), isotropic 1/(4 pi)."""
    unit = v3.normalize(scattered_dir)
    cos_theta = v3.dot(normal, unit)
    lam = torch.clamp(cos_theta * INV_PI, min=0.0)
    return torch.where(mat_type == MAT_ISOTROPIC, INV_4PI, lam)


def is_specular(mat_type) -> torch.Tensor:
    """Metal and dielectric scatter without a PDF (no light sampling)."""
    return (mat_type == MAT_METAL) | (mat_type == MAT_DIELECTRIC)


def schlick_reflectance(cos_theta, refraction_index) -> torch.Tensor:
    """Schlick Fresnel approximation with the material's base index.
    ``x ** 5`` is spelled x * (x^2)^2, the order XLA's integer power uses."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    x = 1.0 - cos_theta
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))
