"""SoA 3-vectors over torch tensors (counterpart of ``math/v3.py``).

``V3`` holds x/y/z as three ``(N,)`` tensors (or Python floats for scene
constants), so every vector op is three elementwise tensor ops in the same
order as the JAX package's, which keeps the float results comparable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dtypes import real


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic (elementwise; scalars and (N,) tensors broadcast) --------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __getitem__(self, i):
        return V3(self.x[i], self.y[i], self.z[i])

    @property
    def shape(self):
        return self.x.shape

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z))

    @staticmethod
    def full(shape, vx, vy, vz, device) -> "V3":
        return V3(
            torch.full(shape, vx, dtype=real, device=device),
            torch.full(shape, vy, dtype=real, device=device),
            torch.full(shape, vz, dtype=real, device=device),
        )

    @staticmethod
    def zeros(shape, device) -> "V3":
        z = torch.zeros(shape, dtype=real, device=device)
        return V3(z, z, z)

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """(..., 3) -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        """V3 -> (..., 3)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(a: V3) -> torch.Tensor:
    return dot(a, a)


def length(a: V3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    return a * torch.rsqrt(dot(a, a))


def reflect(v: V3, n: V3) -> V3:
    """v - 2 (v.n) n."""
    return v - n * (2.0 * dot(v, n))


def refract(vn: V3, n: V3, index) -> V3:
    """Snell refraction of a unit direction."""
    cos_theta = torch.clamp(dot(-vn, n), max=1.0)
    r_out_perp = (vn + n * cos_theta) * index
    r_out_parallel = n * (-torch.sqrt(torch.abs(1.0 - dot(r_out_perp, r_out_perp))))
    return r_out_perp + r_out_parallel


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


class OrthoBasisV(NamedTuple):
    u: V3
    v: V3
    w: V3


def ortho_basis(n: V3) -> OrthoBasisV:
    """ONB with w = normalize(n); helper axis x when |w.y| > 0.9, else y."""
    w = normalize(n)
    cond = torch.abs(w.y) > 0.9
    one = torch.ones_like(w.x)
    zero = torch.zeros_like(w.x)
    a = V3(torch.where(cond, one, zero), torch.where(cond, zero, one), zero)
    u = normalize(cross(w, a))
    v = cross(w, u)
    return OrthoBasisV(u=u, v=v, w=w)


def onb_transform(b: OrthoBasisV, local: V3) -> V3:
    return b.u * local.x + b.v * local.y + b.w * local.z
