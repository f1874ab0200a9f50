"""Vector/ray/bbox math on batched `[..., 3]` arrays.

Batched replacement for the reference's scalar `Point/Vector/Normal/
Ray/BBox` classes (reference: core/geometry.h). Everything here is a pure
function over jnp arrays whose last axis is xyz, so a "Vector" is any
array shaped [..., 3] and all ops broadcast over leading (wavefront)
axes. Rays are a NamedTuple pytree (struct-of-arrays) so a batch of N
rays is one Ray whose fields have a leading N axis.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

INF = jnp.float32(jnp.inf)
EPS = 1e-4  # default ray epsilon (reference uses per-hit rayEpsilon)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length_sq(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_sq(v))


def normalize(v, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)


def distance(a, b):
    return length(a - b)


def distance_sq(a, b):
    return length_sq(a - b)


def faceforward(n, v):
    """Flip n to lie in the hemisphere of v (reference core/geometry.h)."""
    return jnp.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v1):
    """Build an orthonormal frame around unit v1.

    Branch-free variant of reference core/geometry.h CoordinateSystem.
    Returns (v2, v3) with v1 x v2 = v3 ... (right-handed v1,v2,v3).
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    # floor keeps zero-vector lanes (misses) at 0*finite instead of
    # 0*inf=NaN — a NaN primal here poisons every backward pass even
    # though forward masking hides it (autodiff 0*NaN=NaN)
    inv_a = 1.0 / jnp.sqrt(
        jnp.maximum(jnp.where(use_x, x * x + z * z, y * y + z * z), 1e-24))
    v2 = jnp.where(
        use_x[..., None],
        jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1),
        jnp.stack([jnp.zeros_like(x), z * inv_a, -y * inv_a], axis=-1),
    )
    v3 = cross(v1, v2)
    return v2, v3


def spherical_direction(sintheta, costheta, phi):
    return jnp.stack(
        [sintheta * jnp.cos(phi), sintheta * jnp.sin(phi), costheta], axis=-1
    )


def spherical_direction_frame(sintheta, costheta, phi, x, y, z):
    return (
        (sintheta * jnp.cos(phi))[..., None] * x
        + (sintheta * jnp.sin(phi))[..., None] * y
        + costheta[..., None] * z
    )


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


class Ray(NamedTuple):
    """A wavefront of rays: all fields broadcast over a leading batch axis.

    o: [N, 3] origin, d: [N, 3] direction (not necessarily unit),
    tmin/tmax: [N] parametric range, time: [N], depth: [N] int32.
    """

    o: jnp.ndarray
    d: jnp.ndarray
    tmin: jnp.ndarray
    tmax: jnp.ndarray
    time: jnp.ndarray

    def at(self, t):
        return self.o + t[..., None] * self.d

    @staticmethod
    def make(o, d, tmin=None, tmax=None, time=None):
        batch = jnp.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        o = jnp.broadcast_to(o, batch + (3,)).astype(jnp.float32)
        d = jnp.broadcast_to(d, batch + (3,)).astype(jnp.float32)
        if tmin is None:
            tmin = jnp.zeros(batch, jnp.float32)
        else:
            tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), batch)
        if tmax is None:
            tmax = jnp.full(batch, INF, jnp.float32)
        else:
            tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), batch)
        if time is None:
            time = jnp.zeros(batch, jnp.float32)
        else:
            time = jnp.broadcast_to(jnp.asarray(time, jnp.float32), batch)
        return Ray(o, d, tmin, tmax, time)


class RayDifferential(NamedTuple):
    """Ray plus screen-space differentials (reference core/geometry.h:176)."""

    ray: Ray
    rx_o: jnp.ndarray
    rx_d: jnp.ndarray
    ry_o: jnp.ndarray
    ry_d: jnp.ndarray
    has_differentials: jnp.ndarray  # [N] bool

    def scale(self, s):
        o, d = self.ray.o, self.ray.d
        return self._replace(
            rx_o=o + (self.rx_o - o) * s,
            rx_d=d + (self.rx_d - d) * s,
            ry_o=o + (self.ry_o - o) * s,
            ry_d=d + (self.ry_d - d) * s,
        )


class BBox(NamedTuple):
    """Axis-aligned box; lo/hi are [..., 3]."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    @staticmethod
    def empty(shape=()):
        return BBox(jnp.full(shape + (3,), INF), jnp.full(shape + (3,), -INF))

    def union_point(self, p):
        return BBox(jnp.minimum(self.lo, p), jnp.maximum(self.hi, p))

    def union(self, other):
        return BBox(jnp.minimum(self.lo, other.lo), jnp.maximum(self.hi, other.hi))

    def diagonal(self):
        return self.hi - self.lo

    def surface_area(self):
        d = jnp.maximum(self.diagonal(), 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])

    def centroid(self):
        return 0.5 * (self.lo + self.hi)

    def bounding_sphere(self):
        c = self.centroid()
        rad = jnp.where(
            jnp.all(self.hi >= self.lo, axis=-1), distance(c, self.hi), 0.0
        )
        return c, rad

    def inside(self, p):
        return jnp.all((p >= self.lo) & (p <= self.hi), axis=-1)

    def expand(self, delta):
        return BBox(self.lo - delta, self.hi + delta)

    def intersect_p(self, ray: Ray):
        """Slab test. Returns (hit, t0, t1) broadcast over ray batch."""
        inv_d = 1.0 / ray.d  # inf on zero components is fine for slab test
        t_lo = (self.lo - ray.o) * inv_d
        t_hi = (self.hi - ray.o) * inv_d
        t_near = jnp.minimum(t_lo, t_hi)
        t_far = jnp.maximum(t_lo, t_hi)
        t0 = jnp.maximum(jnp.max(t_near, axis=-1), ray.tmin)
        t1 = jnp.minimum(jnp.min(t_far, axis=-1), ray.tmax)
        return t0 <= t1, t0, t1
