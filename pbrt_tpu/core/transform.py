"""Transforms: host-side 4x4 matrix algebra + device-side batched apply.

Replaces the reference's `Matrix4x4`/`Transform`/`AnimatedTransform`
(reference: core/transform.h, core/transform.cpp, core/quaternion.h).

Host side (scene build): `Transform` wraps a NumPy 4x4 with its inverse,
with the standard constructors (translate/scale/rotate/look_at/
perspective/orthographic). Device side: free functions `xform_point/
xform_vector/xform_normal/xform_ray` apply a [..., 4, 4] matrix to
batched [..., 3] arrays inside jit.

AnimatedTransform decomposes into T / R(quaternion) / S and slerps
(reference core/transform.h:299, core/quaternion.h:96); interpolation
is a jit-friendly pure function of time.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Device-side batched application (works on np or jnp)

# NOTE: these applies are written as explicit component mul/adds, NOT
# einsum/matmul: a dim-3 contraction gains nothing from a matrix unit,
# and componentwise math stays in full f32 whatever precision the
# backend would pick for a contraction (reduced-precision operands
# quantize coordinates enough to push shadow-ray origins through
# surfaces).

def _apply33(m, v, xp):
    """[..., 3, 3] x [..., 3] -> [..., 3] componentwise."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return xp.stack(
        [m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
         m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
         m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z],
        axis=-1)


def xform_point(m, p):
    """Apply [..., 4, 4] matrix to point(s) [..., 3] (w-divide)."""
    xp = jnp if isinstance(p, jnp.ndarray) or isinstance(m, jnp.ndarray) else np
    r = _apply33(m, p, xp) + m[..., :3, 3]
    w = (m[..., 3, 0] * p[..., 0] + m[..., 3, 1] * p[..., 1]
         + m[..., 3, 2] * p[..., 2] + m[..., 3, 3])
    return r / w[..., None]


def xform_point_affine(m, p):
    """Apply assuming bottom row is [0,0,0,1] (no w-divide) — the common case."""
    xp = jnp if isinstance(p, jnp.ndarray) or isinstance(m, jnp.ndarray) else np
    return _apply33(m, p, xp) + m[..., :3, 3]


def xform_vector(m, v):
    xp = jnp if isinstance(v, jnp.ndarray) or isinstance(m, jnp.ndarray) else np
    return _apply33(m, v, xp)


def xform_normal(m_inv, n):
    """Normals transform by the inverse transpose (pass the INVERSE matrix)."""
    xp = jnp if isinstance(n, jnp.ndarray) or isinstance(m_inv, jnp.ndarray) else np
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    m = m_inv
    return xp.stack(
        [m[..., 0, 0] * x + m[..., 1, 0] * y + m[..., 2, 0] * z,
         m[..., 0, 1] * x + m[..., 1, 1] * y + m[..., 2, 1] * z,
         m[..., 0, 2] * x + m[..., 1, 2] * y + m[..., 2, 2] * z],
        axis=-1)


# ---------------------------------------------------------------------------
# Host-side Transform

class Transform:
    """Affine/projective transform with cached inverse (NumPy, host only)."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float64)
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m)
        self.m = m
        self.m_inv = np.asarray(m_inv, dtype=np.float64).reshape(4, 4)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __call__(self, p):
        return xform_point(self.m, np.asarray(p, np.float64))

    def vector(self, v):
        return xform_vector(self.m, np.asarray(v, np.float64))

    def normal(self, n):
        return xform_normal(self.m_inv, np.asarray(n, np.float64))

    def is_identity(self) -> bool:
        return np.allclose(self.m, np.eye(4))

    def swaps_handedness(self) -> bool:
        return float(np.linalg.det(self.m[:3, :3])) < 0.0

    def has_scale(self) -> bool:
        for i in range(3):
            la2 = float(np.sum(self.m[:3, i] ** 2))
            if la2 < 0.999 or la2 > 1.001:
                return True
        return False

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def __hash__(self):
        return hash(self.m.tobytes())

    # -- constructors (reference core/transform.cpp) --

    @staticmethod
    def translate(delta) -> "Transform":
        d = np.asarray(delta, np.float64)
        m = np.eye(4)
        m[:3, 3] = d
        mi = np.eye(4)
        mi[:3, 3] = -d
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z) -> "Transform":
        m = np.diag([x, y, z, 1.0]).astype(np.float64)
        mi = np.diag([1.0 / x, 1.0 / y, 1.0 / z, 1.0])
        return Transform(m, mi)

    @staticmethod
    def rotate_x(deg) -> "Transform":
        return Transform.rotate(deg, [1.0, 0.0, 0.0])

    @staticmethod
    def rotate_y(deg) -> "Transform":
        return Transform.rotate(deg, [0.0, 1.0, 0.0])

    @staticmethod
    def rotate_z(deg) -> "Transform":
        return Transform.rotate(deg, [0.0, 0.0, 1.0])

    @staticmethod
    def rotate(deg, axis) -> "Transform":
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        s = np.sin(np.deg2rad(deg))
        c = np.cos(np.deg2rad(deg))
        m = np.eye(4)
        m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
        m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
        m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
        m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
        m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
        m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
        m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
        m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
        m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
        return Transform(m, m.T)

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """camera-to-world (reference core/transform.cpp LookAt)."""
        eye = np.asarray(eye, np.float64)
        look = np.asarray(look, np.float64)
        up = np.asarray(up, np.float64)
        dir_ = look - eye
        dir_ = dir_ / np.linalg.norm(dir_)
        left = np.cross(up / np.linalg.norm(up), dir_)
        nl = np.linalg.norm(left)
        if nl < 1e-12:
            # up parallel to viewing direction: pick any perpendicular
            tmp = np.array([0.0, 0.0, 1.0]) if abs(dir_[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
            left = np.cross(tmp, dir_)
            nl = np.linalg.norm(left)
        left = left / nl
        new_up = np.cross(dir_, left)
        c2w = np.eye(4)
        c2w[:3, 0] = left
        c2w[:3, 1] = new_up
        c2w[:3, 2] = dir_
        c2w[:3, 3] = eye
        return Transform(c2w)

    @staticmethod
    def orthographic(znear, zfar) -> "Transform":
        return Transform.scale(1.0, 1.0, 1.0 / (zfar - znear)) * Transform.translate(
            [0.0, 0.0, -znear]
        )

    @staticmethod
    def perspective(fov_deg, znear, zfar) -> "Transform":
        persp = np.array(
            [
                [1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
                [0, 0, 1, 0],
            ],
            dtype=np.float64,
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)


IDENTITY = Transform()


# ---------------------------------------------------------------------------
# Quaternions (host + device; arrays are [..., 4] as (x, y, z, w))

def quat_from_matrix(m) -> np.ndarray:
    """Rotation matrix (3x3 or 4x4 upper-left) -> quaternion [x,y,z,w]."""
    m = np.asarray(m, np.float64)
    m = m[:3, :3]
    tr = np.trace(m)
    q = np.zeros(4)
    if tr > 0.0:
        s = np.sqrt(tr + 1.0)
        q[3] = s / 2.0
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - (m[j, j] + m[k, k]) + 1.0, 0.0))
        qv = np.zeros(3)
        qv[i] = s * 0.5
        if s != 0.0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        qv[j] = (m[j, i] + m[i, j]) * s
        qv[k] = (m[k, i] + m[i, k]) * s
        q[:3] = qv
    return q


def quat_to_matrix(q):
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3] (jit-friendly)."""
    xp = jnp if isinstance(q, jnp.ndarray) else np
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = xp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w),
            2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w),
            2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(q.shape[:-1] + (3, 3))
    # NOTE: reference stores column-major style; this produces M such that
    # rotating v is M.T @ v per the pbrt convention. We transpose to match
    # the usual row-vector convention used elsewhere here.
    return xp.swapaxes(m, -1, -2)


def slerp(t, q1, q2):
    """Spherical lerp, jit-friendly (reference core/quaternion.cpp Slerp)."""
    xp = jnp if isinstance(q1, jnp.ndarray) or isinstance(t, jnp.ndarray) else np
    cos_theta = xp.sum(q1 * q2, axis=-1)
    q2 = xp.where((cos_theta < 0.0)[..., None], -q2, q2)
    cos_theta = xp.abs(cos_theta)
    theta = xp.arccos(xp.clip(cos_theta, -1.0, 1.0))
    sin_theta = xp.sin(theta)
    near = cos_theta > 0.9995
    w1 = xp.where(near, 1.0 - t, xp.sin((1.0 - t) * theta) / xp.where(near, 1.0, sin_theta))
    w2 = xp.where(near, t, xp.sin(t * theta) / xp.where(near, 1.0, sin_theta))
    q = w1[..., None] * q1 + w2[..., None] * q2
    return q / xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))


def decompose(m):
    """Decompose affine 4x4 into (T [3], R quat [4], S [3,3]).

    Polar decomposition by iterative averaging with inverse transpose
    (reference core/transform.cpp AnimatedTransform::Decompose).
    """
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        Rit = np.linalg.inv(R.T)
        Rnext = 0.5 * (R + Rit)
        if np.max(np.abs(Rnext - R)) < 1e-10:
            R = Rnext
            break
        R = Rnext
    S = np.linalg.inv(R) @ M
    return T, quat_from_matrix(R), S


class AnimatedTransform:
    """Two-keyframe animated transform; `interpolate(time)` is jit-friendly
    and returns a [..., 4, 4] matrix (reference core/transform.h:299)."""

    def __init__(self, t0: Transform, time0: float, t1: Transform, time1: float):
        self.start, self.end = t0, t1
        self.time0, self.time1 = float(time0), float(time1)
        self.actually_animated = not np.allclose(t0.m, t1.m)
        self.T0, self.R0, self.S0 = decompose(t0.m)
        self.T1, self.R1, self.S1 = decompose(t1.m)

    def interpolate(self, time):
        """time: scalar or [...] -> matrices [..., 4, 4] (jnp)."""
        if not self.actually_animated:
            return jnp.broadcast_to(
                jnp.asarray(self.start.m, jnp.float32),
                jnp.shape(time) + (4, 4),
            )
        dt = jnp.clip(
            (jnp.asarray(time, jnp.float32) - self.time0) / (self.time1 - self.time0),
            0.0,
            1.0,
        )
        T = (1.0 - dt)[..., None] * jnp.asarray(self.T0) + dt[..., None] * jnp.asarray(self.T1)
        R = slerp(dt, jnp.asarray(self.R0), jnp.asarray(self.R1))
        S = (1.0 - dt)[..., None, None] * jnp.asarray(self.S0) + dt[..., None, None] * jnp.asarray(self.S1)
        rot = quat_to_matrix(R)
        m = jnp.zeros(jnp.shape(dt) + (4, 4), jnp.float32)
        m = m.at[..., :3, :3].set((rot @ S).astype(jnp.float32))
        m = m.at[..., :3, 3].set(T.astype(jnp.float32))
        m = m.at[..., 3, 3].set(1.0)
        return m

    def motion_bounds(self, lo, hi, nsteps: int = 16):
        """Conservative bbox of a bbox over the time interval (host)."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        corners = np.array(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
             [lo[0], lo[1], hi[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], hi[2]],
             [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]]
        )
        out_lo = np.full(3, np.inf)
        out_hi = np.full(3, -np.inf)
        for i in range(nsteps):
            t = self.time0 + (self.time1 - self.time0) * i / max(nsteps - 1, 1)
            m = np.asarray(self.interpolate(jnp.float32(t)))
            pts = xform_point_affine(m, corners)
            out_lo = np.minimum(out_lo, pts.min(axis=0))
            out_hi = np.maximum(out_hi, pts.max(axis=0))
        return out_lo, out_hi
