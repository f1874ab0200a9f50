"""Wavefront ray-scene intersection over struct-of-arrays geometry.

Replaces the reference's virtual Shape::Intersect dispatch and
accelerator traversal (reference core/primitive.h, accelerators/bvh.cpp
:585-687) with a two-phase vectorized design:

  phase 1 (t-pass): a `lax.scan` over fixed-size primitive blocks
  computes candidate hit distances for a whole ray batch at once
  ([R, BLOCK] masked math on the VPU) keeping a running (t, prim) min.
  With a BVH (pbrt_tpu.accel.bvh) the scan runs over per-ray node
  shortlists instead of all blocks.

  phase 2 (reconstruct): gather the winning primitive's data per ray and
  recompute the differential geometry (p, ng, ns, uv, dpdu) once.

Triangles use Moller-Trumbore over precomputed (v0, e1, e2); quadrics
(sphere/cylinder/disk/cone/paraboloid/hyperboloid) are solved
analytically in object space with pbrt's partial ranges (zmin/zmax/
phimax, disk innerradius), both roots checked (reference
shapes/sphere.cpp:219 et al.).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core.geometry import Ray, cross, dot, normalize
from pbrt_tpu.core.transform import xform_point_affine, xform_vector, xform_normal
from pbrt_tpu.shapes.registry import (
    QUAD_CONE,
    QUAD_CYLINDER,
    QUAD_DISK,
    QUAD_HYPERBOLOID,
    QUAD_PARABOLOID,
    QUAD_SPHERE,
)

BIG = 1e30


class SceneGeom(NamedTuple):
    """Device geometry tensors. Triangles occupy global prim ids [0, T);
    quadric q has global id T + q."""

    tri_v0: jnp.ndarray      # [T, 3]
    tri_e1: jnp.ndarray      # [T, 3]
    tri_e2: jnp.ndarray      # [T, 3]
    tri_n: jnp.ndarray       # [T, 3, 3] shading normals per vertex
    tri_has_n: jnp.ndarray   # [T] bool
    tri_uv: jnp.ndarray      # [T, 3, 2]
    tri_mat: jnp.ndarray     # [T] int32
    tri_light: jnp.ndarray   # [T] int32 (-1 = not emissive)
    quad_type: jnp.ndarray   # [Q] int32
    quad_o2w: jnp.ndarray    # [Q, 4, 4]
    quad_w2o: jnp.ndarray    # [Q, 4, 4]
    quad_params: jnp.ndarray  # [Q, 8]
    quad_mat: jnp.ndarray    # [Q]
    quad_light: jnp.ndarray  # [Q]
    quad_flip: jnp.ndarray   # [Q] bool: flip normals (reverseorientation ^ swap)
    world_lo: jnp.ndarray    # [3]
    world_hi: jnp.ndarray    # [3]
    # motion blur (two-keyframe linear motion, reference
    # core/primitive.h:115-117 TransformedPrimitive + AnimatedTransform):
    # vertex deltas so v(t) = v + t * dv (t in [0,1] shutter-normalized)
    tri_dv0: jnp.ndarray = None   # [T, 3]
    tri_de1: jnp.ndarray = None   # [T, 3]
    tri_de2: jnp.ndarray = None   # [T, 3]
    # alpha masking: per-tri row into CompiledScene.alpha_textures
    # (-1 = opaque); None when the scene has no alpha textures
    tri_alpha: jnp.ndarray = None  # [T] int32
    quad_o2w_end: jnp.ndarray = None  # [Q, 4, 4] end-of-shutter transform
    quad_w2o_end: jnp.ndarray = None  # [Q, 4, 4] its inverse (host-computed)
    time0: float = 0.0            # shutter open  (transform keyframe times)
    time1: float = 1.0            # shutter close
    # Packed per-primitive reconstruct rows: ONE row gather per hit
    # instead of ~15 small-minor-dim gathers. Layouts documented in
    # _reconstruct_packed. Built by compile_scene; None in hand-rolled
    # test geometries (reconstruct falls back to per-field gathers).
    tri_pack: jnp.ndarray = None   # [T, 27 (+9 motion)] f32
    quad_pack: jnp.ndarray = None  # [Q, 34 (+24 motion)] f32

    @property
    def has_motion(self):
        return self.tri_dv0 is not None or self.quad_o2w_end is not None

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_quads(self):
        return self.quad_type.shape[0]

    def norm_time(self, time):
        """Ray time -> [0,1] keyframe interpolant."""
        span = max(self.time1 - self.time0, 1e-9)
        return jnp.clip((time - self.time0) / span, 0.0, 1.0)

    def tri_at(self, idx, time):
        """Triangle (v0, e1, e2) at ray time; idx/time broadcastable."""
        v0 = self.tri_v0[idx]
        e1 = self.tri_e1[idx]
        e2 = self.tri_e2[idx]
        if self.tri_dv0 is None:
            return v0, e1, e2
        dt = self.norm_time(time)[..., None]
        return (v0 + dt * self.tri_dv0[idx],
                e1 + dt * self.tri_de1[idx],
                e2 + dt * self.tri_de2[idx])

    def quad_xforms_at(self, idx, time):
        """(o2w, w2o) for quadrics at ray time: matrix-lerp of both
        keyframe transforms (host-precomputed inverses). Endpoints are
        exact; in between, linear — same first-order approximation as the
        triangle vertex motion, and friendly to XLA fusion
        (pure broadcast lerp, no per-ray matrix inversion)."""
        o2w = self.quad_o2w[idx]
        if self.quad_o2w_end is None:
            return o2w, self.quad_w2o[idx]
        dt = self.norm_time(time)[..., None, None]
        o2w_t = (1.0 - dt) * o2w + dt * self.quad_o2w_end[idx]
        w2o_t = (1.0 - dt) * self.quad_w2o[idx] + dt * self.quad_w2o_end[idx]
        return o2w_t, w2o_t


class Hit(NamedTuple):
    valid: jnp.ndarray   # [R] bool
    t: jnp.ndarray       # [R]
    p: jnp.ndarray       # [R, 3]
    ng: jnp.ndarray      # [R, 3] geometric normal (winding-oriented)
    ns: jnp.ndarray      # [R, 3] shading normal
    uv: jnp.ndarray      # [R, 2]
    dpdu: jnp.ndarray    # [R, 3]
    mat: jnp.ndarray     # [R] int32 (-1 none)
    light: jnp.ndarray   # [R] int32 (-1 none)
    prim: jnp.ndarray    # [R] int32 global prim id (-1 none)


# ---------------------------------------------------------------------------
# Triangle candidate t

def _tri_t(v0, e1, e2, o, d, tmin, tmax):
    """Moller-Trumbore candidate distances. v0/e1/e2: [..., 3] broadcast
    against rays o/d [..., 3]. Returns (t, valid)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - v0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (jnp.abs(det) > 1e-12)
        & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
        & (t > tmin) & (t < tmax)
    )
    return t, valid


# ---------------------------------------------------------------------------
# Quadric candidate t (object space, both roots, range-clipped)

def _quad_candidates(qtype, params, o, d, tmin, tmax, present=None):
    """All-types quadric intersection. Shapes broadcast: qtype [...],
    params [..., 8], o/d [..., 3] (already object space). Returns (t, valid).

    present: optional static set of quadric type ids in the scene —
    branches for absent types are elided at trace time (the scene's
    type table is concrete, so this is free specialization)."""
    r = params[..., 0]
    zmin = params[..., 1]
    zmax = params[..., 2]
    phimax = params[..., 3]
    p4 = params[..., 4]
    p5 = params[..., 5]

    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def has(t):
        return present is None or t in present

    zero = jnp.zeros_like(ox)
    false = jnp.zeros(ox.shape, bool)
    is_sph = (qtype == QUAD_SPHERE) if has(QUAD_SPHERE) else false
    is_cyl = (qtype == QUAD_CYLINDER) if has(QUAD_CYLINDER) else false
    is_disk = (qtype == QUAD_DISK) if has(QUAD_DISK) else false
    is_cone = (qtype == QUAD_CONE) if has(QUAD_CONE) else false
    is_par = (qtype == QUAD_PARABOLOID) if has(QUAD_PARABOLOID) else false
    is_hyp = (qtype == QUAD_HYPERBOLOID) if has(QUAD_HYPERBOLOID) else false

    def term(mask_static, val):
        return val if mask_static else zero

    # quadratic coefficients per type
    k_cone = (r / jnp.maximum(p4, 1e-12)) ** 2  # p4 = height
    k_par = p4 / jnp.maximum(r * r, 1e-12)      # p4 = zmax
    a_h, c_h = p4, p5

    A = (
        term(has(QUAD_SPHERE), jnp.where(is_sph, dx * dx + dy * dy + dz * dz, 0.0))
        + term(has(QUAD_CYLINDER), jnp.where(is_cyl, dx * dx + dy * dy, 0.0))
        + term(has(QUAD_CONE), jnp.where(is_cone, dx * dx + dy * dy - k_cone * dz * dz, 0.0))
        + term(has(QUAD_PARABOLOID), jnp.where(is_par, k_par * (dx * dx + dy * dy), 0.0))
        + term(has(QUAD_HYPERBOLOID), jnp.where(is_hyp, a_h * (dx * dx + dy * dy) - c_h * dz * dz, 0.0))
    )
    B = (
        term(has(QUAD_SPHERE), jnp.where(is_sph, 2.0 * (ox * dx + oy * dy + oz * dz), 0.0))
        + term(has(QUAD_CYLINDER), jnp.where(is_cyl, 2.0 * (ox * dx + oy * dy), 0.0))
        + term(has(QUAD_CONE), jnp.where(is_cone, 2.0 * (ox * dx + oy * dy - k_cone * dz * (oz - p4)), 0.0))
        + term(has(QUAD_PARABOLOID), jnp.where(is_par, 2.0 * k_par * (ox * dx + oy * dy) - dz, 0.0))
        + term(has(QUAD_HYPERBOLOID), jnp.where(is_hyp, 2.0 * (a_h * (ox * dx + oy * dy) - c_h * oz * dz), 0.0))
    )
    C = (
        term(has(QUAD_SPHERE), jnp.where(is_sph, ox * ox + oy * oy + oz * oz - r * r, 0.0))
        + term(has(QUAD_CYLINDER), jnp.where(is_cyl, ox * ox + oy * oy - r * r, 0.0))
        + term(has(QUAD_CONE), jnp.where(is_cone, ox * ox + oy * oy - k_cone * (oz - p4) * (oz - p4), 0.0))
        + term(has(QUAD_PARABOLOID), jnp.where(is_par, k_par * (ox * ox + oy * oy) - oz, 0.0))
        + term(has(QUAD_HYPERBOLOID), jnp.where(is_hyp, a_h * (ox * ox + oy * oy) - c_h * oz * oz - 1.0, 0.0))
    )

    disc = B * B - 4.0 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # numerically-stable quadratic roots (sign(0) must be +1, not 0: a ray
    # from the quadric's center has B == 0)
    sgn_b = jnp.where(B >= 0.0, 1.0, -1.0)
    qq = -0.5 * (B + sgn_b * sq)
    safe_a = jnp.where(jnp.abs(A) > 1e-12, A, 1.0)
    safe_q = jnp.where(jnp.abs(qq) > 1e-12, qq, 1.0)
    t0r = qq / safe_a
    t1r = C / safe_q
    lin_ok = jnp.abs(A) <= 1e-12
    # linear case (paraboloid with dz dominant etc.): Bt + C = 0
    t_lin = -C / jnp.where(jnp.abs(B) > 1e-12, B, 1.0)
    t0 = jnp.where(lin_ok, t_lin, jnp.minimum(t0r, t1r))
    t1 = jnp.where(lin_ok, t_lin, jnp.maximum(t0r, t1r))
    quad_ok = jnp.where(lin_ok, jnp.abs(B) > 1e-12, disc >= 0.0)

    # disk: plane intersection
    t_disk = (zmin - oz) / jnp.where(jnp.abs(dz) > 1e-12, dz, 1.0)  # zmin slot=height
    disk_ok = jnp.abs(dz) > 1e-12

    def clip(t):
        ph = o + t[..., None] * d
        x, yv, z = ph[..., 0], ph[..., 1], ph[..., 2]
        phi = jnp.arctan2(yv, x)
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        in_phi = phi <= phimax + 1e-7
        in_z = (z >= zmin) & (z <= zmax)
        dist2 = x * x + yv * yv
        in_disk = (dist2 <= r * r) & (dist2 >= p4 * p4)  # p4 = innerradius
        ok = jnp.where(
            is_disk,
            in_disk & in_phi,
            in_z & in_phi,
        )
        # sphere uses z range too (partial spheres)
        return ok & (t > tmin) & (t < tmax)

    tq = jnp.where(is_disk, t_disk, t0)
    ok0 = jnp.where(is_disk, disk_ok, quad_ok) & clip(tq)
    tq2 = jnp.where(is_disk, jnp.full_like(t1, BIG), t1)
    ok1 = jnp.where(is_disk, jnp.zeros_like(quad_ok), quad_ok) & clip(tq2)
    t = jnp.where(ok0, tq, jnp.where(ok1, tq2, BIG))
    valid = ok0 | ok1
    return t, valid


def _quad_detail(qtype, params, flip, o2w, w2o, ray_o, ray_d, t):
    """Differential geometry at object-space hit of a single quadric per
    ray. All inputs gathered per ray."""
    o = xform_point_affine(w2o, ray_o)
    d = xform_vector(w2o, ray_d)
    ph = o + t[..., None] * d
    x, yv, z = ph[..., 0], ph[..., 1], ph[..., 2]
    r = params[..., 0]
    zmin, zmax = params[..., 1], params[..., 2]
    phimax = params[..., 3]
    p4, p5 = params[..., 4], params[..., 5]
    phi = jnp.arctan2(yv, x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)

    is_sph = qtype == QUAD_SPHERE
    is_cyl = qtype == QUAD_CYLINDER
    is_disk = qtype == QUAD_DISK
    is_cone = qtype == QUAD_CONE
    is_par = qtype == QUAD_PARABOLOID
    is_hyp = qtype == QUAD_HYPERBOLOID

    u = phi / jnp.maximum(phimax, 1e-9)
    # v per type
    theta = jnp.arccos(jnp.clip(z / jnp.maximum(r, 1e-12), -1.0, 1.0))
    thmin = jnp.arccos(jnp.clip(zmax / jnp.maximum(r, 1e-12), -1.0, 1.0))
    thmax = jnp.arccos(jnp.clip(zmin / jnp.maximum(r, 1e-12), -1.0, 1.0))
    v_sph = (theta - thmin) / jnp.maximum(thmax - thmin, 1e-9)
    v_lin = (z - zmin) / jnp.maximum(zmax - zmin, 1e-9)
    dist = jnp.sqrt(jnp.maximum(x * x + yv * yv, 1e-20))
    v_disk = 1.0 - (dist - p4) / jnp.maximum(r - p4, 1e-9)
    v = jnp.where(is_sph, v_sph, jnp.where(is_disk, v_disk, v_lin))

    # dpdu common: rotation around z
    dpdu = jnp.stack([-phimax * yv, phimax * x, jnp.zeros_like(x)], axis=-1)
    # normals via implicit gradient per type
    n_sph = ph
    n_cyl = jnp.stack([x, yv, jnp.zeros_like(z)], axis=-1)
    n_disk = jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x), jnp.ones_like(x)], axis=-1)
    k_cone = (r / jnp.maximum(p4, 1e-12)) ** 2
    n_cone = jnp.stack([x, yv, -k_cone * (z - p4)], axis=-1)
    k_par = p4 / jnp.maximum(r * r, 1e-12)
    n_par = jnp.stack([2.0 * k_par * x, 2.0 * k_par * yv, -jnp.ones_like(z)], axis=-1)
    n_hyp = jnp.stack([2.0 * p4 * x, 2.0 * p4 * yv, -2.0 * p5 * z], axis=-1)
    n_obj = jnp.where(
        is_sph[..., None], n_sph,
        jnp.where(is_cyl[..., None], n_cyl,
                  jnp.where(is_disk[..., None], n_disk,
                            jnp.where(is_cone[..., None], n_cone,
                                      jnp.where(is_par[..., None], n_par, n_hyp)))),
    )
    p_world = xform_point_affine(o2w, ph)
    n_world = normalize(xform_normal(w2o, n_obj))
    n_world = jnp.where(flip[..., None], -n_world, n_world)
    dpdu_w = xform_vector(o2w, dpdu)
    uv = jnp.stack([u, v], axis=-1)
    return p_world, n_world, uv, dpdu_w


# ---------------------------------------------------------------------------
# Brute-force t-pass (block scan). BVH variant lives in accel/bvh.py.

def _round_up(n, m):
    return (n + m - 1) // m * m


def _quad_t_pass(geom: SceneGeom, ray: Ray, t_best, prim_best):
    """Fold the (few) quadrics into an existing (t, prim) accumulator.
    prim ids for quadric q are geom.n_tris + q."""
    T = geom.n_tris
    t_best = jnp.where(prim_best >= 0, t_best,
                       jnp.where(jnp.isfinite(ray.tmax), ray.tmax, BIG))
    if geom.quad_o2w_end is not None:
        all_q = jnp.arange(geom.n_quads)
        _, w2o = geom.quad_xforms_at(all_q[None, :], ray.time[:, None])
    else:
        w2o = geom.quad_w2o[None]
    o_obj = xform_point_affine(w2o, ray.o[:, None])
    d_obj = xform_vector(w2o, ray.d[:, None])
    present = set(int(x) for x in np.asarray(geom.quad_type))
    t, valid = _quad_candidates(
        geom.quad_type[None], geom.quad_params[None], o_obj, d_obj,
        ray.tmin[:, None], t_best[:, None], present=present,
    )
    t = jnp.where(valid, t, BIG)
    idx = jnp.argmin(t, axis=-1)
    tmin_q = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    better = tmin_q < t_best
    t_out = jnp.where(better, tmin_q, t_best)
    prim_out = jnp.where(better, T + idx.astype(jnp.int32), prim_best)
    return jnp.where(prim_out >= 0, t_out, BIG), prim_out


def t_pass_brute(geom: SceneGeom, ray: Ray, block: int = 512):
    """[R] rays vs all prims. Returns (t [R], prim [R] int32)."""
    R = ray.o.shape[0]
    T, Q = geom.n_tris, geom.n_quads
    t_best = jnp.where(jnp.isfinite(ray.tmax), ray.tmax, BIG)
    prim_best = jnp.full((R,), -1, jnp.int32)

    if T > 0:
        nb = _round_up(T, block) // block
        pad = nb * block - T

        def blocks(x):
            return jnp.pad(x, ((0, pad), (0, 0))).reshape(nb, block, 3)

        v0, e1, e2 = blocks(geom.tri_v0), blocks(geom.tri_e1), blocks(geom.tri_e2)
        if geom.tri_dv0 is not None:
            dv = (blocks(geom.tri_dv0), blocks(geom.tri_de1), blocks(geom.tri_de2))
            dt = geom.norm_time(ray.time)[:, None, None]
        else:
            dv = (jnp.zeros((nb, 1, 3)),) * 3  # broadcast no-op
            dt = 0.0

        def body(carry, blk):
            tb, pb = carry
            bv0, be1, be2, bd0, bd1, bd2, base = blk
            t, valid = _tri_t(
                bv0[None] + dt * bd0[None], be1[None] + dt * bd1[None],
                be2[None] + dt * bd2[None],
                ray.o[:, None], ray.d[:, None],
                ray.tmin[:, None], tb[:, None],
            )  # [R, block]
            t = jnp.where(valid, t, BIG)
            idx = jnp.argmin(t, axis=-1)
            tmin_blk = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
            better = tmin_blk < tb
            pid = base + idx.astype(jnp.int32)
            # padded lanes have v0=e1=e2=0 -> degenerate, invalid
            return (jnp.where(better, tmin_blk, tb),
                    jnp.where(better, pid, pb)), None

        bases = (jnp.arange(nb, dtype=jnp.int32) * block)
        (t_best, prim_best), _ = jax.lax.scan(
            body, (t_best, prim_best), (v0, e1, e2, *dv, bases)
        )

    if Q > 0:
        # quadrics are few; single block
        if geom.quad_o2w_end is not None:
            all_q = jnp.arange(Q)
            _, w2o_t = geom.quad_xforms_at(all_q[None, :], ray.time[:, None])
        else:
            w2o_t = geom.quad_w2o[None]
        o_obj = xform_point_affine(w2o_t, ray.o[:, None])  # [R,Q,3]
        d_obj = xform_vector(w2o_t, ray.d[:, None])
        present = set(int(x) for x in np.asarray(geom.quad_type))
        t, valid = _quad_candidates(
            geom.quad_type[None], geom.quad_params[None], o_obj, d_obj,
            ray.tmin[:, None], t_best[:, None], present=present,
        )
        t = jnp.where(valid, t, BIG)
        idx = jnp.argmin(t, axis=-1)
        tmin_q = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
        better = tmin_q < t_best
        t_best = jnp.where(better, tmin_q, t_best)
        prim_best = jnp.where(better, T + idx.astype(jnp.int32), prim_best)

    hit_valid = prim_best >= 0
    return jnp.where(hit_valid, t_best, BIG), prim_best


def reconstruct(geom: SceneGeom, ray: Ray, t: jnp.ndarray, prim: jnp.ndarray) -> Hit:
    """Phase 2: differential geometry for the winning prim per ray.

    Uses the packed single-gather path when compile_scene built the
    packs; the per-field fallback below serves hand-rolled geometries."""
    if (geom.tri_pack is not None or geom.n_tris == 0) and (
            geom.quad_pack is not None or geom.n_quads == 0):
        if geom.n_tris > 0 or geom.n_quads > 0:
            return _reconstruct_packed(geom, ray, t, prim)
    R = ray.o.shape[0]
    T = geom.n_tris
    valid = prim >= 0
    is_tri = valid & (prim < T)
    tri_idx = jnp.clip(jnp.where(is_tri, prim, 0), 0, max(T - 1, 0))
    quad_idx = jnp.clip(jnp.where(valid & ~is_tri, prim - T, 0), 0, max(geom.n_quads - 1, 0))

    p_hit = ray.at(t)

    if T > 0:
        v0, e1, e2 = geom.tri_at(tri_idx, ray.time)
        ng_t = normalize(cross(e1, e2))
        # barycentrics at hit (recompute from MT)
        pvec = cross(ray.d, e2)
        det = dot(e1, pvec)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = ray.o - v0
        b1 = dot(tvec, pvec) * inv_det
        b2 = dot(ray.d, cross(tvec, e1)) * inv_det
        b0 = 1.0 - b1 - b2
        ns_v = geom.tri_n[tri_idx]  # [R, 3, 3]
        ns_t = normalize(
            b0[:, None] * ns_v[:, 0] + b1[:, None] * ns_v[:, 1] + b2[:, None] * ns_v[:, 2]
        )
        has_n = geom.tri_has_n[tri_idx]
        ns_t = jnp.where(has_n[:, None], ns_t, ng_t)
        uvs = geom.tri_uv[tri_idx]  # [R, 3, 2]
        uv_t = b0[:, None] * uvs[:, 0] + b1[:, None] * uvs[:, 1] + b2[:, None] * uvs[:, 2]
        # dpdu from uv parameterization (reference trianglemesh.cpp)
        duv1 = uvs[:, 1] - uvs[:, 0]
        duv2 = uvs[:, 2] - uvs[:, 0]
        det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        inv_uv = jnp.where(jnp.abs(det_uv) > 1e-12, 1.0 / det_uv, 0.0)
        dpdu_t = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_uv[:, None]
        degen = jnp.abs(det_uv) < 1e-12
        fallback, _ = _coord_sys(ng_t)
        dpdu_t = jnp.where(degen[:, None], fallback, dpdu_t)
        mat_t = geom.tri_mat[tri_idx]
        light_t = geom.tri_light[tri_idx]
    else:
        z3 = jnp.zeros((R, 3))
        ng_t = ns_t = dpdu_t = z3
        uv_t = jnp.zeros((R, 2))
        mat_t = light_t = jnp.zeros((R,), jnp.int32)

    if geom.n_quads > 0:
        qtype = geom.quad_type[quad_idx]
        qparams = geom.quad_params[quad_idx]
        qflip = geom.quad_flip[quad_idx]
        o2w, w2o = geom.quad_xforms_at(quad_idx, ray.time)
        # object-space t equals world-space t only for rigid transforms;
        # recompute t in object space from the world hit is unnecessary —
        # we intersected with the object-space ray built from the world ray,
        # so t is consistent under affine maps of o and d.
        p_q, n_q, uv_q, dpdu_q = _quad_detail(
            qtype, qparams, qflip, o2w, w2o, ray.o, ray.d, t
        )
        mat_q = geom.quad_mat[quad_idx]
        light_q = geom.quad_light[quad_idx]
    else:
        z3 = jnp.zeros((R, 3))
        p_q = n_q = dpdu_q = z3
        uv_q = jnp.zeros((R, 2))
        mat_q = light_q = jnp.zeros((R,), jnp.int32)

    sel = is_tri[:, None]
    ng = jnp.where(sel, ng_t, n_q)
    ns = jnp.where(sel, ns_t, n_q)
    uv = jnp.where(is_tri[:, None], uv_t, uv_q)
    dpdu = jnp.where(sel, dpdu_t, dpdu_q)
    p = jnp.where(sel, p_hit, p_q)
    mat = jnp.where(is_tri, mat_t, mat_q)
    light = jnp.where(is_tri, light_t, light_q)
    # orient geometric normal into ns hemisphere? pbrt keeps ng and aligns
    # ns such that dot(ng, ns) > 0 (trianglemesh) — mirror that:
    ng = jnp.where((dot(ng, ns) < 0.0)[:, None], -ng, ng)
    return Hit(
        valid=valid,
        t=jnp.where(valid, t, BIG),
        p=jnp.where(valid[:, None], p, 0.0),
        ng=jnp.where(valid[:, None], ng, 0.0),
        ns=jnp.where(valid[:, None], ns, 0.0),
        uv=jnp.where(valid[:, None], uv, 0.0),
        dpdu=jnp.where(valid[:, None], dpdu, 0.0),
        mat=jnp.where(valid, mat, -1),
        light=jnp.where(valid, light, -1),
        prim=jnp.where(valid, prim, -1),
    )


def _coord_sys(n):
    from pbrt_tpu.core.geometry import coordinate_system

    return coordinate_system(n)


# ---------------------------------------------------------------------------
# Packed reconstruct: one row-gather per hit

def make_tri_pack(v0, e1, e2, n, uv, has_n, mat, light,
                  dv0=None, de1=None, de2=None):
    """Host build of the [T, 27(+9)] triangle reconstruct rows:
      0-8   v0 e1 e2
      9-17  shading normals n0 n1 n2
      18-23 uv0 uv1 uv2
      24    has_n (0/1)   25 mat   26 light   (ints exact in f32)
      27-35 motion deltas dv0 de1 de2 (present iff animated)"""
    T = len(v0)
    cols = [
        np.asarray(v0, np.float32), np.asarray(e1, np.float32),
        np.asarray(e2, np.float32),
        np.asarray(n, np.float32).reshape(T, 9),
        np.asarray(uv, np.float32).reshape(T, 6),
        np.asarray(has_n, np.float32).reshape(T, 1),
        np.asarray(mat, np.float32).reshape(T, 1),
        np.asarray(light, np.float32).reshape(T, 1),
    ]
    if dv0 is not None:
        cols += [np.asarray(dv0, np.float32), np.asarray(de1, np.float32),
                 np.asarray(de2, np.float32)]
    return np.concatenate(cols, axis=1) if T else np.zeros(
        (0, 36 if dv0 is not None else 27), np.float32)


def make_quad_pack(o2w, w2o, params, qtype, flip, mat, light,
                   o2w_end=None, w2o_end=None):
    """Host build of the [Q, 34(+24)] quadric reconstruct rows:
      0-11  o2w affine rows (3x4, row-major)
      12-23 w2o affine rows
      24-29 params r zmin zmax phimax p4 p5
      30 type  31 flip  32 mat  33 light
      34-45 o2w_end affine, 46-57 w2o_end affine (iff animated)"""
    Q = len(qtype)
    if Q == 0:
        return np.zeros((0, 58 if o2w_end is not None else 34), np.float32)
    o2w = np.asarray(o2w, np.float32)
    w2o = np.asarray(w2o, np.float32)
    cols = [
        o2w[:, :3, :4].reshape(Q, 12),
        w2o[:, :3, :4].reshape(Q, 12),
        np.asarray(params, np.float32)[:, :6],
        np.asarray(qtype, np.float32).reshape(Q, 1),
        np.asarray(flip, np.float32).reshape(Q, 1),
        np.asarray(mat, np.float32).reshape(Q, 1),
        np.asarray(light, np.float32).reshape(Q, 1),
    ]
    if o2w_end is not None:
        cols += [np.asarray(o2w_end, np.float32)[:, :3, :4].reshape(Q, 12),
                 np.asarray(w2o_end, np.float32)[:, :3, :4].reshape(Q, 12)]
    return np.concatenate(cols, axis=1)


def _rsqrt_norm3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-24))
    return x * inv, y * inv, z * inv


def _coord_sys_c(nx, ny, nz):
    """coordinate_system first axis, componentwise (geometry.py analog)."""
    use_x = jnp.abs(nx) > jnp.abs(ny)
    inv1 = jax.lax.rsqrt(jnp.maximum(nx * nx + nz * nz, 1e-24))
    inv2 = jax.lax.rsqrt(jnp.maximum(ny * ny + nz * nz, 1e-24))
    v1x = jnp.where(use_x, -nz * inv1, 0.0)
    v1y = jnp.where(use_x, 0.0, nz * inv2)
    v1z = jnp.where(use_x, nx * inv1, -ny * inv2)
    return v1x, v1y, v1z


def _reconstruct_packed(geom: SceneGeom, ray: Ray, t, prim) -> Hit:
    """Differential geometry via ONE [N, C] row gather per table.

    All math runs on split [N] components (row gathers of many small
    tables cost far more) and stacks into the [N, 3] Hit fields once
    at the end."""
    R = ray.o.shape[0]
    T = geom.n_tris
    valid = prim >= 0
    is_tri = valid & (prim < T)
    ox, oy, oz = ray.o[:, 0], ray.o[:, 1], ray.o[:, 2]
    dx, dy, dz = ray.d[:, 0], ray.d[:, 1], ray.d[:, 2]

    zf = jnp.zeros((R,), jnp.float32)
    zi = jnp.zeros((R,), jnp.int32)

    if T > 0:
        tri_idx = jnp.clip(jnp.where(is_tri, prim, 0), 0, T - 1)
        P = geom.tri_pack[tri_idx]                    # [N, C] one gather

        def c(i):
            return P[:, i]

        v0x, v0y, v0z = c(0), c(1), c(2)
        e1x, e1y, e1z = c(3), c(4), c(5)
        e2x, e2y, e2z = c(6), c(7), c(8)
        if geom.tri_pack.shape[1] >= 36:              # motion deltas
            dt = geom.norm_time(ray.time)
            v0x = v0x + dt * c(27); v0y = v0y + dt * c(28); v0z = v0z + dt * c(29)
            e1x = e1x + dt * c(30); e1y = e1y + dt * c(31); e1z = e1z + dt * c(32)
            e2x = e2x + dt * c(33); e2y = e2y + dt * c(34); e2z = e2z + dt * c(35)
        # geometric normal
        ngx = e1y * e2z - e1z * e2y
        ngy = e1z * e2x - e1x * e2z
        ngz = e1x * e2y - e1y * e2x
        ngx, ngy, ngz = _rsqrt_norm3(ngx, ngy, ngz)
        # Moller-Trumbore barycentrics at the hit
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        b0 = 1.0 - b1 - b2
        # shading normal blend
        nsx = b0 * c(9) + b1 * c(12) + b2 * c(15)
        nsy = b0 * c(10) + b1 * c(13) + b2 * c(16)
        nsz = b0 * c(11) + b1 * c(14) + b2 * c(17)
        nsx, nsy, nsz = _rsqrt_norm3(nsx, nsy, nsz)
        has_n = c(24) > 0.5
        nsx = jnp.where(has_n, nsx, ngx)
        nsy = jnp.where(has_n, nsy, ngy)
        nsz = jnp.where(has_n, nsz, ngz)
        # uv blend
        u_t = b0 * c(18) + b1 * c(20) + b2 * c(22)
        v_t = b0 * c(19) + b1 * c(21) + b2 * c(23)
        # dpdu from the uv parameterization
        du1u, du1v = c(20) - c(18), c(21) - c(19)
        du2u, du2v = c(22) - c(18), c(23) - c(19)
        det_uv = du1u * du2v - du1v * du2u
        inv_uv = jnp.where(jnp.abs(det_uv) > 1e-12, 1.0 / det_uv, 0.0)
        dpdux = (du2v * e1x - du1v * e2x) * inv_uv
        dpduy = (du2v * e1y - du1v * e2y) * inv_uv
        dpduz = (du2v * e1z - du1v * e2z) * inv_uv
        fbx, fby, fbz = _coord_sys_c(ngx, ngy, ngz)
        degen = jnp.abs(det_uv) < 1e-12
        dpdux = jnp.where(degen, fbx, dpdux)
        dpduy = jnp.where(degen, fby, dpduy)
        dpduz = jnp.where(degen, fbz, dpduz)
        mat_t = c(25).astype(jnp.int32)
        light_t = c(26).astype(jnp.int32)
    else:
        ngx = ngy = ngz = nsx = nsy = nsz = zf
        dpdux = dpduy = dpduz = u_t = v_t = zf
        mat_t = light_t = zi

    if geom.n_quads > 0:
        quad_idx = jnp.clip(jnp.where(valid & ~is_tri, prim - T, 0),
                            0, geom.n_quads - 1)
        QP = geom.quad_pack[quad_idx]                 # [N, C] one gather

        def m(i):
            return QP[:, i]

        if geom.quad_pack.shape[1] >= 58:             # animated transforms
            dt = geom.norm_time(ray.time)

            def a_(i):
                return (1.0 - dt) * QP[:, i] + dt * QP[:, 34 + i]

            def b_(i):
                return (1.0 - dt) * QP[:, 12 + i] + dt * QP[:, 46 + i]
        else:
            def a_(i):
                return QP[:, i]

            def b_(i):
                return QP[:, 12 + i]

        # object-space ray
        o_qx = b_(0) * ox + b_(1) * oy + b_(2) * oz + b_(3)
        o_qy = b_(4) * ox + b_(5) * oy + b_(6) * oz + b_(7)
        o_qz = b_(8) * ox + b_(9) * oy + b_(10) * oz + b_(11)
        d_qx = b_(0) * dx + b_(1) * dy + b_(2) * dz
        d_qy = b_(4) * dx + b_(5) * dy + b_(6) * dz
        d_qz = b_(8) * dx + b_(9) * dy + b_(10) * dz
        px = o_qx + t * d_qx
        py = o_qy + t * d_qy
        pz = o_qz + t * d_qz
        r_ = m(24)
        zmin, zmax = m(25), m(26)
        phimax = m(27)
        p4, p5 = m(28), m(29)
        qtype = m(30).astype(jnp.int32)
        flip = m(31) > 0.5
        mat_q = m(32).astype(jnp.int32)
        light_q = m(33).astype(jnp.int32)

        phi = jnp.arctan2(py, px)
        phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
        is_sph = qtype == QUAD_SPHERE
        is_cyl = qtype == QUAD_CYLINDER
        is_disk = qtype == QUAD_DISK
        is_cone = qtype == QUAD_CONE
        is_par = qtype == QUAD_PARABOLOID

        u_q = phi / jnp.maximum(phimax, 1e-9)
        theta = jnp.arccos(jnp.clip(pz / jnp.maximum(r_, 1e-12), -1.0, 1.0))
        thmin = jnp.arccos(jnp.clip(zmax / jnp.maximum(r_, 1e-12), -1.0, 1.0))
        thmax = jnp.arccos(jnp.clip(zmin / jnp.maximum(r_, 1e-12), -1.0, 1.0))
        v_sph = (theta - thmin) / jnp.maximum(thmax - thmin, 1e-9)
        v_lin = (pz - zmin) / jnp.maximum(zmax - zmin, 1e-9)
        dist = jnp.sqrt(jnp.maximum(px * px + py * py, 1e-20))
        v_disk = 1.0 - (dist - p4) / jnp.maximum(r_ - p4, 1e-9)
        v_q = jnp.where(is_sph, v_sph, jnp.where(is_disk, v_disk, v_lin))

        # object-space dpdu (rotation about z) and normal per type
        dpqx, dpqy, dpqz = -phimax * py, phimax * px, zf
        k_cone = (r_ / jnp.maximum(p4, 1e-12)) ** 2
        k_par = p4 / jnp.maximum(r_ * r_, 1e-12)
        n_ox = jnp.where(is_sph, px,
               jnp.where(is_cyl, px,
               jnp.where(is_disk, 0.0,
               jnp.where(is_cone, px,
               jnp.where(is_par, 2.0 * k_par * px, 2.0 * p4 * px)))))
        n_oy = jnp.where(is_sph, py,
               jnp.where(is_cyl, py,
               jnp.where(is_disk, 0.0,
               jnp.where(is_cone, py,
               jnp.where(is_par, 2.0 * k_par * py, 2.0 * p4 * py)))))
        n_oz = jnp.where(is_sph, pz,
               jnp.where(is_cyl, 0.0,
               jnp.where(is_disk, 1.0,
               jnp.where(is_cone, -k_cone * (pz - p4),
               jnp.where(is_par, -1.0, -2.0 * p5 * pz)))))

        # world-space position (o2w point), normal (w2o^T), dpdu (o2w vec)
        p_qx = a_(0) * px + a_(1) * py + a_(2) * pz + a_(3)
        p_qy = a_(4) * px + a_(5) * py + a_(6) * pz + a_(7)
        p_qz = a_(8) * px + a_(9) * py + a_(10) * pz + a_(11)
        n_qx = b_(0) * n_ox + b_(4) * n_oy + b_(8) * n_oz
        n_qy = b_(1) * n_ox + b_(5) * n_oy + b_(9) * n_oz
        n_qz = b_(2) * n_ox + b_(6) * n_oy + b_(10) * n_oz
        n_qx, n_qy, n_qz = _rsqrt_norm3(n_qx, n_qy, n_qz)
        sgn = jnp.where(flip, -1.0, 1.0)
        n_qx, n_qy, n_qz = sgn * n_qx, sgn * n_qy, sgn * n_qz
        dq_x = a_(0) * dpqx + a_(1) * dpqy + a_(2) * dpqz
        dq_y = a_(4) * dpqx + a_(5) * dpqy + a_(6) * dpqz
        dq_z = a_(8) * dpqx + a_(9) * dpqy + a_(10) * dpqz
    else:
        p_qx = p_qy = p_qz = n_qx = n_qy = n_qz = zf
        dq_x = dq_y = dq_z = u_q = v_q = zf
        mat_q = light_q = zi

    # merge tri/quad lanes componentwise, stack once
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    sel = is_tri
    px_o = jnp.where(sel, hx, p_qx)
    py_o = jnp.where(sel, hy, p_qy)
    pz_o = jnp.where(sel, hz, p_qz)
    ngxo = jnp.where(sel, ngx, n_qx)
    ngyo = jnp.where(sel, ngy, n_qy)
    ngzo = jnp.where(sel, ngz, n_qz)
    nsxo = jnp.where(sel, nsx, n_qx)
    nsyo = jnp.where(sel, nsy, n_qy)
    nszo = jnp.where(sel, nsz, n_qz)
    dpxo = jnp.where(sel, dpdux, dq_x)
    dpyo = jnp.where(sel, dpduy, dq_y)
    dpzo = jnp.where(sel, dpduz, dq_z)
    uo = jnp.where(sel, u_t, u_q)
    vo = jnp.where(sel, v_t, v_q)
    mat = jnp.where(sel, mat_t, mat_q)
    light = jnp.where(sel, light_t, light_q)
    # keep ng in the ns hemisphere (trianglemesh convention)
    flip_ng = ngxo * nsxo + ngyo * nsyo + ngzo * nszo < 0.0
    fs = jnp.where(flip_ng, -1.0, 1.0)
    ngxo, ngyo, ngzo = fs * ngxo, fs * ngyo, fs * ngzo

    vm = valid

    def msk(x):
        return jnp.where(vm, x, 0.0)  # where, not multiply: NaN-safe

    return Hit(
        valid=vm,
        t=jnp.where(vm, t, BIG),
        p=jnp.stack([msk(px_o), msk(py_o), msk(pz_o)], -1),
        ng=jnp.stack([msk(ngxo), msk(ngyo), msk(ngzo)], -1),
        ns=jnp.stack([msk(nsxo), msk(nsyo), msk(nszo)], -1),
        uv=jnp.stack([msk(uo), msk(vo)], -1),
        dpdu=jnp.stack([msk(dpxo), msk(dpyo), msk(dpzo)], -1),
        mat=jnp.where(vm, mat, -1),
        light=jnp.where(vm, light, -1),
        prim=jnp.where(vm, prim, -1),
    )


def intersect(geom: SceneGeom, ray: Ray) -> Hit:
    t, prim = t_pass_brute(geom, ray)
    return reconstruct(geom, ray, t, prim)


def intersect_p(geom: SceneGeom, ray: Ray) -> jnp.ndarray:
    """Occlusion query: any hit in (tmin, tmax)? -> [R] bool."""
    _, prim = t_pass_brute(geom, ray)
    return prim >= 0
