"""Uniform-grid accelerator: host CSR build + wavefront 3DDDA traversal.

Replaces reference accelerators/grid.{h,cpp} (GridAccel: voxel grid with
3DDDA stepping, grid.cpp:324 `refineimmediately`). Wavefront design:

- Host build (NumPy): voxel resolution per axis follows the reference's
  heuristic `3 * cbrt(nPrims) / maxExtent`, clamped to [1, 64] voxels
  per axis; every primitive is appended to each voxel its world bbox
  overlaps. The per-voxel lists are stored CSR-style as two tensors
  (voxel_off [NV+1], voxel_prims [M]) instead of pointer vectors.

- Device traversal: one lax.while_loop over the ray wavefront. Each
  ray carries (voxel index, DDA t_next per axis, cursor into the
  current voxel's prim list). An iteration either tests the next chunk
  of K prims in the voxel (shared _leaf_prims_t with the BVH) or DDA-
  steps to the neighbor voxel; rays terminate when the best hit lies
  before the next voxel boundary (the reference's same early-out) or
  the ray exits the grid.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core.error import info
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.accel.intersect import BIG, SceneGeom, reconstruct
from pbrt_tpu.accel.bvh import _leaf_prims_t, _prim_bounds

CHUNK = 4          # prims tested per loop iteration (matches BVH LEAF_MAX)
MAX_AXIS_VOX = 64  # reference grid.cpp clamps nVoxels[axis] to 64


class Grid(NamedTuple):
    lo: jnp.ndarray          # [3] world bounds of the grid
    hi: jnp.ndarray          # [3]
    n_vox: jnp.ndarray       # [3] int32 voxels per axis
    width: jnp.ndarray       # [3] voxel width
    voxel_off: jnp.ndarray   # [NV+1] int32 CSR offsets (x-major flatten)
    voxel_prims: jnp.ndarray  # [M] int32 global prim ids


def build_grid(geom: SceneGeom) -> Optional[Grid]:
    lo_p, hi_p = _prim_bounds(geom)
    n = len(lo_p)
    if n == 0:
        return None
    wlo = lo_p.min(0) - 1e-4
    whi = hi_p.max(0) + 1e-4
    extent = whi - wlo
    max_ext = float(extent.max())
    # reference heuristic: voxelsPerUnitDist = 3 * nPrims^(1/3) / maxExtent
    vpud = 3.0 * n ** (1.0 / 3.0) / max(max_ext, 1e-9)
    nv = np.clip(np.round(extent * vpud).astype(np.int64), 1, MAX_AXIS_VOX)
    width = extent / nv
    inv_w = 1.0 / np.maximum(width, 1e-12)

    # voxel coordinate ranges each prim's bbox overlaps
    lo_v = np.clip(((lo_p - wlo) * inv_w).astype(np.int64), 0, nv - 1)
    hi_v = np.clip(((hi_p - wlo) * inv_w).astype(np.int64), 0, nv - 1)
    counts_per_prim = np.prod(hi_v - lo_v + 1, axis=1)
    total = int(counts_per_prim.sum())

    NV = int(np.prod(nv))
    # build (voxel_id, prim_id) pairs then sort by voxel -> CSR
    vox_ids = np.empty(total, np.int64)
    prim_ids = np.empty(total, np.int32)
    pos = 0
    for i in range(n):
        xs = np.arange(lo_v[i, 0], hi_v[i, 0] + 1)
        ys = np.arange(lo_v[i, 1], hi_v[i, 1] + 1)
        zs = np.arange(lo_v[i, 2], hi_v[i, 2] + 1)
        vz, vy, vx = np.meshgrid(zs, ys, xs, indexing="ij")
        ids = (vz * nv[1] + vy) * nv[0] + vx
        k = ids.size
        vox_ids[pos:pos + k] = ids.ravel()
        prim_ids[pos:pos + k] = i
        pos += k
    order = np.argsort(vox_ids, kind="stable")
    vox_sorted = vox_ids[order]
    prims_sorted = prim_ids[order]
    off = np.zeros(NV + 1, np.int64)
    np.add.at(off, vox_sorted + 1, 1)
    off = np.cumsum(off)

    info(f"Grid: {nv[0]}x{nv[1]}x{nv[2]} voxels, {total} prim refs over {n} prims")
    return Grid(
        lo=jnp.asarray(wlo, jnp.float32), hi=jnp.asarray(whi, jnp.float32),
        n_vox=jnp.asarray(nv, jnp.int32), width=jnp.asarray(width, jnp.float32),
        voxel_off=jnp.asarray(off, jnp.int32),
        voxel_prims=jnp.asarray(prims_sorted, jnp.int32),
    )


def t_pass_grid(grid: Grid, geom: SceneGeom, ray: Ray, any_hit: bool = False):
    """Wavefront 3DDDA. Returns (t [R], prim [R], -1 = miss)."""
    R = ray.o.shape[0]
    o, d = ray.o, ray.d
    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    inv_d = 1.0 / safe_d

    # ray/grid-bounds overlap (slab)
    t_lo = (grid.lo[None] - o) * inv_d
    t_hi = (grid.hi[None] - o) * inv_d
    tn = jnp.maximum(jnp.max(jnp.minimum(t_lo, t_hi), -1), ray.tmin)
    tmax0 = jnp.where(jnp.isfinite(ray.tmax), ray.tmax, BIG)
    tf = jnp.minimum(jnp.min(jnp.maximum(t_lo, t_hi), -1), tmax0)
    inside = tn <= tf

    # entry voxel + DDA increments
    p_in = o + safe_d * tn[:, None]
    nvf = grid.n_vox.astype(jnp.float32)[None]
    vox = jnp.clip(((p_in - grid.lo[None]) / grid.width[None]).astype(jnp.int32),
                   0, grid.n_vox[None] - 1)
    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    # t at the next voxel boundary along each axis
    next_bound = grid.lo[None] + (vox + (step > 0)).astype(jnp.float32) * grid.width[None]
    t_next = tn[:, None] + (next_bound - p_in) * inv_d
    t_next = jnp.where(jnp.abs(d) > 1e-20, t_next, BIG)
    dt = jnp.abs(grid.width[None] * inv_d)
    dt = jnp.where(jnp.abs(d) > 1e-20, dt, BIG)
    out = jnp.where(step > 0, grid.n_vox[None], -1)

    t_best = tmax0
    prim_best = jnp.full((R,), -1, jnp.int32)
    cursor = jnp.zeros((R,), jnp.int32)
    alive = inside

    voxel_off, voxel_prims = grid.voxel_off, grid.voxel_prims
    M = voxel_prims.shape[0]
    nvx, nvy = grid.n_vox[0], grid.n_vox[1]

    def flat_id(v):
        return (v[:, 2] * nvy + v[:, 1]) * nvx + v[:, 0]

    def cond(state):
        return jnp.any(state[5])

    def body(state):
        t_best, prim_best, vox, t_next, cursor, alive = state
        vid = jnp.clip(flat_id(vox), 0, voxel_off.shape[0] - 2)
        start = voxel_off[vid]
        count = voxel_off[vid + 1] - start

        # --- test the next CHUNK prims of this voxel
        k = jnp.arange(CHUNK)
        pidx = start[:, None] + cursor[:, None] + k[None, :]
        in_list = (cursor[:, None] + k[None, :] < count[:, None]) & alive[:, None]
        pidx = jnp.clip(pidx, 0, max(M - 1, 0))
        gids = jnp.where(in_list, voxel_prims[pidx], -1) if M > 0 else \
            jnp.full((R, CHUNK), -1, jnp.int32)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = jnp.where(v_c, t_c, BIG)
        jbest = jnp.argmin(t_c, -1)
        t_leaf = jnp.take_along_axis(t_c, jbest[:, None], 1)[:, 0]
        g_leaf = jnp.take_along_axis(gids, jbest[:, None], 1)[:, 0]
        better = alive & (t_leaf < t_best)
        t_best = jnp.where(better, t_leaf, t_best)
        prim_best = jnp.where(better, g_leaf, prim_best)

        done_chunk = cursor + CHUNK >= count
        cursor2 = jnp.where(done_chunk, 0, cursor + CHUNK)

        # --- DDA step when the voxel's list is exhausted
        axis = jnp.argmin(t_next, -1)
        t_exit = jnp.take_along_axis(t_next, axis[:, None], 1)[:, 0]
        # early out: best hit lies inside this voxel (before its exit)
        hit_here = prim_best >= 0
        if any_hit:
            terminate = hit_here
        else:
            terminate = hit_here & (t_best <= t_exit * (1 + 1e-5))
        do_step = alive & done_chunk
        ax_oh = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        vox2 = jnp.where(do_step[:, None], vox + ax_oh * step, vox)
        t_next2 = jnp.where(do_step[:, None] & (ax_oh > 0), t_next + dt, t_next)
        exited = jnp.any(vox2 == out, -1) | (t_exit > tmax0)
        alive2 = alive & ~(do_step & (terminate | exited))
        # rays mid-voxel (chunking) stay alive regardless
        alive2 = jnp.where(~done_chunk & alive, alive, alive2)
        return t_best, prim_best, vox2, t_next2, cursor2, alive2

    t_best, prim_best, _, _, _, _ = jax.lax.while_loop(
        cond, body, (t_best, prim_best, vox, t_next, cursor, alive)
    )
    hit = prim_best >= 0
    return jnp.where(hit, t_best, BIG), prim_best


class GridScene(NamedTuple):
    """Geometry + uniform-grid acceleration (Accelerator "grid")."""

    geom: SceneGeom
    grid: Optional[Grid]

    def _t_pass(self, ray: Ray, any_hit: bool = False):
        if self.grid is None:
            from pbrt_tpu.accel.intersect import t_pass_brute

            return t_pass_brute(self.geom, ray)
        return t_pass_grid(self.grid, self.geom, ray, any_hit=any_hit)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True)
        return prim >= 0


def make_grid_accel(geom: SceneGeom) -> GridScene:
    return GridScene(geom=geom, grid=build_grid(geom))
