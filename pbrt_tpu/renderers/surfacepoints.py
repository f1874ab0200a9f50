"""surfacepoints renderer: Poisson-ish point sampling of scene surfaces.

Replaces reference renderers/surfacepoints.cpp:114-285 (ray-repulsion
point generation written to a file consumed by dipolesubsurface). Batched
form: area-weighted sampling of the triangle/quadric soup followed by
Poisson-disk thinning on the host — deterministic, no mutating octree.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core.error import info


def generate_surface_points(scene, min_dist: float, seed: int = 0,
                            oversample: int = 8):
    """-> (p [P,3], n [P,3], area [P]) host arrays."""
    rng = np.random.RandomState(seed)
    geom = scene.geom
    v0 = np.asarray(geom.tri_v0)
    e1 = np.asarray(geom.tri_e1)
    e2 = np.asarray(geom.tri_e2)
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1) if len(v0) else np.zeros(0)
    pts, nrms = [], []
    total_area = float(areas.sum())
    # quadric spheres: uniform sphere samples
    qt = np.asarray(geom.quad_type)
    qo2w = np.asarray(geom.quad_o2w)
    qp = np.asarray(geom.quad_params)
    sphere_areas = []
    for i in range(len(qt)):
        if qt[i] == 0:  # QUAD_SPHERE
            r = abs(float(qp[i, 0]))
            sphere_areas.append(4.0 * np.pi * r * r)
        else:
            sphere_areas.append(0.0)
    total_area += sum(sphere_areas)
    if total_area <= 0:
        return (np.zeros((0, 3), np.float32),) * 2 + (np.zeros(0, np.float32),)
    n_target = max(16, int(oversample * total_area / max(min_dist ** 2, 1e-12)))
    n_target = min(n_target, 1 << 18)

    if len(v0) and areas.sum() > 0:
        k = int(n_target * areas.sum() / total_area)
        if k > 0:
            cdf = np.cumsum(areas) / areas.sum()
            ti = np.searchsorted(cdf, rng.rand(k))
            b0 = 1.0 - np.sqrt(rng.rand(k))
            b1 = rng.rand(k) * np.sqrt(1.0 - (1.0 - b0) ** 0)  # placeholder
            u = rng.rand(k)
            su = np.sqrt(rng.rand(k))
            b0 = 1.0 - su
            b1 = u * su
            p = v0[ti] + b0[:, None] * e1[ti] + b1[:, None] * e2[ti]
            n = np.cross(e1[ti], e2[ti])
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            pts.append(p)
            nrms.append(n)
    for i, sa in enumerate(sphere_areas):
        if sa <= 0:
            continue
        k = int(n_target * sa / total_area)
        if k == 0:
            continue
        z = 1.0 - 2.0 * rng.rand(k)
        phi = 2.0 * np.pi * rng.rand(k)
        r_ = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        dirs = np.stack([r_ * np.cos(phi), r_ * np.sin(phi), z], -1)
        r = abs(float(qp[i, 0]))
        p_obj = dirs * r
        p_w = (qo2w[i][:3, :3] @ p_obj.T).T + qo2w[i][:3, 3]
        n_w = (np.linalg.inv(qo2w[i][:3, :3]).T @ dirs.T).T
        n_w /= np.maximum(np.linalg.norm(n_w, axis=-1, keepdims=True), 1e-12)
        pts.append(p_w.astype(np.float32))
        nrms.append(n_w.astype(np.float32))
    p = np.concatenate(pts).astype(np.float32)
    n = np.concatenate(nrms).astype(np.float32)

    # Poisson thinning on a grid (keep first point per cell of minDist)
    cell = np.floor(p / max(min_dist, 1e-9)).astype(np.int64)
    key = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
    _, first = np.unique(key, return_index=True)
    keep = np.sort(first)
    p, n = p[keep], n[keep]
    area = np.full(len(p), total_area / max(len(p), 1), np.float32)
    info(f"surfacepoints: {len(p)} points (minDist {min_dist})")
    return p, n, area


def render_surface_points(scene, ro, camera, options=None):
    """Renderer entry: write the point file (reference :284-285)."""
    options = options or {}
    p = ro.renderer_params
    min_dist = p.find_one_float("minsampledistance", 0.25)
    fn = p.find_one_string("filename", "sp.npz")
    p.report_unused('in renderer "surfacepoints"')
    pts, nrms, area = generate_surface_points(scene, min_dist,
                                              int(options.get("seed", 0)))
    np.savez(fn, p=pts, n=nrms, area=area)
    info(f"Wrote surface points to {fn}")
    return {"points": len(pts), "file": fn}
