"""Bidirectional path evaluation for Metropolis light transport.

Replaces the reference's bidirectional option in renderers/metropolis.cpp:
GeneratePath (:229-283), Lpath (:345-392) and Lbidir (:395-470). A
camera subpath and a light subpath are generated from disjoint slices of
the chain's primary-sample vector, then every non-specular (camera i,
light j) vertex pair is connected with a visibility ray; each completed
path length k is down-weighted by 1/(k - nSpecularVertices[k]) exactly
as the reference does (metropolis.cpp:449-452).

Wavefront design: both subpaths are generated wavefront-style for W
chains in lockstep with per-vertex state stacked in unrolled Python
lists (static trip count = maxdepth, XLA fuses the bodies); the i*j
connection sweep is a static double loop of masked [W]-lane evaluations.
Direct lighting at camera vertices uses the light-sampling estimator
(estimate_direct with mis=False) — the reference's EstimateDirect BSDF
half is omitted (unbiased either way; documented deviation).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.geometry import Ray, dot, normalize
from pbrt_tpu.accel.intersect import BIG
from pbrt_tpu.integrators.surface import (
    RAY_EPS,
    _occluded,
    estimate_direct,
    shading_frame,
)
from pbrt_tpu.lights.lighting import area_emission, env_le, sample_light_ray
from pbrt_tpu.materials.bsdf import bsdf_f, bsdf_sample, material_lobes
from pbrt_tpu.scene.compile import CompiledScene, eval_bsdf_params

S = spec.N_BINS

# primary-sample layout (per chain): camera sample, then DPB dims per
# camera vertex, then 5 light-ray dims, then DPB dims per light vertex
CAM_DIMS = 5
DPB = 10
LIGHT_RAY_DIMS = 5


def n_psample_dims(max_depth: int, bidirectional: bool) -> int:
    n = CAM_DIMS + max_depth * DPB
    if bidirectional:
        n += LIGHT_RAY_DIMS + max_depth * DPB
    return n


class _Vertex(NamedTuple):
    valid: jnp.ndarray   # [W] vertex exists
    alpha: jnp.ndarray   # [W, S] throughput INTO the vertex
    p: jnp.ndarray       # [W, 3]
    ns: jnp.ndarray      # [W, 3] shading normal
    wprev: jnp.ndarray   # [W, 3] direction back toward the previous vertex
    spec: jnp.ndarray    # [W] sampled bounce at the vertex was specular
    nspec_comp: jnp.ndarray  # [W] number of specular BxDF components
    le: jnp.ndarray      # [W, S] emitted radiance toward wprev
    lobes: object
    frame: object


class _Escape(NamedTuple):
    alpha: jnp.ndarray      # [W, S] throughput of the escaping ray
    d: jnp.ndarray          # [W, 3]
    escaped: jnp.ndarray    # [W]
    prev_spec: jnp.ndarray  # [W] bounce that produced the escape was specular
    all_spec: jnp.ndarray   # [W] path prefix was all-specular


def _gen_subpath(scene: CompiledScene, ray: Ray, alpha0, valid0, u_fn,
                 max_len: int, with_le: bool):
    """Reference metropolis.cpp GeneratePath (:229-283), wavefront form.

    u_fn(i, dim): psample for vertex i; dims 4..7 bsdf, 8 RR.
    Returns (vertices, escape_record).
    """
    W = ray.o.shape[0]
    alpha = alpha0
    alive = valid0
    prev_spec = jnp.ones((W,), bool)
    all_spec = jnp.ones((W,), bool)
    esc = _Escape(
        alpha=jnp.zeros((W, S), jnp.float32), d=ray.d,
        escaped=jnp.zeros((W,), bool),
        prev_spec=jnp.zeros((W,), bool), all_spec=jnp.zeros((W,), bool),
    )
    verts = []
    cur = ray
    for i in range(max_len):
        hit = scene.intersect(cur)
        esc_now = alive & ~hit.valid
        esc = _Escape(
            alpha=jnp.where(esc_now[:, None], alpha, esc.alpha),
            d=jnp.where(esc_now[:, None], cur.d, esc.d),
            escaped=esc.escaped | esc_now,
            prev_spec=jnp.where(esc_now, prev_spec, esc.prev_spec),
            all_spec=jnp.where(esc_now, all_spec, esc.all_spec),
        )
        v_valid = alive & hit.valid
        params = eval_bsdf_params(scene, hit)
        lobes = material_lobes(params)
        frame = shading_frame(scene, hit)
        wprev = -normalize(cur.d)
        if with_le and scene.lights is not None:
            le = area_emission(scene.lights, jnp.maximum(hit.light, 0),
                               hit.ng, wprev)
            le = jnp.where(((hit.light >= 0) & v_valid)[:, None], le, 0.0)
        else:
            le = jnp.zeros((W, S), jnp.float32)
        nspec_comp = (
            (jnp.sum(lobes.spec_r, -1) > 0).astype(jnp.int32)
            + (jnp.sum(lobes.spec_t, -1) > 0).astype(jnp.int32)
        )
        bs = bsdf_sample(lobes, frame, wprev,
                         u_fn(i, 4), u_fn(i, 5), u_fn(i, 6), u_fn(i, 7))
        verts.append(_Vertex(
            valid=v_valid, alpha=alpha, p=hit.p, ns=frame.ns, wprev=wprev,
            spec=bs.is_specular, nspec_comp=nspec_comp, le=le,
            lobes=lobes, frame=frame,
        ))
        # continuation with the reference's per-vertex RR (:270-276)
        cos_i = jnp.abs(dot(bs.wi, frame.ns))
        path_scale = bs.f * (cos_i / jnp.maximum(bs.pdf, 1e-12))[:, None]
        ok = bs.valid & ~spec.is_black(path_scale)
        rr_prob = jnp.clip(spec.y(path_scale), 0.0, 1.0)
        survive = u_fn(i, 8) <= rr_prob
        alpha = alpha * path_scale / jnp.maximum(rr_prob, 1e-9)[:, None]
        prev_spec = bs.is_specular
        all_spec = all_spec & bs.is_specular
        alive = v_valid & ok & survive
        alpha = jnp.where(alive[:, None], alpha, 0.0)
        cur = Ray(hit.p + bs.wi * RAY_EPS, bs.wi,
                  jnp.zeros((W,), jnp.float32), jnp.full((W,), BIG), cur.time)
    return verts, esc


def path_l_psamples(scene: CompiledScene, camera, film, u, max_depth: int,
                    bidirectional: bool = True, skip_direct: bool = False):
    """Full MLT path contribution from a primary-sample vector u [W, D].

    Returns (px, py, L [W, S]). skip_direct mirrors the reference's
    doDirectSeparately gating (contributions along all-specular prefixes
    are left to the separate direct-lighting pass, metropolis.cpp
    :354-360,416-422).
    """
    W = u.shape[0]
    px = film.x0 + u[:, 0] * film.nx
    py = film.y0 + u[:, 1] * film.ny
    ray, rw = camera.generate_rays(px, py, u[:, 2], u[:, 3], u[:, 4])
    alpha0 = jnp.ones((W, S), jnp.float32) * rw[:, None]

    def u_cam(i, dim):
        return u[:, CAM_DIMS + i * DPB + dim]

    cam_verts, esc = _gen_subpath(
        scene, ray, alpha0, jnp.ones((W,), bool), u_cam, max_depth,
        with_le=True)

    light_verts = []
    l_valid0 = jnp.zeros((W,), bool)
    if bidirectional and scene.lights is not None:
        lb = CAM_DIMS + max_depth * DPB
        li, pmf = scene.light_dist.sample_discrete(u[:, lb])
        li = li.astype(jnp.int32)
        world_c = jnp.asarray(
            0.5 * (scene.world_lo + scene.world_hi), jnp.float32)
        world_rad = float(
            np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3
        lr = sample_light_ray(scene.lights, scene.envs, li, world_c,
                              world_rad, u[:, lb + 1], u[:, lb + 2],
                              u[:, lb + 3], u[:, lb + 4])
        l_alpha0 = lr.alpha / jnp.maximum(pmf, 1e-12)[:, None]
        l_valid0 = lr.valid & ~spec.is_black(l_alpha0)
        lray = Ray(lr.o + lr.d * RAY_EPS, lr.d,
                   jnp.zeros((W,), jnp.float32), jnp.full((W,), BIG),
                   ray.time)

        def u_lt(j, dim):
            return u[:, lb + LIGHT_RAY_DIMS + j * DPB + dim]

        light_verts, _ = _gen_subpath(
            scene, lray, l_alpha0, l_valid0, u_lt, max_depth, with_le=False)

    # Stack the per-vertex trees to [T, W, ...] and run ONE scanned body
    # over camera vertices — compile cost stays O(1) in maxdepth instead
    # of O(maxdepth^2) intersect instances for the connection sweep.
    import jax

    def _stack(verts):
        stripped = [v._replace(lobes=v.lobes._replace(meas_tables=None))
                    for v in verts]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *stripped)

    meas_tables = cam_verts[0].lobes.meas_tables
    cam = _stack(cam_verts)
    T = len(cam_verts)
    Tl = len(light_verts)
    lt = _stack(light_verts) if light_verts else None

    # nSpecularVertices[k]: specular (i, j) pairs completing length k
    # (reference metropolis.cpp:405-411) -> [Kmax, W]
    k_max = T + Tl + 2
    if Tl > 0:
        pair = ((cam.spec[:, None] | lt.spec[None, :])
                & cam.valid[:, None] & lt.valid[None, :])  # [T, Tl, W]
        k_idx = (jnp.arange(T)[:, None] + jnp.arange(Tl)[None, :] + 2).reshape(-1)
        nspec = jax.ops.segment_sum(
            pair.astype(jnp.float32).reshape(T * Tl, W), k_idx,
            num_segments=k_max)
        lt_flat = jax.tree_util.tree_map(
            lambda x: x.reshape((Tl * W,) + x.shape[2:]), lt)
        lt_flat = lt_flat._replace(
            lobes=lt_flat.lobes._replace(meas_tables=meas_tables))
    else:
        nspec = jnp.zeros((k_max, W), jnp.float32)
        lt_flat = None

    u_direct = u[:, CAM_DIMS:CAM_DIMS + T * DPB].reshape(W, T, DPB)
    u_direct = jnp.moveaxis(u_direct, 1, 0)  # [T, W, DPB]
    ones_w = jnp.ones((W,), bool)
    tm = ray.time

    def body(carry, xs):
        L, prev_spec, all_spec = carry
        vc, u_i, i = xs
        vc = vc._replace(lobes=vc.lobes._replace(meas_tables=meas_tables))
        gate = ~all_spec if skip_direct else ones_w
        # emission toward the camera path (only after specular bounces;
        # diffuse-bounce emission is covered by the previous vertex's Ld)
        L = L + jnp.where((prev_spec & gate & vc.valid)[:, None],
                          vc.alpha * vc.le, 0.0)
        # Bidirectional MIS weight for the direct strategy applies only
        # to lanes that actually have a light subpath; unidirectional
        # lanes (Tl == 0 or an invalid/black light sample) add Ld
        # unweighted, mirroring the reference's Lpath vs Lbidir split
        # (metropolis.cpp:325-330,383 vs :414-433).
        wt_d = jnp.where(
            l_valid0,
            1.0 / jnp.maximum((i + 1).astype(jnp.float32) - nspec[i + 1], 1.0),
            1.0)
        Ld = estimate_direct(
            scene, vc.lobes, vc.frame, vc.p, vc.wprev,
            u_i[:, 0], u_i[:, 1], u_i[:, 2], vc.valid & gate,
            time=tm, mis=False)
        L = L + vc.alpha * Ld * wt_d[:, None]

        # connect to every light vertex at once (reference :436-462),
        # flattened to [Tl * W] lanes
        if Tl > 0:
            def rep(x):
                return jnp.broadcast_to(x[None], (Tl,) + x.shape).reshape(
                    (Tl * W,) + x.shape[1:])

            vc_f = jax.tree_util.tree_map(rep, vc._replace(
                lobes=vc.lobes._replace(meas_tables=None)))
            vc_f = vc_f._replace(
                lobes=vc_f.lobes._replace(meas_tables=meas_tables))
            vl = lt_flat
            ok = vc_f.valid & vl.valid & ~vc_f.spec & ~vl.spec
            w_vec = vl.p - vc_f.p
            dist2 = jnp.maximum(jnp.sum(w_vec * w_vec, -1), 1e-12)
            w_dir = w_vec / jnp.sqrt(dist2)[:, None]
            fc = bsdf_f(vc_f.lobes, vc_f.frame, vc_f.wprev, w_dir) \
                * (1.0 + vc_f.nspec_comp.astype(jnp.float32))[:, None]
            fl = bsdf_f(vl.lobes, vl.frame, -w_dir, vl.wprev) \
                * (1.0 + vl.nspec_comp.astype(jnp.float32))[:, None]
            ok = ok & ~spec.is_black(fc) & ~spec.is_black(fl)
            occ = _occluded(scene, vc_f.p, w_dir, jnp.sqrt(dist2), ok,
                            time=jnp.broadcast_to(tm[None], (Tl, W)).reshape(-1))
            ok = ok & ~occ
            k_i = i + 2 + jnp.arange(Tl)                 # [Tl]
            path_wt = 1.0 / jnp.maximum(
                k_i[:, None].astype(jnp.float32) - nspec[k_i], 1.0)  # [Tl, W]
            g = (jnp.abs(dot(vc_f.ns, w_dir)) * jnp.abs(dot(vl.ns, w_dir))
                 / dist2)
            contrib = (vc_f.alpha * fc * fl * vl.alpha
                       * (g * path_wt.reshape(-1))[:, None])
            contrib = jnp.where(ok[:, None], contrib, 0.0)
            L = L + contrib.reshape(Tl, W, S).sum(0)

        prev_spec = jnp.where(vc.valid, vc.spec, prev_spec)
        all_spec = all_spec & (vc.spec | ~vc.valid)
        return (L, prev_spec, all_spec), None

    L0 = jnp.zeros((W, S), jnp.float32)
    (L, prev_spec, all_spec), _ = jax.lax.scan(
        body, (L0, ones_w, ones_w),
        (cam, u_direct, jnp.arange(T, dtype=jnp.int32)))

    # escaped-ray environment contribution (reference :383-388,464-469)
    if scene.envs:
        gate_esc = ~esc.all_spec if skip_direct else ones_w
        le_env = env_le(scene.lights, scene.envs, esc.d)
        L = L + jnp.where((esc.escaped & esc.prev_spec & gate_esc)[:, None],
                          esc.alpha * le_env, 0.0)
    return px, py, L
