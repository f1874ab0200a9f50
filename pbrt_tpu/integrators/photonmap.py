"""Photon-mapping surface integrator.

Replaces reference integrators/photonmap.cpp: direct lighting + caustic
photon density estimate + (final-gathered or direct) indirect estimate
+ specular recursion. The kNN heap becomes the sorted-grid top-k
(pbrt_tpu.photon.map); the density kernel is the reference's Simpson
kernel k(d) = 3/pi (1 - d2/r2)^2 / r2 (photonmap.cpp LPhoton).
"""
from __future__ import annotations

import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.geometry import Ray, dot, normalize
from pbrt_tpu.integrators.surface import (
    BIG,
    RAY_EPS,
    estimate_direct,
    make_frame,
    PathState,
    _add_hit_emission,
    _add_escape_emission,
)
from pbrt_tpu.materials.bsdf import (
    bsdf_f,
    bsdf_sample,
    has_non_specular,
    material_lobes,
)
from pbrt_tpu.photon.map import knn_dirs, knn_weighted_flux
from pbrt_tpu.samplers.samplers import integrator_uniform as iu
from pbrt_tpu.scene.compile import CompiledScene, eval_bsdf_params

S = spec.N_BINS
INV_PI = 1.0 / jnp.pi


def _simpson_kernel(d2, r2):
    s = jnp.maximum(0.0, 1.0 - d2 / jnp.maximum(r2, 1e-12))
    return 3.0 * INV_PI * s * s / jnp.maximum(r2, 1e-12)


def lphoton_surface(pm, lobes, frame, p, wo, n_used: int, max_dist2: float):
    """Surface radiance estimate from a photon map (reference
    photonmap.cpp LPhoton diffuse form): Simpson-kernel flux split by
    hemisphere against Nf = Faceforward(ns, wo), reflected flux times
    rho_r/pi plus transmitted flux times rho_t/pi (photonmap.cpp
    :88-103 Lr/Lt). Fused + query-blocked: no [N, K, S] temps. [N, S].
    """
    if pm is None:
        return jnp.zeros(p.shape[:-1] + (S,), jnp.float32)
    sgn = jnp.where(dot(wo, frame.ns) >= 0.0, 1.0, -1.0)  # Nf orientation

    def weight(wix, wiy, wiz, d2, valid, r2, ns, sg):
        kern = _simpson_kernel(d2, r2[:, None])            # [B, K]
        cosn = (wix * ns[:, 0:1] + wiy * ns[:, 1:2]
                + wiz * ns[:, 2:3]) * sg[:, None]
        front = cosn > 0.0
        return jnp.stack([jnp.where(front, kern, 0.0),
                          jnp.where(front, 0.0, kern)], axis=-1)  # [B,K,2]

    res = knn_weighted_flux(pm, p, n_used, max_dist2, weight,
                            extras=(frame.ns, sgn), compact=True)
    flux_r, flux_t = res.flux[:, 0], res.flux[:, 1]        # [N, S]
    from pbrt_tpu.materials.bsdf import rho_proxies

    rho_r, rho_t = rho_proxies(lobes)  # reflectance proxy (mix-aware)
    return (flux_r * rho_r + flux_t * rho_t) * INV_PI


def li_photonmap(scene: CompiledScene, ctx, ray: Ray, pixel, sidx,
                 max_depth: int = 5, seed: int = 0, transmittance_fn=None):
    """Eye-side evaluation: direct + caustic + indirect + specular
    recursion (reference photonmap.cpp:159-331)."""
    N = ray.o.shape[0]
    st = PathState(
        ray_o=ray.o, ray_d=ray.d,
        throughput=jnp.ones((N, S), jnp.float32),
        L=jnp.zeros((N, S), jnp.float32),
        alive=jnp.ones((N,), bool),
        prev_bsdf_pdf=jnp.zeros((N,), jnp.float32),
        prev_specular=jnp.ones((N,), bool),
        lam_nm=jnp.full((N,), -1.0, jnp.float32),
        bounces=jnp.zeros((N,), jnp.int32),
    )
    zf = jnp.zeros((N,), jnp.float32)
    tm = ray.time
    for depth in range(max_depth + 1):
        hit = scene.intersect(Ray(st.ray_o, st.ray_d, zf, jnp.full((N,), BIG), tm),
                              coherent=depth == 0)
        st = st._replace(L=_add_hit_emission(scene, st, hit, depth == 0))
        escaped = st.alive & ~hit.valid
        st = st._replace(L=_add_escape_emission(scene, st, escaped, True))
        alive = st.alive & hit.valid
        if depth == max_depth:
            break
        params = eval_bsdf_params(scene, hit)
        lobes = material_lobes(params)
        frame = make_frame(hit)
        wo = -normalize(st.ray_d)
        has_ns = has_non_specular(lobes)

        Ld = estimate_direct(
            scene, lobes, frame, hit.p, wo,
            iu(pixel, sidx, depth, 0, seed), iu(pixel, sidx, depth, 1, seed),
            iu(pixel, sidx, depth, 2, seed), alive & has_ns,
            transmittance_fn=transmittance_fn, time=tm,
        )
        Lc = lphoton_surface(ctx.caustic, lobes, frame, hit.p, wo,
                             ctx.n_used, ctx.max_dist2)
        if (ctx.final_gather and ctx.indirect is not None
                and ctx.radiance is not None):
            Li_ind = _final_gather(scene, ctx, lobes, frame, hit.p, wo,
                                   pixel, sidx, depth, seed)
        else:
            Li_ind = lphoton_surface(ctx.indirect, lobes, frame, hit.p, wo,
                                     ctx.n_used, ctx.max_dist2)
        add = (Ld + Lc + Li_ind) * st.throughput
        st = st._replace(L=st.L + jnp.where((alive & has_ns)[..., None], add,
                                            jnp.where(alive[..., None], Ld * st.throughput, 0.0)))

        # specular-only recursion (reference photonmap.cpp SpecularReflect/
        # Transmit chain)
        bs = bsdf_sample(
            lobes, frame, wo,
            iu(pixel, sidx, depth, 4, seed), iu(pixel, sidx, depth, 5, seed),
            iu(pixel, sidx, depth, 6, seed), iu(pixel, sidx, depth, 7, seed),
            lam_nm=st.lam_nm, u_pick=iu(pixel, sidx, depth, 8, seed),
        )
        cos_i = jnp.abs(dot(bs.wi, frame.ns))
        tp_new = st.throughput * bs.f * (cos_i / jnp.maximum(bs.pdf, 1e-12))[..., None]
        alive = alive & bs.valid & bs.is_specular & ~spec.is_black(tp_new)
        st = PathState(
            ray_o=hit.p + bs.wi * RAY_EPS, ray_d=bs.wi,
            throughput=jnp.where(alive[..., None], tp_new, 0.0),
            L=st.L, alive=alive,
            prev_bsdf_pdf=bs.pdf, prev_specular=jnp.ones((N,), bool),
            lam_nm=st.lam_nm, bounces=st.bounces + 1,
        )
    return st.L


def _final_gather(scene, ctx, lobes, frame, p, wo, pixel, sidx, depth, seed):
    """One-bounce final gather with the reference's two MIS-combined
    strategies (photonmap.cpp:183-296): BSDF-sampled and
    photon-cone-sampled gather rays, each shaded at its hit by the
    NEAREST radiance photon's precomputed Lo (radiance map,
    photonshooter.cpp:506-523) — not by re-estimating density from the
    raw maps. Each strategy runs ctx.gather_samples rays (already the
    reference's gatherSamples/2 split) inside ONE lax.scan body so the
    XLA program holds a single gather-trace instance."""
    import jax

    from pbrt_tpu.core.sampling import power_heuristic, uniform_sample_cone
    from pbrt_tpu.core.geometry import coordinate_system
    from pbrt_tpu.materials.bsdf import bsdf_pdf, bsdf_sample
    from pbrt_tpu.photon.map import radiance_lookup

    N = p.shape[0]
    n_g = max(1, ctx.gather_samples)
    cos_ga = ctx.cos_gather_angle
    cone_pdf = 1.0 / (2.0 * jnp.pi * max(1.0 - cos_ga, 1e-6))

    # nearby indirect photon directions for importance sampling
    # (reference :193-207, nIndirSamplePhotons=50; the reference doubles
    # the search radius until 50 are found — the grid gather uses a
    # generous fixed radius instead and tolerates fewer). Directions as
    # split [N, K] components.
    N_IND = 50
    pdx, pdy, pdz, pd_valid = knn_dirs(ctx.indirect, p, N_IND,
                                       ctx.max_dist2 * 16.0)
    n_pd = jnp.maximum(jnp.sum(pd_valid.astype(jnp.int32), -1), 1)

    def photon_pdf_of(wi):
        """pdf of photon-cone sampling producing wi (reference :229-235)."""
        cosw = (pdx * wi[:, 0:1] + pdy * wi[:, 1:2] + pdz * wi[:, 2:3])
        match = cosw > 0.999 * cos_ga
        cnt = jnp.sum((match & pd_valid).astype(jnp.float32), -1)
        return cnt * cone_pdf / n_pd.astype(jnp.float32)

    zf = jnp.zeros((N,), jnp.float32)

    def shade_gather_hit(wi):
        """Trace a gather ray; Lo at the hit from the radiance map."""
        gray = Ray(p + wi * RAY_EPS, wi, zf, jnp.full((N,), BIG), zf)
        ghit = scene.intersect(gray)
        n_gather = jnp.where(dot(ghit.ns, -wi)[..., None] < 0.0,
                             -ghit.ns, ghit.ns)
        lo, found = radiance_lookup(ctx.radiance, ghit.p, n_gather)
        return jnp.where((ghit.valid & found)[..., None], lo, 0.0), ghit.valid

    def body(acc, g):
        # --- strategy 1: BSDF sampling (reference :210-246)
        bs = bsdf_sample(
            lobes, frame, wo,
            iu(pixel, sidx, depth, 50 + 8 * g, seed),
            iu(pixel, sidx, depth, 51 + 8 * g, seed),
            iu(pixel, sidx, depth, 52 + 8 * g, seed),
            iu(pixel, sidx, depth, 53 + 8 * g, seed),
            u_pick=iu(pixel, sidx, depth, 57 + 8 * g, seed))
        # reference samples BSDF_ALL & ~BSDF_SPECULAR: drop specular picks
        ok1 = bs.valid & ~bs.is_specular & (bs.pdf > 1e-9) \
            & ~spec.is_black(bs.f)
        Lind1, hit1 = shade_gather_hit(bs.wi)
        ppdf1 = photon_pdf_of(bs.wi)
        wt1 = power_heuristic(n_g, bs.pdf, n_g, ppdf1)
        c1 = bs.f * Lind1 * (jnp.abs(dot(bs.wi, frame.ns)) * wt1
                             / jnp.maximum(bs.pdf, 1e-9))[..., None]
        acc = acc + jnp.where((ok1 & hit1)[..., None], c1, 0.0)

        # --- strategy 2: photon-cone sampling (reference :249-293)
        u_c = iu(pixel, sidx, depth, 54 + 8 * g, seed)
        pick = jnp.minimum((u_c * n_pd).astype(jnp.int32), n_pd - 1)
        axis = jnp.stack(
            [jnp.take_along_axis(c, pick[:, None], 1)[:, 0]
             for c in (pdx, pdy, pdz)], axis=-1)
        vx, vy = coordinate_system(axis)
        wl = uniform_sample_cone(
            iu(pixel, sidx, depth, 55 + 8 * g, seed),
            iu(pixel, sidx, depth, 56 + 8 * g, seed), cos_ga)
        wi2 = wl[..., 0:1] * vx + wl[..., 1:2] * vy + wl[..., 2:3] * axis
        fr2 = bsdf_f(lobes, frame, wo, wi2)
        ok2 = (jnp.sum(pd_valid, -1) > 0) & ~spec.is_black(fr2)
        Lind2, hit2 = shade_gather_hit(wi2)
        ppdf2 = photon_pdf_of(wi2)
        bpdf2 = bsdf_pdf(lobes, frame, wo, wi2)
        wt2 = power_heuristic(n_g, ppdf2, n_g, bpdf2)
        c2 = fr2 * Lind2 * (jnp.abs(dot(wi2, frame.ns)) * wt2
                            / jnp.maximum(ppdf2, 1e-9))[..., None]
        acc = acc + jnp.where((ok2 & hit2 & (ppdf2 > 1e-9))[..., None],
                              c2, 0.0)
        return acc, None

    acc, _ = jax.lax.scan(body, jnp.zeros((N, S), jnp.float32),
                          jnp.arange(n_g, dtype=jnp.int32))
    return acc / n_g
