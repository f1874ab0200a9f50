"""Remaining surface integrators: igi, irradiancecache, dipole
subsurface, and the SH/PRT trio (diffuseprt, glossyprt, useprobes).

Wavefront redesigns (documented deviations from the CPU algorithms):

- igi (reference integrators/igi.cpp): VPL sets are generated in a
  wavefront precompute (light paths, same machinery as the photon
  shooter); Li sums a per-pixel-chosen VPL set with the reference's
  gLimit clamping. Identical estimator; the task-local set choice
  becomes a hash pick.
- irradiancecache (reference integrators/irradiancecache.cpp): the
  octree cache is a serial-adaptivity optimization; the wavefront form
  computes hemisphere irradiance directly per hit (nsamples cosine
  rays, one bounce of path radiance). Same image in the limit, no
  cross-ray mutable cache.
- dipolesubsurface (reference integrators/dipolesubsurface.cpp):
  surface points from the surfacepoints renderer; irradiance at each
  point in one wavefront pass; Li sums the classic dipole diffusion
  Rd over ALL points (dense masked sum instead of the octree cut —
  one fused reduction at the point counts pbrt uses).
- diffuseprt/glossyprt (reference integrators/{diffuseprt,glossyprt}
  .cpp): per-hit MC projection of visibility x cos into SH dotted
  with the light's SH projection; glossyprt convolves with the
  Torrance lobe's ZH approximation instead of carrying shrots.cpp
  rotation matrices.
- useprobes (reference integrators/useprobes.cpp): trilinear
  interpolation of grid probes' SH coefficients, dotted with the
  cosine-convolved basis at the shading normal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core import sh as shm
from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.geometry import Ray, dot, normalize
from pbrt_tpu.core.sampling import INV_PI, cosine_sample_hemisphere
from pbrt_tpu.integrators.surface import (
    BIG,
    RAY_EPS,
    _add_escape_emission,
    _add_hit_emission,
    estimate_direct,
    make_frame,
    PathState,
    li_path,
)
from pbrt_tpu.materials.bsdf import bsdf_f, material_lobes
from pbrt_tpu.samplers.samplers import integrator_uniform as iu
from pbrt_tpu.scene.compile import CompiledScene, eval_bsdf_params

S = spec.N_BINS


# ---------------------------------------------------------------------------
# igi

class VplSets(NamedTuple):
    p: jnp.ndarray       # [sets, n, 3]
    n: jnp.ndarray       # [sets, n, 3]
    le: jnp.ndarray      # [sets, n, S] path contribution
    valid: jnp.ndarray   # [sets, n]


def generate_vpls(scene: CompiledScene, n_sets: int, n_per_set: int,
                  max_depth: int, seed: int) -> Optional[VplSets]:
    """Light-path precompute (reference igi.cpp Preprocess)."""
    if scene.lights is None:
        return None
    from pbrt_tpu.lights.lighting import sample_light_ray

    total = n_sets * n_per_set
    lane = jnp.arange(total, dtype=jnp.int32)
    world_c = jnp.asarray(0.5 * (scene.world_lo + scene.world_hi), jnp.float32)
    world_rad = float(np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3

    def u(d, i):
        return iu(lane, jnp.zeros_like(lane), d, i, seed + 77)

    li, pmf = scene.light_dist.sample_discrete(u(0, 0))
    lr = sample_light_ray(scene.lights, scene.envs, li.astype(jnp.int32),
                          world_c, world_rad, u(0, 1), u(0, 2), u(0, 3), u(0, 4))
    alpha = lr.alpha / jnp.maximum(pmf, 1e-12)[..., None]
    ray_o, ray_d = lr.o, lr.d
    alive = ~spec.is_black(alpha)
    ps, ns, les, vs = [], [], [], []
    zf = jnp.zeros((total,), jnp.float32)
    for depth in range(max_depth):
        hit = scene.intersect(Ray(ray_o, ray_d, zf, jnp.full((total,), BIG), zf))
        ok = alive & hit.valid
        params = eval_bsdf_params(scene, hit)
        lobes = material_lobes(params)
        # VPL stores the diffuse exitant field approximation
        rho = lobes.diff_r
        ps.append(hit.p)
        ns.append(hit.ns)
        les.append(jnp.where(ok[..., None], alpha * rho * INV_PI, 0.0))
        vs.append(ok)
        if depth == max_depth - 1:
            break
        from pbrt_tpu.materials.bsdf import bsdf_sample

        frame = make_frame(hit)
        wo = -normalize(ray_d)
        bs = bsdf_sample(lobes, frame, wo, u(depth, 5), u(depth, 6),
                         u(depth, 7), u(depth, 8))
        cos_i = jnp.abs(dot(bs.wi, frame.ns))
        anew = alpha * bs.f * (cos_i / jnp.maximum(bs.pdf, 1e-12))[..., None]
        cont = jnp.clip(spec.y(anew) / jnp.maximum(spec.y(alpha), 1e-12), 0.05, 1.0)
        alive = ok & bs.valid & (u(depth, 9) < cont) & ~spec.is_black(anew)
        alpha = anew / jnp.maximum(cont, 1e-9)[..., None]
        ray_o = hit.p + bs.wi * RAY_EPS
        ray_d = bs.wi
    D = len(ps)
    p = jnp.stack(ps, 1).reshape(n_sets, n_per_set * D, 3)
    nrm = jnp.stack(ns, 1).reshape(n_sets, n_per_set * D, 3)
    le = jnp.stack(les, 1).reshape(n_sets, n_per_set * D, S)
    v = jnp.stack(vs, 1).reshape(n_sets, n_per_set * D)
    return VplSets(p=p, n=nrm, le=le, valid=v)


def li_igi(scene: CompiledScene, vpls: Optional[VplSets], ray: Ray, pixel, sidx,
           max_depth: int = 5, g_limit: float = 10.0, seed: int = 0,
           transmittance_fn=None):
    """Direct + VPL gather (reference igi.cpp:140-230)."""
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    st = PathState(ray.o, ray.d, jnp.ones((N, S)), jnp.zeros((N, S)),
                   jnp.ones((N,), bool), jnp.zeros((N,)), jnp.ones((N,), bool),
                   jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32))
    L = _add_hit_emission(scene, st, hit, True)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = make_frame(hit)
    wo = -normalize(ray.d)
    L = L + estimate_direct(
        scene, lobes, frame, hit.p, wo,
        iu(pixel, sidx, 0, 0, seed), iu(pixel, sidx, 0, 1, seed),
        iu(pixel, sidx, 0, 2, seed), hit.valid, transmittance_fn)
    if vpls is None:
        return jnp.where(hit.valid[..., None], L, L)
    n_sets = vpls.p.shape[0]
    set_idx = (pixel.astype(jnp.uint32) * jnp.uint32(2654435761) >> 8) % jnp.uint32(n_sets)
    vp = vpls.p[set_idx]       # [N, V, 3]
    vn = vpls.n[set_idx]
    vle = vpls.le[set_idx]
    vvalid = vpls.valid[set_idx]
    V = vp.shape[1]
    d = vp - hit.p[:, None, :]
    d2 = jnp.maximum(jnp.sum(d * d, -1), 1e-8)
    wi = d / jnp.sqrt(d2)[..., None]
    cos_s = jnp.maximum(dot(wi, hit.ns[:, None, :]), 0.0)
    cos_l = jnp.maximum(dot(-wi, vn), 0.0)
    G = jnp.minimum(cos_s * cos_l / d2, g_limit)  # clamp (reference :200)
    # single shadow ray per VPL: loop over V in chunks to bound memory
    contrib = jnp.zeros((N, S), jnp.float32)
    for v0 in range(0, V, 8):
        v1 = min(v0 + 8, V)
        for vi in range(v0, v1):
            use = hit.valid & vvalid[:, vi] & (G[:, vi] > 1e-9)
            from pbrt_tpu.integrators.surface import _occluded

            occ = _occluded(scene, hit.p, wi[:, vi], jnp.sqrt(d2[:, vi]), use)
            f = bsdf_f(lobes, frame, wo, wi[:, vi])
            c = f * vle[:, vi] * G[:, vi][..., None]
            contrib = contrib + jnp.where((use & ~occ)[..., None], c, 0.0)
    L = L + contrib / 1.0
    return jnp.where(hit.valid[..., None] | ~hit.valid[..., None], L, L)


# ---------------------------------------------------------------------------
# irradiancecache (cache-free hemisphere gathering)

def li_irradiance(scene: CompiledScene, ray: Ray, pixel, sidx,
                  n_samples: int = 8, seed: int = 0, transmittance_fn=None):
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    st = PathState(ray.o, ray.d, jnp.ones((N, S)), jnp.zeros((N, S)),
                   jnp.ones((N,), bool), jnp.zeros((N,)), jnp.ones((N,), bool),
                   jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32))
    L = _add_hit_emission(scene, st, hit, True)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = make_frame(hit)
    wo = -normalize(ray.d)
    L = L + estimate_direct(
        scene, lobes, frame, hit.p, wo,
        iu(pixel, sidx, 0, 0, seed), iu(pixel, sidx, 0, 1, seed),
        iu(pixel, sidx, 0, 2, seed), hit.valid, transmittance_fn)
    # hemisphere irradiance: ns cosine gather rays, shaded by DIRECT
    # lighting at the gather hit only — the reference's pathL
    # (irradiancecache.cpp) adds UniformSampleOneLight per path vertex
    # and never the vertex's own Le, so a gather ray that happens to
    # strike the area light contributes nothing (its direct term was
    # already estimated above; adding Le here double-counted it, 2x
    # bright on area-lit scenes — caught by the ref_irr golden)
    E = jnp.zeros((N, S), jnp.float32)
    for g in range(n_samples):
        wl = cosine_sample_hemisphere(iu(pixel, sidx, g, 20, seed),
                                      iu(pixel, sidx, g, 21, seed))
        flip = dot(wo, frame.ns) < 0
        wl = jnp.where(flip[..., None], wl * jnp.asarray([1.0, 1.0, -1.0]), wl)
        wi = frame.to_world(wl)
        gray = Ray(hit.p + wi * RAY_EPS, wi, jnp.zeros((N,)),
                   jnp.full((N,), BIG), jnp.zeros((N,)))
        ghit = scene.intersect(gray)
        gparams = eval_bsdf_params(scene, ghit)
        globes = material_lobes(gparams)
        gframe = make_frame(ghit)
        Lg = estimate_direct(
            scene, globes, gframe, ghit.p, -wi,
            iu(pixel, sidx, g, 22, seed), iu(pixel, sidx, g, 23, seed),
            iu(pixel, sidx, g, 24, seed), ghit.valid & hit.valid,
            transmittance_fn)
        E = E + jnp.where(ghit.valid[..., None], Lg, 0.0)
        # pdf = cos/pi cancels the cosine: E += pi * L / n
    E = E * (jnp.pi / n_samples)
    L = L + lobes.diff_r * INV_PI * E  # rho/pi * E
    return jnp.where(hit.valid[..., None], L, L)


# ---------------------------------------------------------------------------
# dipole subsurface

class SurfacePoints(NamedTuple):
    p: jnp.ndarray      # [P, 3]
    n: jnp.ndarray      # [P, 3]
    area: jnp.ndarray   # [P]
    E: jnp.ndarray      # [P, S] irradiance (filled by precompute)


def dipole_rd(d2, sigma_a, sigma_ps, eta: float = 1.3):
    """Classical dipole diffusion Rd(r) (reference dipolesubsurface.cpp
    BSSRDF table; Jensen 2001)."""
    sigma_t = sigma_a + sigma_ps
    alpha_p = sigma_ps / jnp.maximum(sigma_t, 1e-9)
    sigma_tr = jnp.sqrt(3.0 * sigma_a * sigma_t)
    Fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    A = (1.0 + Fdr) / (1.0 - Fdr)
    zr = 1.0 / jnp.maximum(sigma_t, 1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    dr = jnp.sqrt(d2[..., None] + zr * zr)
    dv = jnp.sqrt(d2[..., None] + zv * zv)
    c1 = zr * (sigma_tr + 1.0 / dr)
    c2 = zv * (sigma_tr + 1.0 / dv)
    rd = alpha_p / (4.0 * jnp.pi) * (
        c1 * jnp.exp(-sigma_tr * dr) / (dr * dr)
        + c2 * jnp.exp(-sigma_tr * dv) / (dv * dv)
    )
    return jnp.maximum(rd, 0.0)


def li_dipole(scene: CompiledScene, pts: Optional[SurfacePoints], ray: Ray,
              pixel, sidx, sigma_a, sigma_ps, eta: float = 1.3,
              scale: float = 1.0, seed: int = 0, transmittance_fn=None):
    """Eye pass: Sd = (1/pi) Ft * sum_p Rd(|x-p|) E_p A_p
    (reference dipolesubsurface.cpp:221-287)."""
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    st = PathState(ray.o, ray.d, jnp.ones((N, S)), jnp.zeros((N, S)),
                   jnp.ones((N,), bool), jnp.zeros((N,)), jnp.ones((N,), bool),
                   jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32))
    L = _add_hit_emission(scene, st, hit, True)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = make_frame(hit)
    wo = -normalize(ray.d)
    L = L + estimate_direct(
        scene, lobes, frame, hit.p, wo,
        iu(pixel, sidx, 0, 0, seed), iu(pixel, sidx, 0, 1, seed),
        iu(pixel, sidx, 0, 2, seed), hit.valid, transmittance_fn)
    if pts is not None:
        d2 = jnp.sum((pts.p[None] - hit.p[:, None]) ** 2, -1)  # [N, P]
        rd = dipole_rd(d2, jnp.asarray(sigma_a) * scale,
                       jnp.asarray(sigma_ps) * scale, eta)     # [N, P, S]
        mo = jnp.einsum("nps,ps->ns", rd,
                        pts.E * pts.area[:, None])
        from pbrt_tpu.materials.bsdf import fresnel_dielectric

        ft = 1.0 - fresnel_dielectric(dot(wo, frame.ns), 1.0, eta)
        L = L + (INV_PI * ft)[..., None] * mo
    return jnp.where(hit.valid[..., None], L, L)


def compute_point_irradiance(scene: CompiledScene, pts: SurfacePoints,
                             seed: int = 0) -> SurfacePoints:
    """Irradiance at each surface point from direct lighting (wavefront
    pass; reference dipolesubsurface.cpp Preprocess irradiance tasks)."""
    P = pts.p.shape[0]
    lane = jnp.arange(P, dtype=jnp.int32)
    frame_ns = pts.n
    E = jnp.zeros((P, S), jnp.float32)
    n_s = 4
    for g in range(n_s):
        if scene.lights is None:
            break
        from pbrt_tpu.lights.lighting import sample_light

        u_pick = iu(lane, jnp.zeros_like(lane), g, 80, seed)
        li, pmf = scene.light_dist.sample_discrete(u_pick)
        ls = sample_light(scene.lights, scene.envs, li.astype(jnp.int32), pts.p,
                          iu(lane, jnp.zeros_like(lane), g, 81, seed),
                          iu(lane, jnp.zeros_like(lane), g, 82, seed))
        cos_i = jnp.maximum(dot(ls.wi, frame_ns), 0.0)
        ok = (ls.pdf > 1e-9) & (cos_i > 0)
        from pbrt_tpu.integrators.surface import _occluded

        occ = _occluded(scene, pts.p, ls.wi, ls.dist, ok)
        E = E + jnp.where((ok & ~occ)[..., None],
                          ls.L * (cos_i / jnp.maximum(ls.pdf * pmf, 1e-12))[..., None],
                          0.0)
    return pts._replace(E=E / n_s)


# ---------------------------------------------------------------------------
# PRT trio

def li_diffuseprt(scene: CompiledScene, ray: Ray, pixel, sidx, lmax: int = 4,
                  n_samples: int = 8, seed: int = 0):
    """Transfer = MC projection of V(w) max(0, n.w); L = rho/pi *
    dot(c_light, T) (reference integrators/diffuseprt.cpp:100)."""
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = make_frame(hit)
    c_light = _light_sh(scene, lmax)  # [T, S]
    T = shm.sh_terms(lmax)
    trans = jnp.zeros((N, T), jnp.float32)
    # transfer T = int V(w) max(0, n.w) Y(w) dw, sampled with the
    # cosine-hemisphere pdf cos/pi (the uniform-sphere form wasted half
    # the rays below the horizon and carried the cos in the weight —
    # ~3x the variance at equal sample count)
    for g in range(n_samples):
        wl = cosine_sample_hemisphere(iu(pixel, sidx, g, 30, seed),
                                      iu(pixel, sidx, g, 31, seed))
        w = frame.to_world(wl)
        from pbrt_tpu.integrators.surface import _occluded

        vis_ok = hit.valid
        occ = _occluded(scene, hit.p, w, jnp.full((N,), BIG), vis_ok)
        Y = shm.sh_evaluate(w, lmax)
        weight = jnp.where(vis_ok & ~occ, 1.0, 0.0) * (jnp.pi / n_samples)
        trans = trans + Y * weight[..., None]
    L = jnp.einsum("nt,ts->ns", trans, c_light) * lobes.diff_r * INV_PI
    return jnp.where(hit.valid[..., None], jnp.maximum(L, 0.0), 0.0)


def li_glossyprt(scene: CompiledScene, ray: Ray, pixel, sidx, lmax: int = 4,
                 n_samples: int = 8, roughness: float = 0.1, seed: int = 0):
    """Glossy PRT: the reference carries SH rotation matrices + a BRDF
    matrix (glossyprt.cpp:140); here the Torrance lobe is approximated
    by its ZH expansion around the reflection vector, so
    L = sum_l lam_l(rough) <c_light, Y(refl)> with visibility from MC."""
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = make_frame(hit)
    wo = -normalize(ray.d)
    refl = 2.0 * dot(wo, hit.ns)[..., None] * hit.ns - wo
    c_light = _light_sh(scene, lmax)
    T = shm.sh_terms(lmax)
    # ZH lobe sharpness from roughness: exponent e -> lam ~ exp(-l^2/(2e))
    e = 1.0 / max(roughness, 1e-3)
    lam = np.zeros(T)
    for l in range(lmax + 1):
        v = np.exp(-l * l / (2.0 * e))
        for m in range(-l, l + 1):
            lam[shm.sh_index(l, m)] = v
    Y = shm.sh_evaluate(normalize(refl), lmax)
    L = jnp.einsum("nt,ts->ns", Y * jnp.asarray(lam, jnp.float32), c_light)
    L = L * lobes.gloss
    # visibility along the reflection direction
    from pbrt_tpu.integrators.surface import _occluded

    occ = _occluded(scene, hit.p, normalize(refl), jnp.full((N,), BIG), hit.valid)
    L = jnp.where((hit.valid & ~occ)[..., None], jnp.maximum(L, 0.0), 0.0)
    return L


_LIGHT_SH_CACHE = {}


def _light_sh(scene: CompiledScene, lmax: int):
    """SH projection of the scene's distant illumination (env maps +
    distant lights); cached per scene."""
    key = (id(scene), lmax)
    if key in _LIGHT_SH_CACHE:
        return _LIGHT_SH_CACHE[key]
    dirs, w = shm.sphere_quadrature(24, 48)
    from pbrt_tpu.lights.lighting import env_le

    if scene.lights is not None and scene.envs:
        vals = env_le(scene.lights, scene.envs, dirs)
    else:
        vals = jnp.zeros((dirs.shape[0], S), jnp.float32)
    if scene.lights is not None:
        import numpy as _np

        kinds = _np.asarray(scene.lights.kind)
        from pbrt_tpu.lights.lighting import L_DISTANT

        for li in range(len(kinds)):
            if kinds[li] == L_DISTANT:
                wi = scene.lights.params[li, 0:3]
                conc = jnp.exp(
                    80.0 * (dot(dirs, normalize(wi[None])) - 1.0))
                norm = jnp.sum(conc * w)
                vals = vals + (conc / jnp.maximum(norm, 1e-9))[:, None] * scene.lights.spectra[li]
    c = shm.project_function(vals, dirs, w, lmax)
    _LIGHT_SH_CACHE[key] = c
    return c


class ProbeGrid(NamedTuple):
    """SH radiance probes on a regular grid (createprobes output)."""

    lo: jnp.ndarray        # [3]
    hi: jnp.ndarray        # [3]
    dims: tuple            # (nx, ny, nz)
    coeffs: jnp.ndarray    # [nz, ny, nx, T, S]
    lmax: int


def li_useprobes(scene: CompiledScene, probes: Optional[ProbeGrid], ray: Ray,
                 pixel, sidx, seed: int = 0):
    """Trilinear probe interpolation dotted with the cosine-convolved
    basis at the shading normal (reference useprobes.cpp:54)."""
    N = ray.o.shape[0]
    hit = scene.intersect(ray)
    if probes is None:
        return jnp.zeros((N, S), jnp.float32)
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    nx, ny, nz = probes.dims
    t = (hit.p - probes.lo) / jnp.maximum(probes.hi - probes.lo, 1e-9)
    g = t * jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    g0 = jnp.clip(jnp.floor(g).astype(jnp.int32), 0,
                  jnp.asarray([max(nx - 2, 0), max(ny - 2, 0), max(nz - 2, 0)]))
    f = g - g0
    c = jnp.zeros((N, probes.coeffs.shape[3], S), jnp.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi = jnp.minimum(g0[:, 0] + dx, nx - 1)
                yi = jnp.minimum(g0[:, 1] + dy, ny - 1)
                zi = jnp.minimum(g0[:, 2] + dz, nz - 1)
                wgt = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                c = c + probes.coeffs[zi, yi, xi] * wgt[:, None, None]
    lam = jnp.asarray(shm.lambda_l(probes.lmax), jnp.float32)
    Yn = shm.sh_evaluate(hit.ns, probes.lmax)
    E = jnp.einsum("nt,nts->ns", Yn * lam[None], c)
    L = lobes.diff_r * INV_PI * jnp.maximum(E, 0.0)
    return jnp.where(hit.valid[..., None], L, 0.0)
