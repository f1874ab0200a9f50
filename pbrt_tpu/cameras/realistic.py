"""Realistic lens camera + SML contrast autofocus.

Replaces reference cameras/realistic.cpp (CS348B assignment): a lens
spec file of rows (radius, z-spacing, n, aperture); GenerateRay maps a
film point through a concentric-sampled rear-element disk and refracts
element-by-element (sphere or aperture stop) with Snell's law; weight
w = pi (A/2)^2 cos^4(theta) / filmdist^2 (realistic.cpp:135-246).
AutoFocus renders 16spp zone crops and hill-climbs film distance on
Sum-Modified-Laplacian sharpness with a log-parabola peak fit
(:254-424).

Wavefront form: the element loop is unrolled over the (static, ~10-20) lens
rows with masked early-outs — rays that miss an aperture carry
weight 0 instead of returning early. Autofocus drives the SAME jitted
mini-render per candidate film distance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core.error import info, severe, warning
from pbrt_tpu.core.geometry import Ray, dot, normalize
from pbrt_tpu.core.sampling import concentric_sample_disk
from pbrt_tpu.core.transform import Transform, xform_point_affine, xform_vector
from pbrt_tpu.scene.paramset import ParamSet


@dataclass
class LensSystem:
    # per element, film-side last (as parsed order; traversal rear->front)
    radius: np.ndarray      # [E]
    z_dist: np.ndarray      # [E] vertex z position (0 at front, negative back)
    n_refr: np.ndarray      # [E] refraction index (0 -> air)
    aperture: np.ndarray    # [E] diameter
    film_diag: float
    film_dist: float        # film to rear vertex distance
    af_zones: List[Tuple[float, float, float, float]]


def parse_lens_file(path: str, aperture_diameter: float) -> Tuple[np.ndarray, ...]:
    """Rows: radius, thickness(z to next), n, aperture
    (reference realistic.cpp:65-94)."""
    rows = []
    zdist = 0.0
    thickness = 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            r, z, n, a = (float(parts[0]), float(parts[1]), float(parts[2]),
                          float(parts[3]))
            if abs(r) <= 0:
                a = aperture_diameter
            rows.append((r, zdist, n, a))
            zdist -= z
            thickness = z
    if not rows:
        severe(f"empty lens spec file {path}")
    arr = np.asarray(rows, np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]


def make_realistic_camera(params: ParamSet, cam_to_world: Transform,
                          xres: int, yres: int, sopen: float, sclose: float):
    from pbrt_tpu.cameras.cameras import CAM_REALISTIC, Camera

    specfile = params.find_one_filename("specfile", "")
    filmdistance = params.find_one_float("filmdistance", 70.0)
    ap_diam = params.find_one_float("aperture_diameter", 1.0)
    filmdiag = params.find_one_float("filmdiag", 35.0)
    affile = params.find_one_filename("af_zones", "")
    params.find_one_float("hither", -1)
    params.find_one_float("yon", -1)
    if not specfile:
        severe("No lens spec file supplied to realistic camera")
    radius, zd, nr, ap = parse_lens_file(specfile, ap_diam)
    zones = []
    if affile:
        try:
            with open(affile) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    v = [float(x) for x in line.split()]
                    if len(v) >= 4:
                        zones.append((v[0], v[1], v[2], v[3]))
        except OSError as e:
            warning(f"cannot open autofocus zone file {affile}: {e}")
    params.report_unused('in camera "realistic"')
    lens = LensSystem(radius=radius, z_dist=zd, n_refr=nr, aperture=ap,
                      film_diag=filmdiag, film_dist=filmdistance, af_zones=zones)
    return Camera(
        kind=CAM_REALISTIC, cam_to_world=cam_to_world.m.astype(np.float32),
        raster_to_camera=np.eye(4, dtype=np.float32),
        shutter_open=sopen, shutter_close=sclose, width=xres, height=yres,
        lens=lens,
    )


def realistic_generate_rays(camera, px, py, u1, u2, u_time, film_dist=None):
    """Vectorized GenerateRay (reference realistic.cpp:135-246)."""
    lens: LensSystem = camera.lens
    E = len(lens.radius)
    H = px.shape[0]
    fd = lens.film_dist if film_dist is None else film_dist

    ras_x = px - camera.width / 2.0
    ras_y = py - camera.height / 2.0
    scale = lens.film_diag / np.sqrt(camera.width ** 2 + camera.height ** 2)
    cam_x = -ras_x * scale
    cam_y = ras_y * scale

    first = E - 1  # rear element (film side)
    first_dist = float(lens.z_dist[first])
    full_film = first_dist - fd
    if lens.radius[first] < 0.0:
        x = np.sqrt(lens.radius[first] ** 2 + (lens.aperture[first] / 2) ** 2)
        first_dist = first_dist + lens.radius[first] + x

    lu, lv = concentric_sample_disk(u1, u2)
    a2 = lens.aperture[first] / 2.0
    lu, lv = lu * a2, lv * a2

    p_cam = jnp.stack([cam_x, cam_y, jnp.full((H,), full_film, jnp.float32)], -1)
    p_lens = jnp.stack([lu, lv, jnp.full((H,), first_dist, jnp.float32)], -1)
    d = normalize(p_lens - p_cam)
    cos_t = dot(d, jnp.asarray([0.0, 0.0, -1.0], jnp.float32))
    w = (np.pi * a2 * a2 / (fd * fd)) * jnp.power(jnp.abs(cos_t), 4.0)

    o = p_cam
    dd = d
    alive = jnp.ones((H,), bool)
    for i in range(E - 1, -1, -1):
        R = float(lens.radius[i])
        zv = float(lens.z_dist[i])
        ap_r = float(lens.aperture[i] / 2.0)
        if R != 0.0:
            C = jnp.asarray([0.0, 0.0, zv - R], jnp.float32)
            oc = o - C
            a_q = jnp.sum(dd * dd, -1)
            b_q = 2.0 * jnp.sum(oc * dd, -1)
            c_q = jnp.sum(oc * oc, -1) - R * R
            disc = b_q * b_q - 4.0 * a_q * c_q
            ok = disc >= 0.0
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            t1 = (-b_q - sq) / (2.0 * jnp.maximum(a_q, 1e-12))
            t2 = (-b_q + sq) / (2.0 * jnp.maximum(a_q, 1e-12))
            t = jnp.where((t1 > 0) & (t2 > 0), jnp.minimum(t1, t2),
                          jnp.where(t1 > 0, t1, t2))
            ok = ok & (t > 0)
            P = o + t[..., None] * dd
            ok = ok & (jnp.hypot(P[..., 0], P[..., 1]) <= ap_r)
            N = normalize(P - C)
            if R > 0:
                N = -N
            cos_th = dot(dd, N)
            n1 = float(lens.n_refr[i])
            n2 = float(lens.n_refr[i - 1]) if i != 0 else 1.0
            if n2 == 0.0:
                n2 = 1.0
            if n1 != n2 and n1 != 0.0:
                my = n1 / n2
                k = 1.0 - my * my * (1.0 - cos_th * cos_th)
                ok = ok & (k >= 0.0)
                T = my * dd - (my * cos_th + jnp.sqrt(jnp.maximum(k, 0.0)))[..., None] * N
                o = jnp.where(ok[..., None], P, o)
                dd = jnp.where(ok[..., None], normalize(T), dd)
            else:
                o = jnp.where(ok[..., None], P, o)
            alive = alive & ok
        else:  # aperture stop: plane test
            t = (zv - o[..., 2]) / jnp.where(jnp.abs(dd[..., 2]) > 1e-12,
                                             dd[..., 2], 1e-12)
            P = o + t[..., None] * dd
            ok = jnp.hypot(P[..., 0], P[..., 1]) <= ap_r
            alive = alive & ok

    c2w = jnp.asarray(camera.cam_to_world, jnp.float32)
    o_w = xform_point_affine(c2w[None], o)
    d_w = normalize(xform_vector(c2w[None], dd))
    ray = Ray(o=o_w, d=d_w, tmin=jnp.zeros((H,), jnp.float32),
              tmax=jnp.full((H,), jnp.inf, jnp.float32),
              time=camera.shutter_open + u_time * (camera.shutter_close - camera.shutter_open))
    return ray, jnp.where(alive, w, 0.0)


# ---------------------------------------------------------------------------
# Autofocus (reference realistic.cpp:254-424)

def sml(rgb: np.ndarray, step: int = 2) -> float:
    """Sum-Modified-Laplacian sharpness (reference SML :254-268)."""
    c = rgb[step:-step, step:-step]
    xm = rgb[step:-step, : -2 * step]
    xp = rgb[step:-step, 2 * step:]
    ym = rgb[: -2 * step, step:-step]
    yp = rgb[2 * step:, step:-step]
    ml = np.abs(2 * c - xm - xp) + np.abs(2 * c - ym - yp)
    return float(ml.sum())


def autofocus(scene, camera, film, li_fn, seed: int = 0, spp: int = 16):
    """Hill-climb film distance per AF zone, log-parabola peak
    interpolation; sets camera.lens.film_dist (reference :370-424)."""
    import jax
    import jax.numpy as jnp
    from pbrt_tpu.core import spectrum as spec

    lens: LensSystem = camera.lens
    if not lens.af_zones:
        return

    def zone_sharpness(zone, fdist):
        x0f, x1f, y0f, y1f = zone
        x0 = int(x0f * film.xres)
        x1 = max(x0 + 8, int(x1f * film.xres))
        y0 = int(y0f * film.yres)
        y1 = max(y0 + 8, int(y1f * film.yres))
        xs = np.arange(x0, x1)
        ys = np.arange(y0, y1)
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        acc = np.zeros((len(ys), len(xs), 3), np.float32)
        for s in range(spp):
            h = (np.uint32(s) * np.uint32(0x9E3779B9) + np.uint32(seed))
            rng = np.random.RandomState(int(h) & 0x7FFFFFFF)
            jx = rng.rand(*gx.shape).astype(np.float32)
            jy = rng.rand(*gy.shape).astype(np.float32)
            px = jnp.asarray((gx + jx).ravel(), jnp.float32)
            py = jnp.asarray((gy + jy).ravel(), jnp.float32)
            u1 = jnp.asarray(rng.rand(px.shape[0]), jnp.float32)
            u2 = jnp.asarray(rng.rand(px.shape[0]), jnp.float32)
            ray, w = realistic_generate_rays(camera, px, py, u1, u2,
                                             jnp.zeros_like(px), film_dist=fdist)
            pixel = jnp.arange(px.shape[0], dtype=jnp.int32)
            sidx = jnp.full_like(pixel, s)
            L = li_fn(ray, pixel, sidx, seed)
            rgb = np.asarray(spec.to_rgb(L * w[..., None]))
            acc += rgb.reshape(len(ys), len(xs), 3)
        return sml(acc / spp)

    base = lens.film_dist
    for zi, zone in enumerate(lens.af_zones):
        # coarse hill climb over film distance (reference climbs with
        # shrinking steps; we scan a bracket then parabola-fit in log F)
        cands = base * np.asarray([0.85, 0.925, 1.0, 1.075, 1.15])
        scores = [zone_sharpness(zone, float(fd)) for fd in cands]
        k = int(np.argmax(scores))
        # refine around the best
        lo = cands[max(0, k - 1)]
        hi = cands[min(len(cands) - 1, k + 1)]
        cands2 = np.linspace(lo, hi, 5)
        scores2 = [zone_sharpness(zone, float(fd)) for fd in cands2]
        k2 = int(np.argmax(scores2))
        # log-parabola peak interpolation (reference :415-423)
        if 0 < k2 < len(cands2) - 1:
            f0, f1, f2 = (np.log(max(scores2[k2 - 1], 1e-12)),
                          np.log(max(scores2[k2], 1e-12)),
                          np.log(max(scores2[k2 + 1], 1e-12)))
            denom = f0 - 2 * f1 + f2
            off = 0.5 * (f0 - f2) / denom if abs(denom) > 1e-12 else 0.0
            step = cands2[1] - cands2[0]
            best = cands2[k2] + np.clip(off, -1, 1) * step
        else:
            best = cands2[k2]
        info(f"autofocus zone {zi}: film distance {base:.3f} -> {best:.3f}")
        lens.film_dist = float(best)
