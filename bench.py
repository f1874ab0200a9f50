"""Benchmark: ray-cast + path-trace throughput on a mesh-heavy scene (GPU).

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.

Workload: ~135k-triangle tessellated mesh over a ground plane at
1024x1024, traced through the packet pipeline (accel/wide_bvh.py +
ops/bvh_pallas.py: coherence sort, culling, Pallas Moller-Trumbore
leaf sweep).

Headline metric: camera-ray casts/second through the accelerated
t-pass — the reference's hottest loop (accelerators/bvh.cpp:585-687).
The reference publishes no numbers (BASELINE.md). Refuses to run
without a GPU. The JSON "extra" carries:
- path_cam_rays_per_s: full path trace, depth 5, 1024^2
- grad_rays_per_s: BACKWARD pass — jax.grad of the same 1024^2 path
  trace w.r.t. the per-material albedo scale (BASELINE.json's
  "grad-rays/s/chip (bwd) at 1024^2" metric), run in 4 tiles
- photons_per_s / photon-map build+march metrics for the signature
  photon-volume pipeline
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RES = 1024
DEPTH = 5


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp

    from scripts.bench_scene import make_bench_scene, camera_rays
    from pbrt_tpu.compile_cache import enable_compile_cache
    from pbrt_tpu.core.geometry import Ray
    from pbrt_tpu.integrators.surface import li_path

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    scene = make_bench_scene()
    n = RES * RES
    ray = camera_rays(RES)
    pixel = jnp.arange(n, dtype=jnp.int32)
    sidx = jnp.zeros(n, jnp.int32)

    @jax.jit
    def tpass(o, d):
        # camera beams carry the coherent hint, as the render driver does
        r = Ray(o, d, jnp.zeros(n), jnp.full((n,), jnp.inf), jnp.zeros(n))
        t, prim = scene.accel._t_pass(r, coherent=True)
        return t, prim

    @jax.jit
    def forward(o, d):
        r = Ray(o, d, jnp.zeros(n), jnp.full((n,), jnp.inf), jnp.zeros(n))
        return li_path(scene, r, pixel, sidx, max_depth=DEPTH, seed=0)

    # --- hot-path ray-cast throughput (the headline) ---
    t, prim = tpass(ray.o, ray.d)
    t.block_until_ready()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        t, prim = tpass(ray.o, ray.d)
    t.block_until_ready()
    cast_dt = (time.perf_counter() - t0) / iters
    cast_rays_per_s = n / cast_dt

    # --- shadow-ray (any-hit early-out) throughput: rays from the
    # primary hit points toward a light — the estimate_direct workload
    hit_p = ray.o + jnp.where(jnp.isfinite(t), t, 0.0)[:, None] * ray.d
    lpos = jnp.asarray([0.0, 6.0, 0.0])
    sd = lpos[None, :] - hit_p
    sdist = jnp.sqrt(jnp.sum(sd * sd, -1))
    sdir = sd / jnp.maximum(sdist, 1e-9)[:, None]
    s_tmax = jnp.where(prim >= 0, sdist * 0.999, -1.0)

    @jax.jit
    def shadow(o, d, tmax):
        r = Ray(o + d * 1e-3, d, jnp.zeros(n), tmax, jnp.zeros(n))
        return scene.accel._t_pass(r, any_hit=True, coherent=True)[1] >= 0

    occ = shadow(hit_p, sdir, s_tmax)
    occ.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        occ = shadow(hit_p, sdir, s_tmax)
    occ.block_until_ready()
    shadow_dt = (time.perf_counter() - t0) / iters

    # --- incoherent-ray throughput: scrambled origins/directions (the
    # worst case for the packet sort/cull; honest secondary-bounce cost)
    import numpy as _np

    rng = _np.random.RandomState(0)
    lo = _np.asarray(scene.world_lo)
    hi = _np.asarray(scene.world_hi)
    io_ = jnp.asarray(rng.uniform(lo, hi, (n, 3)).astype(_np.float32))
    dirs = rng.normal(size=(n, 3)).astype(_np.float32)
    dirs /= _np.linalg.norm(dirs, axis=-1, keepdims=True)
    id_ = jnp.asarray(dirs)

    @jax.jit
    def tpass_inc(o, d):
        # no coherent hint: the per-ray slab cull path secondary
        # bounces take
        r = Ray(o, d, jnp.zeros(n), jnp.full((n,), jnp.inf), jnp.zeros(n))
        return scene.accel._t_pass(r)

    ti, pi_ = tpass_inc(io_, id_)
    ti.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        ti, pi_ = tpass_inc(io_, id_)
    ti.block_until_ready()
    incoh_dt = (time.perf_counter() - t0) / iters

    # --- full render throughput (path tracer, depth 5) ---
    out = forward(ray.o, ray.d)
    out.block_until_ready()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        out = forward(ray.o, ray.d)
    out.block_until_ready()
    path_dt = (time.perf_counter() - t0) / iters
    cam_rays_per_s = n / path_dt

    # --- BACKWARD throughput: grad of the 1024^2 path trace w.r.t. the
    # per-material albedo scale, tiled 4x (the tape for 1M rays x depth
    # 5 does not fit device memory; tiling accumulates the same total
    # gradient)
    from pbrt_tpu.diff import DiffParams, apply_params

    M = len(scene.materials)
    SB = 30
    TIL = 4
    nt = n // TIL

    @jax.jit
    def gstep(s, o, d, pix):
        def loss(s):
            sc = apply_params(scene, DiffParams(kd_scale=s))
            r = Ray(o, d, jnp.zeros(nt), jnp.full((nt,), jnp.inf),
                    jnp.zeros(nt))
            return jnp.mean(li_path(sc, r, pix, jnp.zeros(nt, jnp.int32),
                                    max_depth=DEPTH, seed=0))
        return jax.grad(loss)(s)

    s0 = jnp.ones((M, SB), jnp.float32)
    g = None
    for ti in range(TIL):
        sl = slice(ti * nt, (ti + 1) * nt)
        gt = gstep(s0, ray.o[sl], ray.d[sl], pixel[sl])
        g = gt if g is None else g + gt
    g.block_until_ready()
    t0 = time.perf_counter()
    for ti in range(TIL):
        sl = slice(ti * nt, (ti + 1) * nt)
        g = gstep(s0, ray.o[sl], ray.d[sl], pixel[sl])
    g.block_until_ready()
    grad_dt = time.perf_counter() - t0
    assert bool(jnp.all(jnp.isfinite(g)))
    grad_rays_per_s = n / grad_dt

    # --- photon pipeline: shooting, kNN lookups, photonvolume march ---
    photon_stats = bench_photon_pipeline()

    print(json.dumps({
        "metric": "bvh_ray_casts_per_s",
        "value": round(cast_rays_per_s, 1),
        "unit": "rays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            "scene_tris": int(scene.geom.n_tris),
            "resolution": RES,
            "path_depth": DEPTH,
            "path_cam_rays_per_s": round(cam_rays_per_s, 1),
            "grad_rays_per_s": round(grad_rays_per_s, 1),
            "tpass_ms": round(cast_dt * 1e3, 1),
            "render_ms": round(path_dt * 1e3, 1),
            "hit_frac": round(float((prim >= 0).mean()), 4),
            "shadow_rays_per_s": round(n / shadow_dt, 1),
            "incoherent_rays_per_s": round(n / incoh_dt, 1),
            **photon_stats,
        },
    }))


def bench_photon_pipeline():
    """Photon-volume pipeline throughput. Three legs on a scattering
    homogeneous cube + point light (pinkfloyd's structure, reduced):
    - photons_per_s: wavefront shooting, depth 5, Woodcock media
    - knn_lookups_per_s: fused blocked kNN at pinkfloyd's nused=500
      against a 1M-photon map
    - march_samples_per_s: the photonvolume eye march (shadow +
      transmittance + kNN per step), 128^2 rays x 64 steps
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.core.geometry import Ray
    from pbrt_tpu.photon.map import build_photon_map, knn_weighted_flux
    from pbrt_tpu.photon.shooter import PhotonCtx, _shoot_batch_fn
    from pbrt_tpu.scene import api
    from pbrt_tpu.scene.paramset import ParamSet
    from pbrt_tpu.scene.compile import compile_scene
    from pbrt_tpu.integrators.photonvolume import li_photonvolume

    api._state.__init__()
    api.pbrt_init({"quiet": True})
    api.pbrt_look_at([0, 0.5, -4], [0, 0, 0], [0, 1, 0])
    cam = ParamSet()
    cam.add("float", "fov", [45.0])
    api.pbrt_camera("perspective", cam)
    api.pbrt_world_begin()
    lp = ParamSet()
    lp.add("point", "from", [0.0, 2.5, 0.0])
    lp.add("rgb", "I", [30.0, 30.0, 30.0])
    api.pbrt_light_source("point", lp)
    vp = ParamSet()
    vp.add("point", "p0", [-1.5, -1.2, -1.5])
    vp.add("point", "p1", [1.5, 1.8, 1.5])
    vp.add("rgb", "sigma_a", [0.05, 0.05, 0.05])
    vp.add("rgb", "sigma_s", [0.9, 0.9, 0.9])
    api.pbrt_volume("homogeneous", vp)
    scene = compile_scene(api.get_state().render_options)
    api._state.__init__()

    # --- shooting throughput
    B = 32768
    batch_fn = _shoot_batch_fn(scene, 5, True)
    lane = jnp.arange(B, dtype=jnp.int32)

    def shoot(shot0):
        return batch_fn(lane, jnp.full((B,), shot0, jnp.int32), 0)

    recs = shoot(0)
    recs[0].block_until_ready()
    t0 = time.perf_counter()
    iters = 4
    for i in range(iters):
        recs = shoot(i * B)
        pos = np.asarray(recs[0]).reshape(-1, 3)
    al = np.asarray(recs[1]).reshape(-1, 30)
    wi = np.asarray(recs[2]).reshape(-1, 3)
    cls = np.asarray(recs[3]).reshape(-1)
    shoot_dt = (time.perf_counter() - t0) / iters
    photons_per_s = B / shoot_dt

    # --- kNN throughput at pinkfloyd's nused=500 on a 1M-photon map
    rng = np.random.RandomState(0)
    P = 1_000_000
    ppos = rng.normal(0.0, 0.6, (P, 3)).astype(np.float32)
    palpha = rng.rand(P, 30).astype(np.float32) * 1e-6
    pwi = rng.normal(size=(P, 3)).astype(np.float32)
    pwi /= np.linalg.norm(pwi, axis=-1, keepdims=True)
    t0 = time.perf_counter()
    pm = build_photon_map(ppos, palpha, pwi, cell_size=0.05, target_k=500)
    build_dt = time.perf_counter() - t0
    Q = 65536
    q = jnp.asarray(rng.normal(0.0, 0.5, (Q, 3)).astype(np.float32))

    @jax.jit
    def lookup(q):
        res = knn_weighted_flux(
            pm, q, 500, 0.16,
            lambda wx, wy, wz, d2, valid, r2: jnp.ones_like(d2))
        return res.flux.sum()

    lookup(q).block_until_ready()
    t0 = time.perf_counter()
    lookup(q).block_until_ready()
    knn_dt = time.perf_counter() - t0
    knn_lookups_per_s = Q / knn_dt

    # --- photonvolume march throughput with a real shot map
    m = (al.sum(-1) > 0) & (cls == 4)
    vol_map = build_photon_map(pos[m], al[m] / (iters * B), wi[m],
                               cell_size=0.35, target_k=100)
    ctx = PhotonCtx(
        caustic=None, indirect=None, volume=vol_map, direct=None,
        radiance=None, n_caustic_paths=1, n_indirect_paths=1,
        n_volume_paths=iters * B, n_used=50, max_dist2=0.01,
        vol_n_used=100, vol_max_dist2=0.35 * 0.35, final_gather=False,
        gather_samples=1, cos_gather_angle=0.98, max_specular_depth=5,
        max_photon_depth=5)
    R = 128 * 128
    side = 128
    xs = np.linspace(-0.4, 0.4, side, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    d = np.stack([gx.ravel(), gy.ravel(), np.ones(R, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.5, -4.0]], np.float32), (R, 1))
    mray = Ray(jnp.asarray(o), jnp.asarray(d), jnp.zeros(R),
               jnp.full((R,), jnp.inf), jnp.zeros(R))
    mpix = jnp.arange(R, dtype=jnp.int32)
    msi = jnp.zeros(R, jnp.int32)
    N_STEPS = 64

    @jax.jit
    def march():
        vr = li_photonvolume(scene, ctx, mray, jnp.full((R,), jnp.inf),
                             mpix, msi, n_steps=N_STEPS, seed=0)
        return vr.L.sum()

    march().block_until_ready()
    t0 = time.perf_counter()
    march().block_until_ready()
    march_dt = time.perf_counter() - t0

    return {
        "photons_per_s": round(photons_per_s, 1),
        "knn_lookups_per_s": round(knn_lookups_per_s, 1),
        "knn_nused": 500,
        "map_build_1m_s": round(build_dt, 2),
        "march_samples_per_s": round(R * N_STEPS / march_dt, 1),
        "march_ms_128sq_64steps": round(march_dt * 1e3, 1),
        "vol_map_photons": int(vol_map.count) if vol_map else 0,
    }


if __name__ == "__main__":
    main()
