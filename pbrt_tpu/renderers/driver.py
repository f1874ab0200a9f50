"""Render driver: the SamplerRenderer analog.

Replaces reference renderers/samplerrenderer.cpp:190-249 and the
MakeRenderer dispatch (core/api.cpp:1221-1288). Instead of a task pool
over 16x16 pixel windows, the image is cut into fixed-size wavefront
tiles of camera samples; each tile runs one jitted megakernel
(camera raygen -> surface Li -> volume Li -> filtered film deposit)
and tiles stream on the host. Under a device mesh the tile axis is
sharded with jax.sharding (pbrt_tpu.parallel).
"""
from __future__ import annotations

import math
import time as _time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core import probes, spectrum as spec
from pbrt_tpu.core.error import info, progress, warning
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.accel.intersect import intersect
from pbrt_tpu.cameras.cameras import make_camera
from pbrt_tpu.film import film as film_mod
from pbrt_tpu.integrators import surface as surf_int
from pbrt_tpu.integrators import volume as vol_int
from pbrt_tpu.samplers.samplers import camera_samples, make_sampler
from pbrt_tpu.scene.compile import CompiledScene, compile_scene
from pbrt_tpu.scene.records import RenderOptions

S = spec.N_BINS
BIG = 1e30


def render_scene(ro: RenderOptions, options: Optional[dict] = None):
    """Parse-complete hook: compile the scene and dispatch by renderer
    (reference pbrtWorldEnd -> MakeRenderer -> Render)."""
    options = dict(options or {})
    scene = compile_scene(ro)

    filter_spec = film_mod.make_filter(ro.filter_name, ro.filter_params)
    film = film_mod.make_film(ro.film_name, ro.film_params, filter_spec, options)

    from pbrt_tpu.core.transform import Transform

    cam_to_world = ro.camera_to_world or Transform()
    camera = make_camera(ro.camera_name, ro.camera_params, cam_to_world,
                         film.xres, film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, options)

    name = ro.renderer_name
    if name == "metropolis":
        from pbrt_tpu.renderers.metropolis import render_metropolis

        return render_metropolis(scene, ro, film, camera, options)
    if name == "aggregatetest":
        from pbrt_tpu.renderers.aggregatetest import run_aggregate_test

        return run_aggregate_test(scene, ro, options)
    if name == "surfacepoints":
        from pbrt_tpu.renderers.surfacepoints import render_surface_points

        return render_surface_points(scene, ro, camera, options)
    if name == "createprobes":
        from pbrt_tpu.renderers.createprobes import render_create_probes

        return render_create_probes(scene, ro, options)
    if name != "sampler":
        warning(f'Renderer "{name}" unknown; using "sampler".')
    return render_sampler(scene, ro, film, camera, sampler, options)


def _make_transmittance_fn(scene: CompiledScene, n_steps: int):
    if scene.volume is None:
        return None

    def fn(p, wi, dist):
        # offset jitter from a position hash: deterministic per shading
        # point, decorrelated across points (reference uses the camera
        # sample's 1D slot; we have no sample stream here, so hash p).
        import jax

        bits = jax.lax.bitcast_convert_type(
            jnp.asarray(p, jnp.float32) * 4096.0, jnp.uint32)
        h = bits[:, 0] * jnp.uint32(0x9E3779B9)
        h ^= bits[:, 1] * jnp.uint32(0x85EBCA6B)
        h ^= bits[:, 2] * jnp.uint32(0xC2B2AE35)
        h ^= h >> 16
        h *= jnp.uint32(0x7FEB352D)
        h ^= h >> 15
        u = (h >> 8).astype(jnp.float32) * (1.0 / 16777216.0)
        return vol_int.transmittance(scene.volume, p, wi, dist, n_steps, u)

    return fn


def build_li_fn(scene: CompiledScene, ro: RenderOptions, options: dict):
    """Compose surface + volume Li into one wavefront radiance fn
    (reference samplerrenderer.cpp:228-249 SamplerRenderer::Li:
    return *T * Li_surface + Li_volume)."""
    sname = ro.surf_integrator_name
    sp = ro.surf_integrator_params
    vname = ro.vol_integrator_name
    vp = ro.vol_integrator_params
    quick = bool(options.get("quick"))

    max_depth = sp.find_one_int("maxdepth", 5)
    step_size = vp.find_one_float("stepsize", 1.0)
    n_steps = 16
    if scene.volume is not None:
        n_steps = vol_int.pick_n_steps(scene.volume, step_size,
                                       cap=32 if quick else 128)
    trans_steps = max(4, n_steps // 2)
    trans_fn = _make_transmittance_fn(scene, trans_steps)

    photon_ctx = None
    if sname in ("photonmap", "exphotonmap") or vname == "photonvolume":
        from pbrt_tpu.photon.shooter import build_photon_maps

        photon_ctx = build_photon_maps(scene, sp, vp, options)

    # The photon maps enter render_tile as jit ARGUMENTS, not closure
    # constants: closure constants are embedded in the executable, and a
    # full 5M-photon pinkfloyd map (~700 MB of pxyz/alpha_t/wixyz) would
    # bloat every compiled program and compile-cache entry. Static fields
    # (dims, count, n_used, ...) stay in the closed-over ctx;
    # `ctx_box[0]` is rebound to the traced rebuild at trace time so the
    # li functions below see the argument arrays.
    _MAP_FIELDS = ("caustic", "indirect", "volume", "direct", "radiance")
    ctx_box = [photon_ctx]

    def _ctx_heavy_arrays(ctx):
        out = {}
        if ctx is None:
            return out
        for f in _MAP_FIELDS:
            m = getattr(ctx, f)
            if m is None:
                continue
            out[f] = {k: v for k, v in m._asdict().items()
                      if isinstance(v, jnp.ndarray)}
        return out

    def _ctx_rebind(ctx, arrays):
        if ctx is None or not arrays:
            return ctx
        import dataclasses as _dc

        reps = {f: getattr(ctx, f)._replace(**d) for f, d in arrays.items()}
        return _dc.replace(ctx, **reps)

    vpls = None
    if sname == "igi":
        from pbrt_tpu.integrators.extra import generate_vpls

        n_sets = sp.find_one_int("nsets", 4)
        n_lights_igi = sp.find_one_int("nlights", 64)
        if quick:
            n_lights_igi = max(4, n_lights_igi // 8)
        vpls = generate_vpls(scene, n_sets, max(1, n_lights_igi // 4),
                             sp.find_one_int("maxdepth", 5),
                             int(options.get("seed", 0)))

    sss_ctx = None
    if sname == "dipolesubsurface":
        from pbrt_tpu.integrators.extra import (
            SurfacePoints,
            compute_point_irradiance,
        )
        from pbrt_tpu.renderers.surfacepoints import generate_surface_points

        mind = sp.find_one_float("minsampledistance", 0.25)
        pfile = sp.find_one_string("pointsfile", "")
        if pfile:
            import numpy as _np

            z = _np.load(pfile)
            p_, n_, a_ = z["p"], z["n"], z["area"]
        else:
            p_, n_, a_ = generate_surface_points(scene, mind,
                                                 int(options.get("seed", 0)))
        pts = SurfacePoints(p=jnp.asarray(p_), n=jnp.asarray(n_),
                            area=jnp.asarray(a_),
                            E=jnp.zeros((len(p_), S), jnp.float32))
        sss_ctx = compute_point_irradiance(scene, pts,
                                           int(options.get("seed", 0)))

    probe_grid = None
    if sname == "useprobes":
        from pbrt_tpu.renderers.createprobes import load_probes

        pfn = sp.find_one_string("filename", "probes.npz")
        try:
            probe_grid = load_probes(pfn)
        except OSError as e:
            warning(f"useprobes: cannot load {pfn}: {e}")

    def surface_li(ray, pixel, sidx, seed):
        if sname in ("photonmap", "exphotonmap"):
            from pbrt_tpu.integrators.photonmap import li_photonmap

            return li_photonmap(scene, ctx_box[0], ray, pixel, sidx,
                                max_depth=max_depth, seed=seed,
                                transmittance_fn=trans_fn)
        if sname == "directlighting":
            strategy = sp.find_one_string("strategy", "all")
            return surf_int.li_direct(scene, ray, pixel, sidx, max_depth=max_depth,
                                      seed=seed, strategy=strategy,
                                      transmittance_fn=trans_fn)
        if sname == "whitted":
            return surf_int.li_whitted(scene, ray, pixel, sidx, max_depth=max_depth,
                                       seed=seed, transmittance_fn=trans_fn)
        if sname == "ambientocclusion":
            ns = sp.find_one_int("nsamples", 2048 if not quick else 16)
            md = sp.find_one_float("maxdist", BIG)
            return surf_int.li_ao(scene, ray, pixel, sidx,
                                  n_samples=min(ns, 64), max_dist=md, seed=seed)
        if sname == "igi":
            from pbrt_tpu.integrators.extra import li_igi

            return li_igi(scene, vpls, ray, pixel, sidx, max_depth=max_depth,
                          g_limit=sp.find_one_float("glimit", 10.0),
                          seed=seed, transmittance_fn=trans_fn)
        if sname == "irradiancecache":
            from pbrt_tpu.integrators.extra import li_irradiance

            ns = sp.find_one_int("nsamples", 4096)
            return li_irradiance(scene, ray, pixel, sidx,
                                 n_samples=min(max(ns // 256, 4), 32),
                                 seed=seed, transmittance_fn=trans_fn)
        if sname == "dipolesubsurface":
            from pbrt_tpu.integrators.extra import li_dipole

            import numpy as _np

            sig_a = spec.from_rgb(_np.asarray([0.0011, 0.0024, 0.014], _np.float32))
            sig_ps = spec.from_rgb(_np.asarray([2.55, 3.21, 3.77], _np.float32))
            for m in scene.materials:
                if m.kind in ("subsurface", "kdsubsurface") and "sigma_a" in m.spectra:
                    sig_a = m.spectra["sigma_a"]
                    sig_ps = m.spectra["sigma_prime_s"]
                    break
            return li_dipole(scene, sss_ctx, ray, pixel, sidx,
                             sigma_a=sig_a, sigma_ps=sig_ps,
                             scale=sp.find_one_float("scale", 1.0),
                             seed=seed, transmittance_fn=trans_fn)
        if sname == "diffuseprt":
            from pbrt_tpu.integrators.extra import li_diffuseprt

            return li_diffuseprt(
                scene, ray, pixel, sidx,
                lmax=sp.find_one_int("lmax", 4),
                # honor the scene's nsamples (reference diffuseprt.cpp
                # default 4096), capped: the wavefront re-evaluates the
                # transfer per camera sample
                n_samples=8 if quick else min(
                    64, max(16, sp.find_one_int("nsamples", 4096) // 64)),
                seed=seed)
        if sname == "glossyprt":
            from pbrt_tpu.integrators.extra import li_glossyprt

            return li_glossyprt(scene, ray, pixel, sidx,
                                lmax=sp.find_one_int("lmax", 4),
                                roughness=sp.find_one_float("roughness", 0.1),
                                seed=seed)
        if sname == "useprobes":
            from pbrt_tpu.integrators.extra import li_useprobes

            return li_useprobes(scene, probe_grid, ray, pixel, sidx, seed=seed)
        if sname != "path":
            warning(f'SurfaceIntegrator "{sname}" not implemented; using "path".')
        return surf_int.li_path(scene, ray, pixel, sidx, max_depth=max_depth,
                                seed=seed, transmittance_fn=trans_fn)

    def volume_li(ray, t_surf, pixel, sidx, seed):
        N = ray.o.shape[0]
        if scene.volume is None or vname == "none":
            return vol_int.VolResult(L=jnp.zeros((N, S), jnp.float32),
                                     Tr=jnp.ones((N, S), jnp.float32))
        if vname == "emission":
            return vol_int.li_emission(scene.volume, ray, t_surf, pixel, sidx,
                                       n_steps, seed)
        if vname == "photonvolume":
            from pbrt_tpu.integrators.photonvolume import li_photonvolume

            return li_photonvolume(scene, ctx_box[0], ray, t_surf, pixel, sidx,
                                   n_steps, seed)
        if vname != "single":
            warning(f'VolumeIntegrator "{vname}" not implemented; using "single".')
        return vol_int.li_single(scene, ray, t_surf, pixel, sidx, n_steps, seed)

    def li(ray: Ray, pixel, sidx, seed: int):
        L_surf = surface_li(ray, pixel, sidx, seed)
        if scene.volume is None:
            return L_surf
        hit_t, _prim = _first_hit_t(scene, ray)
        vr = volume_li(ray, hit_t, pixel, sidx, seed)
        return vr.Tr * L_surf + vr.L

    # plumbing for render_sampler: the heavy photon-map arrays must be
    # jit ARGUMENTS of render_tile (see comment above); rebind_ctx is
    # called at trace time so surface_li/volume_li read the traced maps
    li.ctx_heavy = _ctx_heavy_arrays(photon_ctx)
    li.rebind_ctx = (lambda arrays:
                     ctx_box.__setitem__(0, _ctx_rebind(photon_ctx, arrays)))
    return li


def _first_hit_t(scene: CompiledScene, ray: Ray):
    hit = scene.intersect(ray, coherent=True)
    return jnp.where(hit.valid, hit.t, jnp.full_like(hit.t, BIG)), hit.prim


def render_sampler(scene: CompiledScene, ro: RenderOptions, film, camera,
                   sampler, options: dict):
    """The tile-streaming render loop."""
    li_fn = build_li_fn(scene, ro, options)
    seed = int(options.get("seed", 0))
    spp = sampler.spp

    # autofocus hook (reference samplerrenderer.cpp:202 camera->AutoFocus)
    from pbrt_tpu.cameras.cameras import CAM_REALISTIC

    if camera.kind == CAM_REALISTIC and camera.lens.af_zones:
        from pbrt_tpu.cameras.realistic import autofocus

        autofocus(scene, camera, film, li_fn, seed=seed,
                  spp=4 if options.get("quick") else 16)

    # Wavefront tile: cap the per-launch sample count to bound memory.
    # Photon integrators carry ~100x a path tracer's per-lane state
    # (kNN candidate buffers, march loops with embedded lookups), so
    # their default tile is 4x smaller; override with --tile-samples.
    photon_active = (ro.surf_integrator_name in ("photonmap", "exphotonmap")
                     or ro.vol_integrator_name == "photonvolume")
    default_tile = 1 << 14 if photon_active else 1 << 16
    tile_samples = int(options.get("tile_samples") or default_tile)
    pix_per_tile = max(1, tile_samples // spp)

    # Device mesh: shard the tile's pixel axis; scene tensors replicate,
    # the film accumulator stays replicated (XLA inserts the psum for the
    # scatter-adds) — the pthread-pool analog per SURVEY.md section 2.4.
    from pbrt_tpu.parallel import mesh as pmesh

    mesh = pmesh.mesh_from_options(options)
    sharding = None
    if mesh is not None:
        n_dev = mesh.devices.size
        sharding = pmesh.batch_sharding(mesh)
        pix_per_tile = max(n_dev, (pix_per_tile // n_dev) * n_dev)
        info(f"sharding render tiles over {n_dev} devices")
    n_pix = film.nx * film.ny
    n_tiles = (n_pix + pix_per_tile - 1) // pix_per_tile

    from pbrt_tpu.samplers.samplers import (
        S_ADAPTIVE,
        adaptive_needs,
        adaptive_needs_shapeid,
    )
    from pbrt_tpu.core import spectrum as _spec
    import dataclasses as _dc

    ctx_heavy = getattr(li_fn, "ctx_heavy", {})

    @jax.jit
    def render_tile(pix_ids, state_xyz, state_w, ctx_arrays):
        li_fn.rebind_ctx(ctx_arrays)
        pix_x = (pix_ids % film.nx) + film.x0
        pix_y = (pix_ids // film.nx) + film.y0
        st = film_mod.FilmState(xyz=state_xyz, weight=state_w,
                                splat=jnp.zeros((1, 1, 3), jnp.float32))
        if sampler.kind == S_ADAPTIVE:
            # reference samplers/adaptive.cpp:182-185 ReportResults veto:
            # minsamples first; pixels failing the contrast test discard
            # those samples and re-render at maxsamples
            spec_min = _dc.replace(sampler, spp=max(1, sampler.adaptive_min))
            spp_min = spec_min.spp
            cs1 = camera_samples(spec_min, pix_x, pix_y, film.xres, seed)
            ray1, rw1 = camera.generate_rays(cs1.px, cs1.py, cs1.u_lens1,
                                             cs1.u_lens2, cs1.u_time)
            sidx1 = jnp.tile(jnp.arange(spp_min, dtype=jnp.int32),
                             pix_ids.shape[0])
            L1 = li_fn(ray1, cs1.pixel, sidx1, seed)
            L1 = jnp.nan_to_num(L1, nan=0.0, posinf=0.0, neginf=0.0)
            if sampler.adaptive_method == "shapeid":
                # geometric-discontinuity veto (adaptive.cpp:182-185):
                # supersample pixels whose samples hit different prims
                _t1, prim1 = _first_hit_t(scene, ray1)
                needs = adaptive_needs_shapeid(prim1, pix_ids.shape[0],
                                               spp_min)
            else:
                needs = adaptive_needs(_spec.y(L1), pix_ids.shape[0],
                                       spp_min)
            # supersample pass: lanes of passing pixels get an empty ray
            # interval (near-free in the packet pipeline) + zero weight
            cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed + 1)
            ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1,
                                           cs.u_lens2, cs.u_time)
            needs_r = jnp.repeat(needs, spp)
            from pbrt_tpu.core.geometry import Ray as _Ray
            ray = _Ray(ray.o, ray.d, ray.tmin,
                       jnp.where(needs_r, ray.tmax, -1.0), ray.time)
            sidx = jnp.tile(jnp.arange(spp, dtype=jnp.int32),
                            pix_ids.shape[0])
            L = li_fn(ray, cs.pixel, sidx, seed)
            L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
            st = film_mod.add_samples(
                film, st, cs1.px, cs1.py, L1,
                rw1 * ~jnp.repeat(needs, spp_min))
            st = film_mod.add_samples(film, st, cs.px, cs.py, L,
                                      rw * needs_r)
            return st.xyz, st.weight
        cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed)
        ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
        sidx = jnp.tile(jnp.arange(spp, dtype=jnp.int32), pix_ids.shape[0])
        L = li_fn(ray, cs.pixel, sidx, seed)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)  # reference
        # samplerrenderer.cpp:119-133 black-pixel fallback for NaN/inf
        st = film_mod.add_samples(film, st, cs.px, cs.py, L, rw)
        return st.xyz, st.weight

    # checkpoint/resume of the film accumulator (the reference has no
    # checkpointing, SURVEY.md section 5; the film + photon maps are the
    # natural persistent state)
    ckpt_path = options.get("checkpoint")
    ckpt_every = int(options.get("checkpoint_every", 64))
    start_tile = 0
    state = film_mod.init_state(film)
    xyz, w = state.xyz, state.weight
    if ckpt_path:
        import os as _os

        if _os.path.exists(ckpt_path):
            z = np.load(ckpt_path)
            if (tuple(z["shape"]) == (film.ny, film.nx)
                    and int(z["spp"]) == spp and int(z["seed"]) == seed):
                xyz = jnp.asarray(z["xyz"])
                w = jnp.asarray(z["weight"])
                start_tile = int(z["tile"])
                info(f"resuming render from checkpoint tile {start_tile}/{n_tiles}")
            else:
                warning("checkpoint incompatible with this render; ignoring")
    if mesh is not None:
        # the film comes back replicated from every tile; start it so,
        # or the first tile compiles a second program
        xyz, w = pmesh.replicate(mesh, (xyz, w))
    t_start = _time.time()
    all_ids = np.arange(n_pix, dtype=np.int32)
    for ti in range(start_tile, n_tiles):
        ids = all_ids[ti * pix_per_tile: (ti + 1) * pix_per_tile]
        if len(ids) < pix_per_tile:  # pad to keep one compiled shape
            ids = np.concatenate([ids, np.full(pix_per_tile - len(ids), ids[-1] if len(ids) else 0, np.int32)])
            # duplicate deposits on the padded pixel are normalized out by
            # the matching weight accumulation
        if mesh is not None:
            # multiprocess-correct shard (each process contributes its
            # addressable shards of the identical host batch)
            ids_dev = pmesh.shard_batch(mesh, ids)
        else:
            ids_dev = jnp.asarray(ids)
        prev_w = w
        xyz, w = render_tile(ids_dev, xyz, w, ctx_heavy)
        # double-buffer: bound in-flight tiles to 2 so the progress bar
        # tracks real device time (unbounded async dispatch "finishes"
        # every tile instantly and hides a stall until the final fetch)
        if ti > start_tile:
            prev_w.block_until_ready()
        probes.count("render/tiles")
        probes.count("render/camera_samples",
                     min(pix_per_tile, n_pix - ti * pix_per_tile) * spp)
        if ckpt_path and (ti + 1) % ckpt_every == 0 and ti + 1 < n_tiles:
            cx, cw = ((xyz, w) if mesh is None
                      else pmesh.gather_replicated(mesh, (xyz, w)))
            np.savez(ckpt_path, xyz=np.asarray(cx), weight=np.asarray(cw),
                     tile=ti + 1, shape=(film.ny, film.nx), spp=spp, seed=seed)
        progress("Rendering", ti + 1, n_tiles, t_start)
    if mesh is not None:
        # replicate the film before the host fetch (multi-host: every
        # process ends with the full image, the psum-merge analog of
        # the reference's film atomics, SURVEY.md §2.4)
        xyz, w = pmesh.gather_replicated(mesh, (xyz, w))
    state = film_mod.FilmState(xyz=xyz, weight=w, splat=state.splat)

    rgb = film_mod.write_image(film, state) if options.get("write", True) else film_mod.to_rgb(film, state)
    info(f"render finished in {_time.time() - t_start:.2f}s "
         f"({n_pix * spp / max(_time.time() - t_start, 1e-9):.0f} samples/s)")
    return rgb
