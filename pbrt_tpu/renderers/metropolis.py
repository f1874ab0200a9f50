"""Metropolis light transport (Kelemen primary-sample-space MLT).

Replaces reference renderers/metropolis.cpp (808 LoC): MLTSample with
camera+light streams (:53-77), LargeStep/SmallStep mutations with
exponentially-distributed jitter (:79-198), bootstrap to estimate the
normalization b, and film Splat accumulation.

Wavefront re-design: instead of nTasks independent serial chains, we run a
WAVEFRONT of W chains in lockstep. Each chain's state is its
primary-sample vector u in [0,1)^D (D = dims consumed by a path of
maxdepth bounces). One jitted step mutates all chains, evaluates the
path contribution with the wavefront path integrator, applies the
Metropolis accept/reject, and splats both candidate and current states
with their expected-value weights (Veach-style). Determinism: threefry
keys; film deposits are scatter-adds.
"""
from __future__ import annotations

import time as _time

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.error import info, progress
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.film import film as film_mod

S = spec.N_BINS


def render_metropolis(scene, ro, film, camera, options=None):
    """reference metropolis.cpp Render: bootstrap -> chains -> splat.

    Supports the reference's bidirectional option (default true,
    metropolis.cpp:521) via integrators/bidir.py and the separate
    direct-lighting pre-pass (dodirectseparately, :518): direct light
    is rendered with `directsamples` LD samples through the film's
    AddSample path while the chains splat only the remaining transport.
    maxconsecutiverejects is accepted but unused — lockstep chains with
    expected-value splatting cannot wedge the way serial chains do.
    """
    options = options or {}
    p = ro.renderer_params
    quick = bool(options.get("quick"))
    spp = p.find_one_int("samplesperpixel", 100)
    n_bootstrap = p.find_one_int("bootstrapsamples", 100000)
    largestep_prob = p.find_one_float("largestepprobability", 0.25)
    max_depth = p.find_one_int("maxdepth", 7)
    bidirectional = p.find_one_bool("bidirectional", True)
    do_direct = p.find_one_bool("dodirectseparately", True)
    n_direct = p.find_one_int("directsamples", 4)
    p.find_one_int("maxconsecutiverejects", 512)
    if quick:
        spp = max(1, spp // 10)
        n_bootstrap = max(4096, n_bootstrap // 10)
        n_direct = max(1, n_direct // 4)
    p.report_unused('in renderer "metropolis"')

    sp = ro.surf_integrator_params
    max_depth = sp.find_one_int("maxdepth", max_depth)

    from pbrt_tpu.integrators.bidir import n_psample_dims, path_l_psamples

    skip_direct = bool(do_direct and scene.lights is not None)

    def path_l(u):
        return path_l_psamples(scene, camera, film, u, max_depth,
                               bidirectional=bidirectional,
                               skip_direct=skip_direct)

    W = 4096  # chains in flight
    D = n_psample_dims(max_depth, bidirectional)
    n_pix = film.nx * film.ny
    total_mutations = n_pix * spp
    n_steps = max(1, total_mutations // W)
    seed = int(options.get("seed", 0))
    key = jax.random.PRNGKey(seed)

    # --- separate direct-lighting pass (reference metropolis.cpp:532-545
    # embedded DirectLightingIntegrator rendered at directsamples spp)
    direct_xyz = jnp.zeros((film.ny, film.nx, 3), jnp.float32)
    direct_w = jnp.zeros((film.ny, film.nx), jnp.float32)
    has_direct_pass = False
    if skip_direct:
        # the reference's embedded DirectLightingIntegrator is built with
        # the MLT maxdepth (metropolis.cpp:501), not its own default
        direct_xyz, direct_w = _render_direct_pass(
            scene, film, camera, max(1, n_direct), seed, max_depth)
        has_direct_pass = True

    # --- bootstrap: estimate b = E[luminance] over uniform psamples
    @jax.jit
    def bootstrap_batch(k):
        u = jax.random.uniform(k, (W, D))
        _, _, L = path_l(u)
        return spec.y(L)

    n_boot_batches = max(1, n_bootstrap // W)
    ys = []
    boot_keys = []
    for i in range(n_boot_batches):
        key, k = jax.random.split(key)
        boot_keys.append(k)
        ys.append(np.asarray(bootstrap_batch(k)))
    ys = np.concatenate(ys)
    b = float(np.mean(ys))
    if b <= 0.0:
        info("metropolis: bootstrap found no light-carrying chain paths")
        state = film_mod.FilmState(
            xyz=direct_xyz, weight=direct_w,
            splat=jnp.zeros((film.ny, film.nx, 3), jnp.float32))
        if options.get("write", True):
            return film_mod.write_image(film, state, 0.0)
        return film_mod.to_rgb(film, state, 0.0)

    # --- seed chains from the bootstrap distribution: resample W seed
    # vectors with probability proportional to path luminance (the
    # reference walks the luminance CDF to pick its single seed,
    # metropolis.cpp:596-608; W lockstep chains resample W seeds from
    # the same distribution). u vectors are regenerated from the stored
    # batch keys rather than kept resident.
    key, ksel = jax.random.split(key)
    probs = ys.astype(np.float64)
    probs /= probs.sum()
    idx = np.asarray(jax.random.choice(
        ksel, ys.shape[0], (W,), p=jnp.asarray(probs, jnp.float32)))
    u0_np = np.empty((W, D), np.float32)
    batch_ids = idx // W
    rows = idx % W
    for bi in np.unique(batch_ids):
        ub = np.asarray(jax.random.uniform(boot_keys[int(bi)], (W, D)))
        sel = batch_ids == bi
        u0_np[sel] = ub[rows[sel]]
    u0 = jnp.asarray(u0_np)

    @jax.jit
    def mlt_step(chain, k, state_splat):
        # chain carries the CURRENT path's evaluation so each step costs
        # one path_l (the reference re-derives it from the stored
        # MLTSample; wavefront chains cache it instead)
        u_cur, px_c, py_c, L_c, y_cur = chain
        k1, k2, k3, k4 = jax.random.split(k, 4)
        large = jax.random.uniform(k1, (W,)) < largestep_prob
        u_large = jax.random.uniform(k2, (W, D))
        # small step: exponential-magnitude jitter (reference :106-130)
        a, bexp = 1.0 / 1024.0, 1.0 / 64.0
        eps = jax.random.uniform(k3, (W, D))
        mag = bexp * jnp.exp(-jnp.log(bexp / a) * eps)
        sign = jnp.where(jax.random.uniform(k4, (W, D)) < 0.5, -1.0, 1.0)
        u_small = (u_cur + sign * mag) % 1.0
        u_prop = jnp.where(large[:, None], u_large, u_small)

        px_p, py_p, L_p = path_l(u_prop)
        y_p = spec.y(L_p)
        accept_p = jnp.clip(y_p / jnp.maximum(y_cur, 1e-12), 0.0, 1.0)
        # expected-value splats (reference :470-490): current with
        # (1-a), proposal with a, each normalized by its luminance
        w_c = (1.0 - accept_p) / jnp.maximum(y_cur, 1e-12)
        w_p = accept_p / jnp.maximum(y_p, 1e-12)
        st = film_mod.FilmState(xyz=jnp.zeros((1, 1, 3)), weight=jnp.zeros((1, 1)),
                                splat=state_splat)
        st = film_mod.splat(film, st, px_c, py_c, L_c * w_c[:, None])
        st = film_mod.splat(film, st, px_p, py_p, L_p * w_p[:, None])

        k5 = jax.random.fold_in(k, 7)
        acc = jax.random.uniform(k5, (W,)) < accept_p
        chain_new = (
            jnp.where(acc[:, None], u_prop, u_cur),
            jnp.where(acc, px_p, px_c),
            jnp.where(acc, py_p, py_c),
            jnp.where(acc[:, None], L_p, L_c),
            jnp.where(acc, y_p, y_cur),
        )
        return chain_new, st.splat

    px0, py0, L0 = path_l(u0)
    y0 = spec.y(L0)
    chain = (u0, px0, py0, L0, jnp.maximum(y0, 1e-12))
    splat = jnp.zeros((film.ny, film.nx, 3), jnp.float32)
    t0 = _time.time()
    for step in range(n_steps):
        key, k = jax.random.split(key)
        chain, splat = mlt_step(chain, k, splat)
        progress("Metropolis", step + 1, n_steps, t0)

    # Normalization (reference metropolis.cpp:737,744 pre-scales each
    # splat by b/nPixelSamples with nPixels*nPixelSamples total
    # mutations; we scale at write time instead): each of the
    # n_steps*W executed mutations splats unit (L/y)-normalized weight,
    # so the per-pixel expected splat mass is (n_steps*W)/nPixels and
    # the estimator I = b * E[L/y] needs scale b*nPixels/(n_steps*W).
    splat_scale = b * n_pix / float(n_steps * W)
    state = film_mod.FilmState(xyz=direct_xyz, weight=direct_w, splat=splat)
    if has_direct_pass:
        info("metropolis: direct pass + chain splats combined")
    if options.get("write", True):
        return film_mod.write_image(film, state, splat_scale)
    return film_mod.to_rgb(film, state, splat_scale)


def _render_direct_pass(scene, film, camera, spp: int, seed: int,
                        max_depth: int = 5):
    """Direct-lighting pre-pass through the AddSample path (reference
    metropolis.cpp doDirectSeparately: an embedded DirectLightingIntegrator
    rendered with an LDSampler at directsamples spp)."""
    from pbrt_tpu.integrators.surface import li_direct
    from pbrt_tpu.samplers.samplers import (
        S_LOWDISCREPANCY,
        SamplerSpec,
        camera_samples,
    )

    spp_p2 = 1 << max(0, (spp - 1).bit_length())
    sampler = SamplerSpec(S_LOWDISCREPANCY, spp_p2)
    n_pix = film.nx * film.ny
    pix_per_tile = max(1, (1 << 16) // spp_p2)
    n_tiles = (n_pix + pix_per_tile - 1) // pix_per_tile

    @jax.jit
    def tile(pix_ids, xyz, w):
        pix_x = (pix_ids % film.nx) + film.x0
        pix_y = (pix_ids // film.nx) + film.y0
        cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed)
        ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2,
                                       cs.u_time)
        sidx = jnp.tile(jnp.arange(spp_p2, dtype=jnp.int32),
                        pix_ids.shape[0])
        L = li_direct(scene, ray, cs.pixel, sidx, max_depth=max_depth,
                      seed=seed, strategy="all")
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        st = film_mod.FilmState(xyz=xyz, weight=w,
                                splat=jnp.zeros((1, 1, 3), jnp.float32))
        st = film_mod.add_samples(film, st, cs.px, cs.py, L, rw)
        return st.xyz, st.weight

    xyz = jnp.zeros((film.ny, film.nx, 3), jnp.float32)
    w = jnp.zeros((film.ny, film.nx), jnp.float32)
    all_ids = np.arange(n_pix, dtype=np.int32)
    t0 = _time.time()
    for ti in range(n_tiles):
        ids = all_ids[ti * pix_per_tile: (ti + 1) * pix_per_tile]
        if len(ids) < pix_per_tile:
            ids = np.concatenate([
                ids, np.full(pix_per_tile - len(ids),
                             ids[-1] if len(ids) else 0, np.int32)])
        xyz, w = tile(jnp.asarray(ids), xyz, w)
        progress("Direct lighting", ti + 1, n_tiles, t0)
    return xyz, w
