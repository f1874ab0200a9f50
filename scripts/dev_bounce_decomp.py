"""Decompose path-render time: t-pass vs shadow any-hit vs shading.

Run on the GPU to find where the non-traversal time goes. Times, for
the bench scene at 1024^2:
  - closest-hit t-pass        (1 bounce equivalent)
  - any-hit shadow pass       (new early-out path)
  - reconstruct (diffgeom)
  - eval_bsdf_params + lobes
  - estimate_direct (full, incl. its shadow cast)
  - li_path depth 1..5 totals
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import numpy as np
import jax
import jax.numpy as jnp

import bench_scene
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.integrators import surface as S
from pbrt_tpu.scene.compile import eval_bsdf_params
from pbrt_tpu.materials.bsdf import material_lobes
from pbrt_tpu.samplers.samplers import integrator_uniform as iu

scene = bench_scene.make_bench_scene()
RES = 1024
n = RES * RES
ray = bench_scene.camera_rays(RES)
pixel = jnp.arange(n, dtype=jnp.int32)
sidx = jnp.zeros(n, jnp.int32)
zf = jnp.zeros(n)


def timeit(fn, *args, iters=5, warm=1):
    for _ in range(warm):
        out = fn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready") else x, out)
    return (time.perf_counter() - t0) / iters


@jax.jit
def f_tpass(o, d):
    return scene.accel._t_pass(Ray(o, d, zf, jnp.full((n,), jnp.inf), zf))


@jax.jit
def f_anyhit(o, d):
    return scene.accel._t_pass(
        Ray(o, d, zf, jnp.full((n,), jnp.inf), zf), any_hit=True)


@jax.jit
def f_intersect(o, d):
    return scene.intersect(Ray(o, d, zf, jnp.full((n,), jnp.inf), zf))


@jax.jit
def f_shade(o, d):
    hit = scene.intersect(Ray(o, d, zf, jnp.full((n,), jnp.inf), zf))
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = S.shading_frame(scene, hit)
    return lobes.diff_r, frame.ns


@jax.jit
def f_direct(o, d):
    hit = scene.intersect(Ray(o, d, zf, jnp.full((n,), jnp.inf), zf))
    params = eval_bsdf_params(scene, hit)
    lobes = material_lobes(params)
    frame = S.shading_frame(scene, hit)
    wo = -d
    from pbrt_tpu.materials.bsdf import has_non_specular
    Ld = S.estimate_direct(scene, lobes, frame, hit.p, wo,
                           iu(pixel, sidx, 0, 0, 0), iu(pixel, sidx, 0, 1, 0),
                           iu(pixel, sidx, 0, 2, 0), hit.valid & has_non_specular(lobes))
    return Ld


def f_path(depth):
    @jax.jit
    def g(o, d):
        return S.li_path(scene, Ray(o, d, zf, jnp.full((n,), jnp.inf), zf),
                         pixel, sidx, max_depth=depth, seed=0)
    return g


import functools
print = functools.partial(print, flush=True)
print(f"tpass      {timeit(f_tpass, ray.o, ray.d)*1e3:8.1f} ms")
print(f"anyhit     {timeit(f_anyhit, ray.o, ray.d)*1e3:8.1f} ms")
print(f"intersect  {timeit(f_intersect, ray.o, ray.d)*1e3:8.1f} ms")
print(f"shade      {timeit(f_shade, ray.o, ray.d)*1e3:8.1f} ms")
print(f"direct     {timeit(f_direct, ray.o, ray.d)*1e3:8.1f} ms")
for dep in (1, 5):
    print(f"path d={dep}   {timeit(f_path(dep), ray.o, ray.d, iters=3)*1e3:8.1f} ms")
