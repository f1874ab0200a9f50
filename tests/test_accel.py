"""BVH build + traversal: differential tests against brute force
(the reference's aggregatetest pattern, renderers/aggregatetest.cpp)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.accel.intersect import SceneGeom, t_pass_brute
from pbrt_tpu.accel.bvh import build_bvh, t_pass_bvh


def _random_tri_geom(n_tris: int, seed: int = 0) -> SceneGeom:
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (n_tris, 3)).astype(np.float32)
    v0 = centers - (e1 + e2) / 3.0
    z = np.zeros
    return SceneGeom(
        tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1), tri_e2=jnp.asarray(e2),
        tri_n=jnp.zeros((n_tris, 3, 3)), tri_has_n=jnp.zeros((n_tris,), bool),
        tri_uv=jnp.zeros((n_tris, 3, 2)),
        tri_mat=jnp.zeros((n_tris,), jnp.int32),
        tri_light=jnp.full((n_tris,), -1, jnp.int32),
        quad_type=jnp.zeros((0,), jnp.int32),
        quad_o2w=jnp.zeros((0, 4, 4)), quad_w2o=jnp.zeros((0, 4, 4)),
        quad_params=jnp.zeros((0, 8)),
        quad_mat=jnp.zeros((0,), jnp.int32), quad_light=jnp.zeros((0,), jnp.int32),
        quad_flip=jnp.zeros((0,), bool),
        world_lo=jnp.asarray([-6.0, -6.0, -6.0]), world_hi=jnp.asarray([6.0, 6.0, 6.0]),
    )


def _random_rays(n: int, seed: int = 1) -> Ray:
    rng = np.random.RandomState(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-degenerate slice (reference aggregatetest.cpp:75)
    d[: n // 8] = 0.0
    d[: n // 8, 0] = 1.0
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


@pytest.mark.parametrize("method", ["sah", "middle", "equal", "aac"])
def test_bvh_matches_brute(method):
    geom = _random_tri_geom(300)
    bvh = build_bvh(geom, method)
    ray = _random_rays(512)
    t_ref, p_ref = t_pass_brute(geom, ray)
    t_b, p_b = t_pass_bvh(bvh, geom, ray)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    t_b, p_b = np.asarray(t_b), np.asarray(p_b)
    np.testing.assert_array_equal(p_ref >= 0, p_b >= 0)
    both = p_ref >= 0
    np.testing.assert_allclose(t_b[both], t_ref[both], rtol=1e-3, atol=1e-4)


def test_bvh_any_hit():
    geom = _random_tri_geom(200)
    bvh = build_bvh(geom, "sah")
    ray = _random_rays(256, seed=3)
    _, p_ref = t_pass_brute(geom, ray)
    _, p_any = t_pass_bvh(bvh, geom, ray, any_hit=True)
    np.testing.assert_array_equal(np.asarray(p_ref) >= 0, np.asarray(p_any) >= 0)


def test_bvh_tmax_respected():
    geom = _random_tri_geom(100, seed=7)
    bvh = build_bvh(geom, "sah")
    rng = np.random.RandomState(2)
    o = rng.uniform(-6, 6, (128, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray.make(jnp.asarray(o), jnp.asarray(d), tmax=jnp.full((128,), 0.5))
    t_b, p_b = t_pass_bvh(bvh, geom, ray)
    t_b, p_b = np.asarray(t_b), np.asarray(p_b)
    assert np.all(t_b[p_b >= 0] <= 0.5 + 1e-5)


# ---------------- uniform grid (accel/grid.py) ----------------

def test_grid_matches_brute():
    from pbrt_tpu.accel.grid import build_grid, t_pass_grid

    geom = _random_tri_geom(300)
    grid = build_grid(geom)
    ray = _random_rays(512)
    t_ref, p_ref = t_pass_brute(geom, ray)
    t_g, p_g = t_pass_grid(grid, geom, ray)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    t_g, p_g = np.asarray(t_g), np.asarray(p_g)
    np.testing.assert_array_equal(p_ref >= 0, p_g >= 0)
    both = p_ref >= 0
    np.testing.assert_allclose(t_g[both], t_ref[both], rtol=1e-3, atol=1e-4)


def test_grid_any_hit():
    from pbrt_tpu.accel.grid import build_grid, t_pass_grid

    geom = _random_tri_geom(200)
    grid = build_grid(geom)
    ray = _random_rays(256, seed=3)
    _, p_ref = t_pass_brute(geom, ray)
    _, p_g = t_pass_grid(grid, geom, ray, any_hit=True)
    np.testing.assert_array_equal(np.asarray(p_ref) >= 0, np.asarray(p_g) >= 0)


def test_grid_tmax_respected():
    from pbrt_tpu.accel.grid import build_grid, t_pass_grid

    geom = _random_tri_geom(150, seed=7)
    grid = build_grid(geom)
    ray = _random_rays(256, seed=9)
    t_ref, p_ref = t_pass_brute(geom, ray)
    # clip tmax below every first hit: everything must miss
    t_short = jnp.where(jnp.asarray(p_ref) >= 0, jnp.asarray(t_ref) * 0.5, 0.1)
    ray2 = Ray(ray.o, ray.d, ray.tmin, t_short, ray.time)
    _, p_g = t_pass_grid(grid, geom, ray2)
    assert not np.any(np.asarray(p_g) >= 0)


# ---------------- SAH kd-tree (accel/kdtree.py) ----------------

def test_kdtree_matches_brute():
    from pbrt_tpu.accel.kdtree import build_kdtree, t_pass_kdtree

    geom = _random_tri_geom(300)
    kd = build_kdtree(geom)
    ray = _random_rays(512)
    t_ref, p_ref = t_pass_brute(geom, ray)
    t_k, p_k = t_pass_kdtree(kd, geom, ray)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    t_k, p_k = np.asarray(t_k), np.asarray(p_k)
    np.testing.assert_array_equal(p_ref >= 0, p_k >= 0)
    both = p_ref >= 0
    np.testing.assert_allclose(t_k[both], t_ref[both], rtol=1e-3, atol=1e-4)


def test_kdtree_any_hit():
    from pbrt_tpu.accel.kdtree import build_kdtree, t_pass_kdtree

    geom = _random_tri_geom(200)
    kd = build_kdtree(geom)
    ray = _random_rays(256, seed=3)
    _, p_ref = t_pass_brute(geom, ray)
    _, p_k = t_pass_kdtree(kd, geom, ray, any_hit=True)
    np.testing.assert_array_equal(np.asarray(p_ref) >= 0, np.asarray(p_k) >= 0)


def test_kdtree_tmax_respected():
    from pbrt_tpu.accel.kdtree import build_kdtree, t_pass_kdtree

    geom = _random_tri_geom(150, seed=7)
    kd = build_kdtree(geom)
    ray = _random_rays(256, seed=9)
    t_ref, p_ref = t_pass_brute(geom, ray)
    t_short = jnp.where(jnp.asarray(p_ref) >= 0, jnp.asarray(t_ref) * 0.5, 0.1)
    ray2 = Ray(ray.o, ray.d, ray.tmin, t_short, ray.time)
    _, p_k = t_pass_kdtree(kd, geom, ray2)
    assert not np.any(np.asarray(p_k) >= 0)


def test_kdtree_params_factory():
    from pbrt_tpu.accel.kdtree import make_kdtree_accel
    from pbrt_tpu.scene.paramset import ParamSet

    geom = _random_tri_geom(64, seed=5)
    ps = ParamSet()
    ps.add("integer", "intersectcost", [80])
    ps.add("integer", "maxprims", [2])
    accel = make_kdtree_accel(geom, ps)
    ray = _random_rays(128, seed=11)
    hit = accel.intersect(ray)
    _, p_ref = t_pass_brute(geom, ray)
    np.testing.assert_array_equal(np.asarray(p_ref) >= 0, np.asarray(hit.valid))


def test_wide_bvh_matches_brute():
    """Packet pipeline (wide-leaf blocks + culling + Pallas leaf sweep)
    vs brute force; the Triton kernel runs in the Pallas interpreter."""
    from pbrt_tpu.accel.wide_bvh import build_wide_bvh
    from pbrt_tpu.ops.bvh_pallas import wide_t_pass

    geom = _random_tri_geom(700, seed=3)
    narrow = build_bvh(geom, "sah")
    wb = build_wide_bvh(narrow, geom)
    ray = _random_rays(512, seed=4)
    t_w, p_w = wide_t_pass(wb, ray.o, ray.d, ray.tmin, ray.tmax,
                           interpret=True)
    t_b, p_b = t_pass_brute(geom, ray)
    hit_w = np.asarray(p_w) >= 0
    hit_b = np.asarray(p_b) >= 0
    np.testing.assert_array_equal(hit_w, hit_b)
    both = hit_w & hit_b
    np.testing.assert_allclose(np.asarray(t_w)[both], np.asarray(t_b)[both],
                               rtol=1e-4)


def test_wide_bvh_dead_rays_and_tmax():
    from pbrt_tpu.accel.wide_bvh import build_wide_bvh
    from pbrt_tpu.ops.bvh_pallas import wide_t_pass

    geom = _random_tri_geom(300, seed=8)
    wb = build_wide_bvh(build_bvh(geom, "sah"), geom)
    ray = _random_rays(256, seed=6)
    t_b, p_b = t_pass_brute(geom, ray)
    # shortened tmax excludes every hit
    t_short = jnp.where(jnp.asarray(p_b) >= 0, jnp.asarray(t_b) * 0.5, 0.1)
    _, p_w = wide_t_pass(wb, ray.o, ray.d, ray.tmin, t_short,
                         interpret=True)
    assert not np.any(np.asarray(p_w) >= 0)
    # dead rays (empty interval) never report hits
    dead = jnp.full_like(ray.tmax, -1.0)
    _, p_w2 = wide_t_pass(wb, ray.o, ray.d, ray.tmin, dead, interpret=True)
    assert not np.any(np.asarray(p_w2) >= 0)
