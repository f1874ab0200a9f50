"""Packet-pipeline leaf sweep, traversal selection, compile-cache path
and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrt_tpu.accel.bvh import build_bvh, make_accel
from pbrt_tpu.accel.wide_bvh import build_wide_bvh, MAX_L, TILE
from pbrt_tpu.ops.bvh_pallas import BIG, sweep_leaves, sweep_leaves_ref

from test_accel import _random_rays, _random_tri_geom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wave(case, n_tiles, n_tris=700, seed=0):
    """One leaf-sweep wave's inputs over random geometry and rays."""
    geom = _random_tri_geom(n_tris, seed=3)
    wb = build_wide_bvh(build_bvh(geom, "sah"), geom)
    R = n_tiles * TILE
    ray = _random_rays(R, seed=4)
    rng = np.random.RandomState(seed)
    lst = rng.randint(0, wb.n_blocks, (n_tiles, MAX_L)).astype(np.int32)
    nl = rng.randint(0, MAX_L + 1, n_tiles).astype(np.int32)
    t_in = np.full(R, BIG, np.float32)
    if case == "empty":
        nl[:] = 0
    elif case == "full":
        nl[:] = MAX_L
    elif case == "dead":
        t_in[::3] = -BIG
    elif case == "short_tmax":
        t_in[:] = 0.5
    rays8 = jnp.concatenate([ray.o.T, ray.d.T, ray.tmin[None, :],
                             jnp.zeros((1, R), jnp.float32)], 0)
    return (jnp.asarray(lst), jnp.asarray(nl), rays8, jnp.asarray(t_in),
            jnp.full((R,), -1, jnp.int32), wb.tris16)


def _check_sweep(args, t_k, p_k):
    lst, nl, rays8, t_in, p_in, _ = args
    t_r, p_r = sweep_leaves_ref(*args)
    t_k, p_k, t_r, p_r = (np.asarray(x) for x in (t_k, p_k, t_r, p_r))
    np.testing.assert_array_equal(p_k, p_r)
    np.testing.assert_allclose(t_k, t_r, rtol=1e-6)
    hit = p_k >= 0
    # a hit lies strictly inside the ray's incoming bound
    assert np.all(t_k[hit] < np.asarray(t_in)[hit])
    # rays of tiles with empty lists keep their input
    untouched = np.repeat(np.asarray(nl) == 0, TILE)
    np.testing.assert_array_equal(t_k[untouched], np.asarray(t_in)[untouched])
    return hit


@pytest.mark.parametrize("case", ["empty", "full", "dead", "short_tmax"])
def test_kernel_interpret_matches_jnp_sweep(case):
    args = _wave(case, n_tiles=1 if case == "full" else 2)
    t_k, p_k = sweep_leaves(*args, interpret=True)
    hit = _check_sweep(args, t_k, p_k)
    if case == "empty":
        assert not hit.any()
    if case == "dead":
        assert not hit[::3].any()
    if case in ("full", "short_tmax"):
        assert hit.any()


@pytest.mark.gpu
def test_kernel_compiled_matches_jnp_sweep():
    args = _wave("full", n_tiles=64, n_tris=20000)
    t_k, p_k = sweep_leaves(*args)
    assert _check_sweep(args, t_k, p_k).any()


@pytest.mark.parametrize("backend", ["gpu", "cpu", "rocm"])
def test_make_accel_follows_backend(backend, monkeypatch):
    geom = _random_tri_geom(700, seed=3)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if backend == "rocm":
        with pytest.raises(ValueError, match="unsupported JAX backend"):
            make_accel(geom, wide_threshold=256)
        return
    accel = make_accel(geom, wide_threshold=256)
    assert (accel.wide is not None) == (backend == "gpu")
    assert accel.bvh is None     # 700 prims: below the BVH threshold
    # below the packet threshold both backends take the jnp scan
    small = make_accel(geom, wide_threshold=8192)
    assert small.wide is None and small.bvh is None


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_dir(env, monkeypatch):
    from pbrt_tpu.compile_cache import cache_dir

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cache_dir() == env


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = os.path.join(tmp_path, "chip_smoke.py"), tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_jobs_write_distinct_images():
    sys.path.insert(0, REPO)
    import chip_smoke

    jobs = chip_smoke.smoke_jobs()
    outs = [job[1] for job in jobs]
    assert len(set(outs)) == len(outs), outs
    goldens = {os.path.splitext(os.path.basename(j[0]))[0] for j in jobs[:-2]}
    assert "mesh" in goldens     # a golden shares the mesh job's name
