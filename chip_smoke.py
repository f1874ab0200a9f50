"""Smoke test of the renderer on one NVIDIA GPU.

    python chip_smoke.py          # one card: goldens, mesh, rainbow
    python chip_smoke.py --four   # four cards: sharded render + multichip

Drives the normal render path (`python -m pbrt_tpu.main scene.pbrt`)
at full size in one process and checks what comes out:

  render   every scene below rendered through the CLI entry point, all
           at once from threads so that XLA compiles their programs
           concurrently (compilation is most of a cold run);
  goldens  every tests/goldens/*.pbrt scene with a reference image,
           within the tolerances of tests/test_reference_golden.py;
  gpu      the card-only tests (`pytest -m gpu`);
  mesh     a 135,202-triangle mesh scene at 1024x1024, 4 spp, path
           depth 5, which must take the packet pipeline with the
           compiled leaf-sweep kernel; its traversal is compared with
           the jnp BVH on 1M camera, shadow and incoherent rays;
  rainbow  the rainbow crop at the authored 1024x1025 / 8 spp /
           64 final-gather samples (photon shooting, kNN, volume
           march, final gather), mean within 5% of the reference's.

With --four only the sharded path runs: the mesh scene (path depth 1,
to bound compile time) rendered over 4 cards and over 1, which must
agree, and the multichip gradient/photon dry run.

Each phase prints one JSON line with the card's name and power limit,
wall and compile seconds and peak device memory. The last line is
{"ok": true, "device": {...}} and is printed only when every phase
passed; the script exits non-zero, with no such line, when JAX finds
no GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
GOLDENS = os.path.join(REPO, "tests", "goldens")

MESH_JOB = (os.path.join(OUT, "mesh.pbrt"), os.path.join(OUT, "mesh.pfm"),
            "--ncores", "1")
RAINBOW_JOB = (os.path.join(OUT, "rainbow_full.pbrt"),
               os.path.join(OUT, "rainbow_full.pfm"))

_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


def card_info():
    """(name, power.limit) as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    name, power = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


def run_phase(name, fn, card):
    import jax

    c0, t0 = _compile_s[0], time.perf_counter()
    result = fn()
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    print(json.dumps({
        "phase": name, "name": card[0], "power.limit": card[1],
        "wall_s": wall, "compile_s": _compile_s[0] - c0,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        **result}), flush=True)


def cli_args(scene, out, *extra):
    return [scene, "--quiet", "--outfile", out, *extra]


def render_all(jobs):
    """Render `jobs` [(scene, out, extra CLI args)] through the CLI entry
    point, all at once: each scene is parsed by `pbrt_tpu.main` with its
    render deferred, then the renders run from threads, so that XLA
    compiles their programs concurrently. Each render writes its image
    to `out`. Returns the compiled scene of each job, in order."""
    from concurrent.futures import ThreadPoolExecutor

    import pbrt_tpu.renderers.driver as drv
    from pbrt_tpu import main as cli

    outs = [job[1] for job in jobs]
    assert len(set(outs)) == len(outs), f"two jobs write one image: {outs}"
    deferred = []
    render_scene, compile_scene = drv.render_scene, drv.compile_scene
    drv.render_scene = lambda ro, options: deferred.append((ro, options))
    try:
        for job in jobs:
            if os.path.exists(job[1]):      # never check a stale image
                os.remove(job[1])
            assert cli.main(cli_args(*job)) == 0, job
    finally:
        drv.render_scene = render_scene
    assert len(deferred) == len(jobs), (len(deferred), len(jobs))
    scenes = {}

    def record(ro, *a, **k):
        scenes[id(ro)] = compile_scene(ro, *a, **k)
        return scenes[id(ro)]

    drv.compile_scene = record
    try:
        with ThreadPoolExecutor(len(deferred)) as ex:
            list(ex.map(lambda d: render_scene(*d), deferred))
    finally:
        drv.compile_scene = compile_scene
    return [scenes[id(ro)] for ro, _ in deferred]


def golden_cases():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_reference_golden import CASES

    return CASES


def golden_job(name):
    return (os.path.join(GOLDENS, f"{name}.pbrt"),
            os.path.join(OUT, "goldens", f"{name}.pfm"))


def smoke_jobs():
    """The one-card render jobs: every golden, the mesh, the rainbow."""
    return ([golden_job(c[0]) for c in golden_cases()]
            + [MESH_JOB, RAINBOW_JOB])


def phase_goldens():
    import numpy as np
    from pbrt_tpu.io.image import read_image

    res = {}
    for name, mean_rtol, pix_bound in golden_cases():
        ours = read_image(golden_job(name)[1])
        ref = read_image(os.path.join(GOLDENS, f"ref_{name}.pfm"))
        assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
        assert np.all(np.isfinite(ours)), name
        level = max(float(ref.mean()), 1e-6)
        mean_err = abs(float(ours.mean()) - float(ref.mean())) / level
        mad = float(np.abs(ours - ref).mean()) / level
        res[name] = {"mean_rel_err": mean_err, "mad_rel": mad}
        assert mean_err < mean_rtol, (name, mean_err, mean_rtol)
        assert mad < pix_bound, (name, mad, pix_bound)
    return {"scenes": res}


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    assert rc == 0, f"pytest -m gpu exited {rc}"
    return {"pytest_rc": int(rc)}


def write_mesh_scene(path, res=1024, spp=4, n_theta=260, n_phi=260,
                     maxdepth=5):
    """scripts/bench_scene.py's geometry as a .pbrt scene file."""
    import numpy as np

    sys.path.insert(0, REPO)
    from scripts.bench_scene import uv_sphere

    P, vi = uv_sphere(n_theta, n_phi, radius=1.0, center=(0.0, 0.4, 0.0))
    fmt = lambda a: " ".join(np.format_float_positional(x, trim="-")
                             for x in np.asarray(a).ravel())
    with open(path, "w") as f:
        f.write(f'Film "image" "integer xresolution" [{res}] '
                f'"integer yresolution" [{res}]\n'
                f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
                f'SurfaceIntegrator "path" "integer maxdepth" [{maxdepth}]\n'
                'LookAt 0 1.2 -4  0 0.4 0  0 1 0\n'
                'Camera "perspective" "float fov" [45]\n'
                'WorldBegin\n'
                'LightSource "point" "point from" [3 6 -4] '
                '"rgb I" [60 60 60]\n'
                'Material "matte" "rgb Kd" [0.45 0.35 0.65]\n'
                f'Shape "trianglemesh" "point P" [{fmt(P)}]\n'
                f'  "integer indices" [{" ".join(map(str, vi))}]\n'
                'Material "matte" "rgb Kd" [0.55 0.55 0.5]\n'
                'Shape "trianglemesh" "point P" [-12 -0.6 -12  12 -0.6 -12'
                '  12 -0.6 12  -12 -0.6 12] "integer indices" [0 2 1 0 3 2]\n'
                'WorldEnd\n')


def compare_traversal(scene, n=1 << 20):
    """Packet pipeline vs the jnp BVH on n camera, shadow (any-hit) and
    incoherent rays. Hit masks must agree on >= 99.99% of rays (FMA
    contraction can flip a grazing shared-edge test); where both hit
    the same triangle, t agrees to rtol 1e-5."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pbrt_tpu.accel.bvh import make_accel
    from pbrt_tpu.core.geometry import Ray
    from scripts.bench_scene import camera_rays

    ref = make_accel(scene.geom, force="bvh")
    res = int(round(n ** 0.5))
    cam = camera_rays(res)
    zeros = jnp.zeros(n)
    rng = np.random.RandomState(0)
    lo, hi = np.asarray(scene.world_lo), np.asarray(scene.world_hi)
    inc_o = jnp.asarray(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    inc_d = rng.normal(size=(n, 3)).astype(np.float32)
    inc_d = jnp.asarray(inc_d / np.linalg.norm(inc_d, axis=-1, keepdims=True))

    def caster(accel, any_hit, coherent):
        return jax.jit(lambda o, d, tmax: accel._t_pass(
            Ray(o, d, zeros, tmax, zeros), any_hit=any_hit,
            coherent=coherent))

    inf = jnp.full((n,), jnp.inf)
    t_cam, p_cam = caster(ref, False, True)(cam.o, cam.d, inf)
    hit_p = cam.o + jnp.where(p_cam >= 0, t_cam, 0.0)[:, None] * cam.d
    sd = jnp.asarray([3.0, 6.0, -4.0])[None, :] - hit_p
    dist = jnp.sqrt(jnp.sum(sd * sd, -1))
    sdir = sd / jnp.maximum(dist, 1e-9)[:, None]
    s_o = hit_p + sdir * 1e-3
    s_tmax = jnp.where(p_cam >= 0, dist * 0.999, -1.0)
    legs = {
        "camera": (cam.o, cam.d, inf, False, True),
        "shadow": (s_o, sdir, s_tmax, True, True),
        "incoherent": (inc_o, inc_d, inf, False, False),
    }
    # compile all casts concurrently (XLA compiles from several threads)
    from concurrent.futures import ThreadPoolExecutor

    todo = [(leg, accel) for leg in legs for accel in (scene.accel, ref)]

    def compile_cast(job):
        leg, accel = job
        o, d, tmax, any_hit, coherent = legs[leg]
        return caster(accel, any_hit, coherent).lower(o, d, tmax).compile()

    with ThreadPoolExecutor(len(todo)) as ex:
        casts = list(ex.map(compile_cast, todo))
    out = {}
    for i, (leg, (o, d, tmax, any_hit, coherent)) in enumerate(legs.items()):
        t_k, p_k = (np.asarray(x) for x in casts[2 * i](o, d, tmax))
        t_r, p_r = (np.asarray(x) for x in casts[2 * i + 1](o, d, tmax))
        hk, hr = p_k >= 0, p_r >= 0
        agree = float(np.mean(hk == hr))
        same = hk & hr & (p_k == p_r)
        t_err = float(np.max(np.abs(t_k[same] - t_r[same])
                             / np.abs(t_r[same]))) if same.any() else 0.0
        out[leg] = {"hit_frac": float(hr.mean()), "mask_agree": agree,
                    "same_prim_frac": float(same.sum() / max(1, (hk & hr).sum())),
                    "max_t_rel_err": t_err}
        assert agree >= 0.9999, (leg, agree)
        if not any_hit:
            assert t_err <= 1e-5, (leg, t_err)
            assert same.sum() >= 0.9999 * (hk & hr).sum(), (leg, out[leg])
    return out


def phase_mesh(scene, res=1024, n_theta=260, n_phi=260, n_rays=1 << 20):
    """Checks MESH_JOB's render (written by write_mesh_scene(res,
    n_theta, n_phi)) and its compiled `scene`."""
    import numpy as np
    from pbrt_tpu.io.image import read_image

    img = read_image(MESH_JOB[1])
    assert scene.geom.n_tris == 2 * n_theta * n_phi + 2, scene.geom.n_tris
    assert getattr(scene.accel, "wide", None) is not None, (
        "the GPU packet pipeline was not built for the mesh scene")
    assert img.shape == (res, res, 3) and np.all(np.isfinite(img))
    assert float(img.mean()) > 0.0
    return {"tris": int(scene.geom.n_tris),
            "leaf_blocks": int(scene.accel.wide.n_blocks),
            "image_mean": float(img.mean()),
            "traversal": compare_traversal(scene, n_rays)}


def write_rainbow_scene(path):
    """The rainbow crop at the authored frame and sampling."""
    with open(os.path.join(GOLDENS, "rainbowc.pbrt")) as f:
        text = f.read()
    edits = (('"integer xresolution" [96] "integer yresolution" [96]',
              '"integer xresolution" [1024] "integer yresolution" [1025]'),
             ('"integer pixelsamples" [2]', '"integer pixelsamples" [8]'),
             ('"integer finalgathersamples" [8]',
              '"integer finalgathersamples" [64]'))
    for a, b in edits:
        assert a in text, a
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)


def phase_rainbow():
    import numpy as np
    from pbrt_tpu.io.image import read_image

    img = read_image(RAINBOW_JOB[1])
    ref = read_image(os.path.join(GOLDENS, "ref_rainbowc.pfm"))
    assert img.shape == (1025, 1024, 3), img.shape
    assert np.all(np.isfinite(img))
    rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
    assert rel <= 0.05, (float(img.mean()), float(ref.mean()))
    return {"image_mean": float(img.mean()), "ref_mean": float(ref.mean()),
            "mean_rel_err": rel}


def phase_four(res=1024, n_theta=260, n_phi=260):
    """The mesh scene sharded over 4 cards against 1 card, and the
    multichip gradient/photon dry run."""
    import numpy as np
    import jax
    from pbrt_tpu.io.image import read_image

    assert len(jax.devices()) >= 4, jax.devices()
    scene_path = MESH_JOB[0]
    write_mesh_scene(scene_path, res=res, n_theta=n_theta, n_phi=n_phi,
                     maxdepth=1)
    jobs = [(scene_path, os.path.join(OUT, f"mesh_{n}.pfm"), "--ncores",
             str(n)) for n in (1, 4)]
    scenes = render_all(jobs)
    assert all(getattr(s.accel, "wide", None) is not None for s in scenes)
    one, four = (read_image(job[1]) for job in jobs)
    assert np.all(np.isfinite(one)) and float(one.mean()) > 0.0
    diff = float(np.abs(one - four).max()) / float(one.mean())
    assert diff <= 1e-4, diff
    sys.path.insert(0, REPO)
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(4)
    return {"image_mean": float(one.mean()),
            "max_abs_diff_over_mean": diff}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded-render phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1

    from pbrt_tpu.compile_cache import enable_compile_cache
    from pbrt_tpu.native import load_native

    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    os.makedirs(os.path.join(OUT, "goldens"), exist_ok=True)
    card = card_info()
    print(f"{card[0]}, {card[1]}", flush=True)
    print(json.dumps({"native_bvh_builder": load_native() is not None}),
          flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        write_mesh_scene(MESH_JOB[0])
        write_rainbow_scene(RAINBOW_JOB[0])
        jobs = ([golden_job(c[0]) for c in golden_cases()]
                + [MESH_JOB, RAINBOW_JOB])
        scenes = []

        def phase_render():
            scenes.extend(render_all(jobs))
            return {"renders": len(scenes)}

        phases = [("render", phase_render),
                  ("goldens", phase_goldens), ("gpu_tests", phase_gpu_tests),
                  ("mesh", lambda: phase_mesh(scenes[jobs.index(MESH_JOB)])),
                  ("rainbow", phase_rainbow)]
    for name, fn in phases:
        run_phase(name, fn, card)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
