"""Multi-host proof without multi-host hardware: two OS processes x
four virtual CPU devices, joined by jax.distributed into one 8-device
mesh, driving the REAL `--distributed` CLI path (pbrt_tpu.main) on a
photonvolume scene — sharded render tiles + sharded photon shooting
with the device-side all_gather merge (reference
analog: the photon-merge mutex + film atomics, core/parallel.cpp).

Both processes must produce the identical full image, equal to a
single-process render of the same scene.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
SurfaceIntegrator "path" "integer maxdepth" [2]
VolumeIntegrator "photonvolume" "float stepsize" [1.0]
  "integer volumephotons" [100] "integer nused" [10] "float maxdist" [0.8]
WorldBegin
LightSource "point" "point from" [0 2 0] "rgb I" [20 20 20]
Volume "homogeneous" "point p0" [-1.5 -1.5 -1.5] "point p1" [1.5 1.5 1.5]
  "rgb sigma_a" [.05 .05 .05] "rgb sigma_s" [.8 .8 .8]
WorldEnd
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(n_local_dev):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={n_local_dev}")
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    scene = tmp_path / "dist.pbrt"
    scene.write_text(SCENE)

    # --- single-process baseline (8 virtual devices, same mesh size)
    out1 = tmp_path / "single.pfm"
    r = subprocess.run(
        [sys.executable, "-m", "pbrt_tpu.main", "--ncores", "8",
         "--outfile", str(out1), str(scene)],
        cwd=REPO, env=_env(8), capture_output=True, text=True, timeout=2400)
    assert r.returncode == 0, r.stdout + r.stderr

    # --- two processes x 4 devices through the real --distributed path
    port = _free_port()
    procs = []
    outs = []
    for pid in range(2):
        env = _env(4)
        env["PBRT_COORDINATOR"] = f"127.0.0.1:{port}"
        env["PBRT_NUM_PROCESSES"] = "2"
        env["PBRT_PROCESS_ID"] = str(pid)
        out = tmp_path / f"dist_{pid}.pfm"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pbrt_tpu.main", "--distributed",
             "--ncores", "8", "--outfile", str(out), str(scene)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=2400)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log)
    assert all(p.returncode == 0 for p in procs), "\n===\n".join(logs)

    from pbrt_tpu.io.image import read_image

    img1 = np.asarray(read_image(str(out1)))
    imgs = [np.asarray(read_image(str(o))) for o in outs]
    assert np.all(np.isfinite(img1)) and img1.max() > 0.0
    # both processes hold the identical full film
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-7)
    # and the distributed render equals the single-process render
    np.testing.assert_allclose(imgs[0], img1, rtol=1e-4, atol=1e-5)
