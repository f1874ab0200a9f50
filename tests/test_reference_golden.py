"""Image regression against the reference CPU renderer.

Golden PFMs in tests/goldens/ were rendered by the reference binary
(piwell/CS348B-pbrt built from /root/reference with make; .pfm output)
on the committed scene files. Our renders must match within MC noise:
the mean image level is a tight systematic check, per-pixel error is a
loose bound (both renderers draw different low-discrepancy sample
positions, so silhouette/noise pixels differ legitimately).

This is the tolerance-based exrdiff pattern the reference uses for QA
(reference tools/exrdiff.cpp, SURVEY.md section 4.3), automated.
"""
import os

import numpy as np
import pytest

from pbrt_tpu.io.image import read_image
from pbrt_tpu.scene import api, parser

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# scene, mean-level rtol, per-pixel mean-abs-diff / mean-level bound
CASES = [
    ("matte", 0.02, 0.03),    # directlighting, point light, quadrics
    ("meshdl", 0.03, 0.08),   # directlighting, disk area light, mesh floor
    ("vol", 0.05, 0.08),      # single-scatter homogeneous volume march
    ("mesh", 0.05, 0.15),     # 4-bounce path: plastic + mirror + area light
    ("smoke", 0.05, 0.10),    # dispersive glass, whitted-style specular chain
    # crown-glass dispersion caustic through photonmap (reference
    # projectScene/scene.pbrt:40 preset); caustics are kNN-smoothed
    # density estimates, so the pixel bound is loose
    ("disp", 0.08, 0.30),
    # rainbow volume crop: photonvolume + rainbowReflection transfer +
    # photonmap final gather (reference projectScene/rainbow_png.pbrt)
    ("rainbowc", 0.05, 0.15),
    # irradiance cache: the reference interpolates octree-cached
    # samples (core/octree.h:58); this build re-evaluates hemispheric
    # irradiance per hit — same estimator, different interpolation
    # error, so the mean must agree while pixels differ by cache
    # artifacts
    ("irr", 0.08, 0.20),
    # diffuse PRT: SH-projected transfer x SH-projected lighting
    # (reference integrators/diffuseprt.cpp:100) — validates the SH
    # projection pipeline against the reference binary
    ("dprt", 0.08, 0.20),
]


def _render(name):
    scene = os.path.join(GOLDEN_DIR, f"{name}.pbrt")
    api.pbrt_init({"quiet": True, "write": False})
    try:
        parser.parse_file(scene)
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


@pytest.mark.parametrize("name,mean_rtol,pix_bound", CASES)
def test_matches_reference(name, mean_rtol, pix_bound):
    ref = np.asarray(read_image(os.path.join(GOLDEN_DIR, f"ref_{name}.pfm")))
    ours = _render(name)
    assert ours.shape == ref.shape
    assert np.all(np.isfinite(ours))
    level = max(float(ref.mean()), 1e-6)
    # systematic: image mean must match closely
    assert abs(float(ours.mean()) - ref.mean()) / level < mean_rtol, (
        ours.mean(), ref.mean())
    # pixelwise: bounded MC-noise-level deviation
    mad = float(np.abs(ours - ref).mean())
    assert mad / level < pix_bound, (mad, level)
