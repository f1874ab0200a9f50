"""Full-resolution flagship parity: the reference
project's own configurations at full scale, diffed against
reference-binary renders — the strongest parity statement, replacing
the 64-96 pixel crops.

Goldens are stored 4x4-block-downsampled (committing a 12MB full-res
PFM per scene buys nothing: MC noise dominates pixel-level diffs at
these sample counts anyway, and block means are the statistically
meaningful comparison).

Slow by design (-m slow): each render is minutes on-chip.
"""
import os
import re
import time

import numpy as np
import pytest

from pbrt_tpu.io.image import read_image
from pbrt_tpu.scene import api, parser

CORPUS = "/root/reference/projectScene"
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.path.isdir(CORPUS),
                       reason="reference corpus not present"),
]


def _block_mean(img, b=4):
    h, w = img.shape[:2]
    hb, wb = h // b, w // b
    return img[: hb * b, : wb * b].reshape(hb, b, wb, b, -1).mean(axis=(1, 3))


def _render_corpus(name, edits=()):
    src = open(os.path.join(CORPUS, name)).read()
    for pat, rep in edits:
        src, n = re.subn(pat, rep, src)
        assert n >= 1, pat
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, name)
        with open(p, "w") as f:
            f.write(src)
        t0 = time.time()
        api.pbrt_init({"quiet": False, "write": False})
        try:
            parser.parse_file(p)
            out = np.asarray(api._state.output)
        finally:
            api._state.__init__()
        print(f"\n{name}: rendered {out.shape[1]}x{out.shape[0]} "
              f"in {time.time() - t0:.0f}s")
        return out


def _compare(ours, golden_name, mean_rtol, block_bound):
    ref_b = np.asarray(read_image(
        os.path.join(GOLDEN_DIR, f"{golden_name}.pfm")))
    ours_b = _block_mean(ours)
    assert ours_b.shape == ref_b.shape, (ours_b.shape, ref_b.shape)
    assert np.all(np.isfinite(ours))
    level = max(float(ref_b.mean()), 1e-6)
    assert abs(float(ours_b.mean()) - ref_b.mean()) / level < mean_rtol, (
        ours_b.mean(), ref_b.mean())
    mad = float(np.abs(ours_b - ref_b).mean())
    print(f"{golden_name}: mean {ours_b.mean():.5f} vs ref {ref_b.mean():.5f}"
          f", block MAD/level {mad / level:.4f}")
    assert mad / level < block_bound, (mad, level)


def test_scene_full_300_8spp():
    """projectScene/scene.pbrt at its authored 300^2 / 8spp with FULL
    quotas (50k caustic + 1M volume photons, nused 300) — the
    dispersion-matrix flagship, no --quick reductions."""
    ours = _render_corpus("scene.pbrt")
    _compare(ours, "ref_scene_full_b4", mean_rtol=0.10, block_bound=0.25)


def test_rainbow_512_4spp():
    """projectScene/rainbow_png.pbrt at 512x513 / 4spp (the authored
    config halved per axis: a 2-CPU reference render of the full
    1024x1025/8spp would take ~10h; 512 is still 28x the round-4 crop
    and exercises the identical photonmap+photonvolume pipeline)."""
    ours = _render_corpus("rainbow_png.pbrt", edits=(
        (r'"integer xresolution" \[1024\] "integer yresolution" \[1025\]',
         '"integer xresolution" [512] "integer yresolution" [513]'),
        (r'"integer pixelsamples" \[8\]', '"integer pixelsamples" [4]'),
        (r'"integer finalgathersamples" \[64\]',
         '"integer finalgathersamples" [16]'),
    ))
    _compare(ours, "ref_rainbow_512_b4", mean_rtol=0.10, block_bound=0.25)


def test_rainbow_full_1024_8spp():
    """projectScene/rainbow_png.pbrt at its authored FULL configuration:
    1024x1025 / 8 spp / finalgathersamples 64, nothing reduced.

    The reference-side full render is ~10h on this 2-CPU host, so the
    golden is the 512x513/4spp reference render (ref_rainbow_512_b4):
    both are MC estimates of the same converged image, and comparing
    8x-downsampled full-res blocks against the golden's 4x blocks puts
    them on the identical 128-wide block grid. This pins the TRUE
    flagship config end-to-end on the device and records
    its wall-clock."""
    ours = _render_corpus("rainbow_png.pbrt")
    assert ours.shape[1] == 1024 and ours.shape[0] == 1025, ours.shape
    ref_b = np.asarray(read_image(
        os.path.join(GOLDEN_DIR, "ref_rainbow_512_b4.pfm")))
    ours_b = _block_mean(ours, b=8)
    assert ours_b.shape == ref_b.shape, (ours_b.shape, ref_b.shape)
    assert np.all(np.isfinite(ours))
    level = max(float(ref_b.mean()), 1e-6)
    assert abs(float(ours_b.mean()) - ref_b.mean()) / level < 0.10, (
        ours_b.mean(), ref_b.mean())
    mad = float(np.abs(ours_b - ref_b).mean())
    print(f"rainbow_full_1024: mean {ours_b.mean():.5f} vs ref "
          f"{ref_b.mean():.5f}, block MAD/level {mad / level:.4f}")
    assert mad / level < 0.25, (mad, level)
