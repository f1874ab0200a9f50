"""pinkfloyd scale proof: 5M volume photons / nused 500 on-chip.

The reference's heaviest configuration (projectScene/pinkfloyd.pbrt:
13-15: 5,000,000 volume photons, photonvolume nused=500, maxdist 0.4,
dispersive prism in a spot beam). Round 3 could not even compile the
kNN at nused=300; this test builds the full 5M-photon map and renders
a 256^2 crop through the fused query-blocked kNN, logging build/render
wall-clock and device peak memory.

Slow by design (-m slow to run; driver CI runs the default suite).
"""
import os
import re
import time

import numpy as np
import pytest

from pbrt_tpu.scene import api, parser

CORPUS = "/root/reference/projectScene"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.path.isdir(CORPUS),
                       reason="reference corpus not present"),
]


def test_pinkfloyd_5m_crop(tmp_path):
    """8k-sample tiles: nused=500 kNN buffers inside the 128-step march
    are the largest live state of any reference workload."""
    src = open(os.path.join(CORPUS, "pinkfloyd.pbrt")).read()
    # 256^2 crop of the beam region; 4 spp bounds render time while the
    # photon build stays at FULL scale (5M volume photons, nused 500)
    src, n = re.subn(r'"integer pixelsamples" \[32\]',
                     '"integer pixelsamples" [4]', src)
    assert n == 1
    src = src.replace(
        'Sampler "lowdiscrepancy" "integer pixelsamples" [4]',
        'Sampler "lowdiscrepancy" "integer pixelsamples" [4]\n')
    src = src.replace(
        '"integer xresolution" [512] "integer yresolution" [512]',
        '"integer xresolution" [512] "integer yresolution" [512]\n'
        ' "float cropwindow" [0.25 0.75 0.25 0.75]')
    # the Include path is relative to the corpus dir
    src = src.replace('Include "obj/prism.pbrt"',
                      f'Include "{CORPUS}/obj/prism.pbrt"')
    out = tmp_path / "pf.pbrt"
    out.write_text(src)

    t0 = time.time()
    api.pbrt_init({"quiet": False, "write": False, "tile_samples": 8192})
    try:
        parser.parse_file(str(out))
        img = np.asarray(api._state.output)
    finally:
        api._state.__init__()
    dt = time.time() - t0

    assert img.shape[0] == 256 and img.shape[1] == 256
    assert np.all(np.isfinite(img))
    assert float(img.mean()) > 0.0

    # residency probe: memory_stats() lacks peak_bytes_in_use on some
    # backends (the CPU), so fall back to summing the live device
    # buffers — a real measurement either way, and assert it is nonzero so the
    # probe can never silently report 0.00 GiB again
    import jax

    stats = {}
    try:
        stats = jax.devices()[0].memory_stats() or {}
    except Exception:
        pass
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use") or 0
    live = sum(b.nbytes for b in jax.live_arrays())
    measured = peak or live
    assert measured > 0, "device-memory probe measured nothing"
    kind = "peak" if peak else "live-buffer"
    print(f"\npinkfloyd 5M/nused500 256^2 crop: {dt:.0f}s total, "
          f"{kind} device memory {measured / 2**30:.2f} GiB, "
          f"image mean {float(img.mean()):.5f}")
