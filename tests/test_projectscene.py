"""projectScene corpus gate.

The reference ships 10 scene files (reference projectScene/*.pbrt) that
are its de-facto acceptance fixtures (SURVEY.md section 4.6). A
compile regression once shipped invisibly because nothing rendered
them; this module pins the corpus:

  * every corpus scene must PARSE through the full api state machine
    (render stubbed out),
  * the two flagship photon scenes (scene.pbrt: photonmap+photonvolume
    with dispersion-capable glass; rainbow_png.pbrt: rainbow volume +
    distant light) must RENDER end-to-end on the default backend at
    reduced quotas — exercising photon shooting, kNN estimates, final
    gather, the volume march and the film,
  * the true --quick configurations run under -m slow.
"""
import os
import re

import numpy as np
import pytest

from pbrt_tpu.scene import api, parser

CORPUS = "/root/reference/projectScene"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(CORPUS), reason="reference corpus not present")

ALL_SCENES = [
    "closeup.pbrt", "closeup_png.pbrt", "darkside.pbrt", "pinkfloyd.pbrt",
    "pinkfloyd_png.pbrt", "rainbow2_png.pbrt", "rainbow_png.pbrt",
    "scene.pbrt", "scene_png.pbrt", "volumescene_png.pbrt",
]


@pytest.mark.parametrize("name", ALL_SCENES)
def test_corpus_parses(name, monkeypatch):
    """Parse every corpus scene with rendering stubbed out: the parser,
    the api state machine and scene-object construction all run."""
    captured = {}

    def stub(ro, options=None):
        captured["ro"] = ro
        return np.zeros((1, 1, 3), np.float32)

    import pbrt_tpu.renderers.driver as drv

    monkeypatch.setattr(drv, "render_scene", stub)
    api.pbrt_init({"quiet": True, "write": False})
    try:
        parser.parse_file(os.path.join(CORPUS, name))
    finally:
        api._state.__init__()
    assert "ro" in captured, f"{name}: WorldEnd never reached"


def _render_reduced(name, edits, tile_samples=16384):
    """Render a corpus scene with photon quotas/resolution scaled down
    (regex edits on the scene text) so the full photon pipeline runs in
    test time. Returns the RGB image."""
    src = open(os.path.join(CORPUS, name)).read()
    for pat, repl in edits:
        src, n = re.subn(pat, repl, src)
        assert n > 0, f"edit {pat!r} matched nothing in {name}"
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.pbrt")
        open(out, "w").write(src)
        api.pbrt_init({"quiet": True, "write": False,
                       "tile_samples": tile_samples})
        try:
            parser.parse_file(out)
            return np.asarray(api._state.output)
        finally:
            api._state.__init__()


def test_scene_pbrt_renders():
    """scene.pbrt (reference projectScene/scene.pbrt:8-15): photonmap
    surface integrator + 1M-volume-photon photonvolume, at reduced
    quotas/resolution. Gate: finite image with nonzero energy."""
    img = _render_reduced("scene.pbrt", [
        (r'"integer xresolution" \[300\] "integer yresolution" \[300\]',
         '"integer xresolution" [64] "integer yresolution" [64]'),
        (r'"integer pixelsamples" \[8\]', '"integer pixelsamples" [2]'),
        (r'"integer causticphotons" \[50000\]',
         '"integer causticphotons" [2000]'),
        (r'"integer volumephotons"  \[1000000\]',
         '"integer volumephotons" [5000]'),
        (r'"integer finalgathersamples" \[64\]',
         '"integer finalgathersamples" [4]'),
    ])
    assert img.shape == (64, 64, 3)
    assert np.all(np.isfinite(img))
    assert float(img.mean()) > 1e-4, "scene.pbrt rendered black"


def test_rainbow_png_renders():
    """rainbow_png.pbrt (reference projectScene/rainbow_png.pbrt:12-15):
    rainbow volume + photonvolume + photonmap final gather + imagemap
    texture whose file is absent from the checkout (grey fallback)."""
    img = _render_reduced("rainbow_png.pbrt", [
        (r'"integer xresolution" \[1024\] "integer yresolution" \[1025\]',
         '"integer xresolution" [64] "integer yresolution" [65]'),
        (r'"integer pixelsamples" \[8\]', '"integer pixelsamples" [2]'),
        (r'"integer finalgathersamples" \[64\]',
         '"integer finalgathersamples" [4]'),
        (r'"integer volumephotons"  \[5000\]',
         '"integer volumephotons" [2000]'),
    ])
    assert img.shape == (65, 64, 3)
    assert np.all(np.isfinite(img))
    assert float(img.mean()) > 1e-5, "rainbow_png.pbrt rendered black"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["scene.pbrt", "rainbow_png.pbrt"])
def test_flagship_quick(name, tmp_path):
    """The true --quick configuration (reference --quick flag semantics:
    quarter resolution, reduced photon quotas) — an out-of-memory
    repro. Must produce a finite image on the default backend."""
    out = tmp_path / "quick.pfm"
    api.pbrt_init({"quiet": True, "quick": True, "write": False,
                   "imageFile": str(out)})
    try:
        parser.parse_file(os.path.join(CORPUS, name))
        img = np.asarray(api._state.output)
    finally:
        api._state.__init__()
    assert np.all(np.isfinite(img))
    assert float(img.mean()) > 1e-5
