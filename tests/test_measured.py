"""Measured-BRDF loaders (MERL binary + .brdf text) and table evaluation.

Mirrors reference materials/measured.cpp:215 / core/reflection.cpp
RegularHalfangleBRDF + IrregIsotropicBRDF behavior on synthetic data.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.materials import measured as meas


def _write_const_merl(path, rgb=(0.3, 0.5, 0.2)):
    n = meas.TH * meas.TD * meas.PD
    scale = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])
    with open(path, "wb") as f:
        np.array([meas.TH, meas.TD, meas.PD], np.int32).tofile(f)
        planes = np.concatenate(
            [np.full(n, rgb[c] / scale[c], np.float64) for c in range(3)])
        planes.tofile(f)


def test_merl_roundtrip(tmp_path):
    fn = str(tmp_path / "const.binary")
    _write_const_merl(fn)
    table, albedo = meas.load_measured(fn)
    assert table.shape == (meas.TH, meas.TD, meas.PD, 3)
    np.testing.assert_allclose(table[0, 0, 0], [0.3, 0.5, 0.2], rtol=1e-5)
    np.testing.assert_allclose(table[-1, -1, -1], [0.3, 0.5, 0.2], rtol=1e-5)
    assert albedo.shape == (spec.N_BINS,)


def test_merl_eval_constant(tmp_path):
    fn = str(tmp_path / "const2.binary")
    _write_const_merl(fn, (0.25, 0.25, 0.25))
    table, _ = meas.load_measured(fn)
    tables = jnp.asarray(table)[None]
    h = 8
    rng = np.random.default_rng(0)
    wo = rng.normal(size=(h, 3)); wo[:, 2] = np.abs(wo[:, 2]) + 0.1
    wi = rng.normal(size=(h, 3)); wi[:, 2] = np.abs(wi[:, 2]) + 0.1
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    meas_id = jnp.zeros((h,), jnp.int32)
    f = meas.eval_measured(tables, meas_id, jnp.asarray(wo, jnp.float32),
                           jnp.asarray(wi, jnp.float32))
    expect = np.asarray(spec.from_rgb(np.full(3, 0.25, np.float32)))
    # the spectral fit in from_rgb is approximate (~0.5% wiggle)
    np.testing.assert_allclose(np.asarray(f), np.tile(expect, (h, 1)),
                               rtol=2e-2, atol=1e-3)
    # masked lanes are zero
    f0 = meas.eval_measured(tables, jnp.full((h,), -1, jnp.int32),
                            jnp.asarray(wo, jnp.float32),
                            jnp.asarray(wi, jnp.float32))
    assert float(jnp.max(jnp.abs(f0))) == 0.0


def test_brdf_text_loader(tmp_path):
    # constant isotropic data at a few wavelengths over a small angle set
    rows = []
    for ti in np.linspace(0.1, 1.4, 6):
        for to in np.linspace(0.1, 1.4, 6):
            for dphi in np.linspace(0.0, np.pi, 5):
                rows.append([ti, 0.0, to, dphi, 0.4, 0.4, 0.4])
    txt = "3\n400 550 700\n"
    txt += "\n".join(" ".join(f"{v:.6f}" for v in r) for r in rows)
    fn = str(tmp_path / "flat.brdf")
    with open(fn, "w") as f:
        f.write(txt)
    table, albedo = meas.load_measured(fn)
    assert table.shape == (meas.TH, meas.TD, meas.PD, 3)
    assert np.all(np.isfinite(table))
    # constant input -> roughly constant table away from grazing
    mid = table[10:60, 10:60, :, :]
    assert float(mid.std()) < 0.15
    assert float(mid.mean()) > 0.05


def test_measured_material_in_scene(tmp_path):
    """End-to-end: .pbrt scene with a measured material renders non-black."""
    from pbrt_tpu.scene import api, parser

    fn = tmp_path / "c.binary"
    _write_const_merl(str(fn), (0.6, 0.6, 0.6))
    scene_txt = f"""
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "point" "point from" [2 2 4] "color I" [40 40 40]
Material "measured" "string filename" ["{fn}"]
Shape "sphere" "float radius" [1]
WorldEnd
"""
    sf = tmp_path / "m.pbrt"
    sf.write_text(scene_txt)
    api.pbrt_init({"quiet": True, "write": False})
    try:
        parser.parse_file(str(sf))
        img = api._state.output
    finally:
        api._state.__init__()
    assert img.shape == (32, 32, 3)
    assert float(np.max(img)) > 0.01
    assert np.all(np.isfinite(img))
