"""Measured-BRDF support: MERL binary (.merl/.binary) and pbrt
irregular-isotropic text (.brdf) loaders + device evaluation.

Reference: materials/measured.cpp:215 (CreateMeasuredMaterial),
core/reflection.h:482-509 (IrregIsotropicBRDF / RegularHalfangleBRDF)
and core/reflection.cpp (their f() implementations).

Wavefront design: both formats are lowered at load time to ONE regular
half-angle table [TH, TD, PD, 3] (RGB), the MERL parameterization
(theta_half sqrt-mapped, theta_diff, phi_diff). Evaluation is then a
single nearest-cell gather per lane — no kd-tree visitor (the
reference's IrregIsotropicBRDF does a Gaussian-weighted kNN in a
remapped point space; we bake that interpolation into the grid once on
the host instead, keeping the device path branch-free).
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.error import warning

# MERL native resolution (reference core/reflection.cpp RegularHalfangleBRDF)
TH, TD, PD = 90, 90, 180
# MERL color scales (reference materials/measured.cpp MERL read loop)
_MERL_SCALE = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0], np.float64)

_CACHE: dict = {}


def load_measured(fn: str):
    """Load a measured BRDF file -> (table [TH,TD,PD,3] f32, albedo [S] f32).

    Returns None on failure (caller falls back to grey lambertian).
    """
    key = os.path.abspath(fn)
    if key in _CACHE:
        return _CACHE[key]
    try:
        if fn.endswith(".brdf"):
            table = _load_irreg_isotropic(fn)
        else:
            table = _load_merl(fn)
    except Exception as e:
        warning(f'measured BRDF "{fn}": {e}')
        return None
    albedo = _hemispherical_albedo(table)
    out = (table, albedo)
    _CACHE[key] = out
    return out


def _load_merl(fn: str) -> np.ndarray:
    """MERL binary: 3 int32 dims, then 3*n float64 in R,G,B planes with
    phi_d fastest (reference materials/measured.cpp binary branch)."""
    with open(fn, "rb") as f:
        dims = np.fromfile(f, np.int32, 3)
        if dims.size != 3:
            raise ValueError("truncated MERL header")
        n = int(dims[0]) * int(dims[1]) * int(dims[2])
        if n != TH * TD * PD:
            raise ValueError(f"unexpected MERL dims {tuple(dims)}")
        vals = np.fromfile(f, np.float64, 3 * n)
        if vals.size != 3 * n:
            raise ValueError("truncated MERL data")
    planes = vals.reshape(3, n) * _MERL_SCALE[:, None]
    table = planes.T.reshape(TH, TD, PD, 3)
    return np.maximum(table, 0.0).astype(np.float32)


def _load_irreg_isotropic(fn: str) -> np.ndarray:
    """pbrt .brdf text: nWls, wavelengths, then rows of
    (theta_i, phi_i, theta_o, phi_o, s_0..s_{nWls-1}) — reference
    materials/measured.cpp .brdf branch. Resampled onto the regular
    half-angle grid by Gaussian-weighted kNN in the reference's
    BRDFRemap point space (reference core/reflection.cpp BRDFRemap,
    IrregIsotropicBRDF::f exp(-100 d^2) falloff)."""
    vals = []
    with open(fn) as f:
        for line in f:
            line = line.split("#", 1)[0]
            vals.extend(float(t) for t in line.split())
    vals = np.asarray(vals, np.float64)
    if vals.size < 1:
        raise ValueError("empty .brdf file")
    n_wls = int(vals[0])
    if n_wls <= 0 or (vals.size - 1 - n_wls) % (4 + n_wls) != 0:
        raise ValueError("excess or shortage of data in .brdf file")
    wls = vals[1 : 1 + n_wls]
    rows = vals[1 + n_wls :].reshape(-1, 4 + n_wls)
    th_i, ph_i, th_o, ph_o = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    # spectral samples -> RGB (via the binned-spectrum pipeline)
    spectra = np.stack([spec.from_sampled(wls, r) for r in rows[:, 4:]])
    rgb_s = spec.to_rgb(spectra)

    def sph(theta, phi):
        st = np.sin(theta)
        return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], -1)

    wo_s = sph(th_i, ph_i)
    wi_s = sph(th_o, ph_o)
    p_s = _brdf_remap(wo_s, wi_s)

    # regular grid cell centers -> (wo, wi) pairs -> remapped points
    wo_g, wi_g = _grid_directions()
    p_g = _brdf_remap(wo_g.reshape(-1, 3), wi_g.reshape(-1, 3))

    from scipy.spatial import cKDTree

    k = min(8, p_s.shape[0])
    tree = cKDTree(p_s)
    d, idx = tree.query(p_g, k=k)
    if k == 1:
        d, idx = d[:, None], idx[:, None]
    w = np.exp(-100.0 * d * d)
    w_sum = w.sum(-1, keepdims=True)
    # no nearby sample: fall back to plain nearest (reference returns the
    # kd-tree default 0 there; nearest avoids black holes in the grid)
    nearest = rgb_s[idx[:, 0]]
    blended = (w[..., None] * rgb_s[idx]).sum(1) / np.maximum(w_sum, 1e-30)
    rgb_g = np.where(w_sum > 1e-12, blended, nearest)
    table = rgb_g.reshape(TH, TD, PD, 3)
    return np.maximum(table, 0.0).astype(np.float32)


def _brdf_remap(wo: np.ndarray, wi: np.ndarray) -> np.ndarray:
    """Reference core/reflection.cpp BRDFRemap: isotropic (wo, wi) ->
    Point(sin_i*sin_o, dphi/pi, cos_i*cos_o)."""
    ci, co = wi[..., 2], wo[..., 2]
    si = np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    so = np.sqrt(np.maximum(0.0, 1.0 - co * co))
    phi_i = np.arctan2(wi[..., 1], wi[..., 0])
    phi_o = np.arctan2(wo[..., 1], wo[..., 0])
    dphi = phi_i - phi_o
    dphi = np.where(dphi < 0.0, dphi + 2.0 * np.pi, dphi)
    dphi = np.where(dphi > np.pi, 2.0 * np.pi - dphi, dphi)
    return np.stack([si * so, dphi / np.pi, ci * co], -1)


def _grid_directions():
    """Cell-center (wo, wi) direction pairs for the half-angle grid."""
    th_h = (np.arange(TH) + 0.5) / TH
    th_h = (th_h ** 2) * (np.pi / 2.0)  # inverse of the sqrt remap
    th_d = (np.arange(TD) + 0.5) / TD * (np.pi / 2.0)
    ph_d = (np.arange(PD) + 0.5) / PD * np.pi
    TH_g, TD_g, PD_g = np.meshgrid(th_h, th_d, ph_d, indexing="ij")
    # wh along (sin th, 0, cos th); wd relative to wh frame
    sh, ch = np.sin(TH_g), np.cos(TH_g)
    sd, cd = np.sin(TD_g), np.cos(TD_g)
    sp, cp = np.sin(PD_g), np.cos(PD_g)
    wd = np.stack([sd * cp, sd * sp, cd], -1)
    # rotate wd by th_h around y to get wi in the wh-at-pole frame
    wi = np.stack(
        [ch * wd[..., 0] + sh * wd[..., 2], wd[..., 1],
         -sh * wd[..., 0] + ch * wd[..., 2]], -1)
    wh = np.stack([sh, np.zeros_like(sh), ch], -1)
    wo = 2.0 * np.sum(wi * wh, -1, keepdims=True) * wh - wi
    return wo, wi


def _hemispherical_albedo(table: np.ndarray) -> np.ndarray:
    """Mean hemispherical-hemispherical RGB albedo -> spectrum [S].

    Integrates f * cos_i * cos_o over the half-angle grid (coarse MC by
    cell weights); used for lobe-selection weights and photon rho."""
    th_h = ((np.arange(TH) + 0.5) / TH) ** 2 * (np.pi / 2.0)
    # weight ~ solid-angle measure of the cell; dominated by sin terms
    w = np.sin(th_h)[:, None, None] * np.ones((TH, TD, PD))
    w = w / max(w.sum(), 1e-30)
    rgb = (table * w[..., None]).sum((0, 1, 2)) * np.pi
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.asarray(spec.from_rgb(rgb.astype(np.float32)), np.float32)


# ---------------------------------------------------------------------------
# Device evaluation

def eval_measured(tables, meas_id, wo, wi):
    """Gather measured BRDF values. tables [T,TH,TD,PD,3]; meas_id [H]
    (-1 for non-measured lanes); wo/wi [H,3] in the LOCAL shading frame.
    Returns f [H,S] (zero where meas_id<0).

    Mirrors reference core/reflection.cpp RegularHalfangleBRDF::f:
    half-angle coords with sqrt-remapped theta_h, nearest-cell lookup.
    """
    wh = wo + wi
    wh_len = jnp.sqrt(jnp.sum(wh * wh, -1))
    ok = wh_len > 1e-7
    wh = wh / jnp.maximum(wh_len, 1e-7)[..., None]
    flip = wh[..., 2:3] < 0.0
    wh = jnp.where(flip, -wh, wh)
    wi_l = jnp.where(flip, -wi, wi)

    th_h = jnp.arccos(jnp.clip(wh[..., 2], -1.0, 1.0))
    ph_h = jnp.arctan2(wh[..., 1], wh[..., 0])
    # rotate wi by -phi_h about z, then -theta_h about y (reference f())
    c, s = jnp.cos(-ph_h), jnp.sin(-ph_h)
    x = c * wi_l[..., 0] - s * wi_l[..., 1]
    y = s * wi_l[..., 0] + c * wi_l[..., 1]
    z = wi_l[..., 2]
    ct, st = jnp.cos(-th_h), jnp.sin(-th_h)
    wd = jnp.stack([ct * x + st * z, y, -st * x + ct * z], -1)
    th_d = jnp.arccos(jnp.clip(wd[..., 2], -1.0, 1.0))
    ph_d = jnp.arctan2(wd[..., 1], wd[..., 0])
    ph_d = jnp.where(ph_d < 0.0, ph_d + jnp.pi, ph_d)

    i_h = jnp.sqrt(jnp.clip(th_h / (jnp.pi / 2.0), 0.0, 1.0)) * TH
    i_d = th_d / (jnp.pi / 2.0) * TD
    i_p = ph_d / jnp.pi * PD
    i_h = jnp.clip(i_h.astype(jnp.int32), 0, TH - 1)
    i_d = jnp.clip(i_d.astype(jnp.int32), 0, TD - 1)
    i_p = jnp.clip(i_p.astype(jnp.int32), 0, PD - 1)
    t = jnp.clip(meas_id, 0, tables.shape[0] - 1)
    rgb = tables[t, i_h, i_d, i_p]  # [H,3]
    f = spec.from_rgb(rgb)
    mask = (meas_id >= 0) & ok
    return jnp.where(mask[..., None], f, 0.0)
