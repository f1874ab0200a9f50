"""Sampled spectra as `[..., N_BINS]` arrays (default 30 bins, 400-700nm).

Batched replacement for the reference's `SampledSpectrum`
(reference: core/spectrum.h:44-46 picks 30 bins over [400,700);
core/pbrt.h:157 makes it the active Spectrum type). A spectrum here is
just a jnp array whose last axis has N_BINS entries, so whole wavefronts
of spectra are 2D tensors and all ops are vectorized.

Color science matches the reference renderer bit-for-bit at the table
level so rendered images are comparable within MC noise:
- CIE 1931 x/y/z matching curves and the Smits-style RGB->spectrum
  basis spectra binned to the 30 samples (spectrum_data.py, derived
  offline the same way SampledSpectrum::Init derives them).
- from_rgb applies the reference's FromRGB basis mixing (min channel ->
  white, mid span -> secondary, max span -> primary; core/spectrum.cpp
  :154-243), vectorized over whole batches. This intentionally does NOT
  round-trip RGB exactly — neither does pbrt.

Student dispersion extensions (reference core/spectrum.h:253-324) map to
wavefront-friendly forms:
- splitSpectrum -> `sample_bin` (importance-pick ONE wavelength bin per
  lane, unbiased: value/pdf) and `split_all` (dense [N_BINS] one-hots).
- extractLambda -> carrying an explicit `lambda_idx` int lane field.
- filter(lambda) -> `band_filter` (identical 2-bin linear band-pass).
- intensityAt / toMonochromatic -> `intensity_at` / one-hot synthesis.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

N_BINS = 30
LAMBDA_START = 400.0
LAMBDA_END = 700.0

# Bin edges and representative wavelengths. The reference indexes bins with
# lambda_i = start + i*(end-start)/(n-1) in splitSpectrum (spectrum.h:254)
# and start + i*(end-start)/n in filter() (spectrum.h:307); we use bin
# midpoints for radiometry and mirror each quirk where behavior matters.
BIN_WIDTH = (LAMBDA_END - LAMBDA_START) / N_BINS
LAMBDAS_EDGE = np.linspace(LAMBDA_START, LAMBDA_END, N_BINS + 1)
LAMBDAS = 0.5 * (LAMBDAS_EDGE[:-1] + LAMBDAS_EDGE[1:])  # midpoints [30]
LAMBDAS_SPLIT = LAMBDA_START + np.arange(N_BINS) * (LAMBDA_END - LAMBDA_START) / (N_BINS - 1)


from pbrt_tpu.core import spectrum_data as _sd

# CIE matching curves averaged per bin exactly like SampledSpectrum::Init
# (reference core/spectrum.h:368-380): [3, 30]
CIE_XYZ_BINS = np.stack([_sd.CIE_X_BINS, _sd.CIE_Y_BINS, _sd.CIE_Z_BINS])
CIE_Y_INT = _sd.CIE_Y_INTEGRAL

# XYZ <-> linear RGB, the reference's literal matrices
# (reference core/spectrum.h:51-64 XYZToRGB / RGBToXYZ)
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)

# spectrum -> XYZ: xyz = (sum_i cie_i c_i) * (end-start)/(Y_integral * n)
# (reference core/spectrum.h:420-432 ToXYZ)
_S2XYZ = CIE_XYZ_BINS * ((LAMBDA_END - LAMBDA_START) / (CIE_Y_INT * N_BINS))
S2RGB = XYZ_TO_RGB @ _S2XYZ  # [3, 30]

# Smits RGB->spectrum basis spectra, binned: order matches the mixing
# algorithm below [white, cyan, magenta, yellow, red, green, blue]
_REFL_BASIS = np.stack([
    _sd.RGBRefl2SpectWhite_BINS, _sd.RGBRefl2SpectCyan_BINS,
    _sd.RGBRefl2SpectMagenta_BINS, _sd.RGBRefl2SpectYellow_BINS,
    _sd.RGBRefl2SpectRed_BINS, _sd.RGBRefl2SpectGreen_BINS,
    _sd.RGBRefl2SpectBlue_BINS,
])  # [7, 30]
_ILLUM_BASIS = np.stack([
    _sd.RGBIllum2SpectWhite_BINS, _sd.RGBIllum2SpectCyan_BINS,
    _sd.RGBIllum2SpectMagenta_BINS, _sd.RGBIllum2SpectYellow_BINS,
    _sd.RGBIllum2SpectRed_BINS, _sd.RGBIllum2SpectGreen_BINS,
    _sd.RGBIllum2SpectBlue_BINS,
])
# trailing scale factors (reference core/spectrum.cpp:195,238)
_REFL_SCALE = 0.94
_ILLUM_SCALE = 0.86445

# jnp copies (float32) for device use
S2RGB_J = jnp.asarray(S2RGB, jnp.float32)
LAMBDAS_J = jnp.asarray(LAMBDAS, jnp.float32)
LAMBDAS_SPLIT_J = jnp.asarray(LAMBDAS_SPLIT, jnp.float32)


# ---------------------------------------------------------------------------
# Conversions

def to_xyz(s):
    return s @ jnp.asarray(_S2XYZ, s.dtype).T if isinstance(s, jnp.ndarray) else s @ _S2XYZ.T


def to_rgb(s):
    m = S2RGB_J if isinstance(s, jnp.ndarray) else S2RGB
    return s @ m.T


def y(s):
    """Luminance (CIE Y) of spectrum batch."""
    m = _S2XYZ[1]
    m = jnp.asarray(m, s.dtype) if isinstance(s, jnp.ndarray) else m
    return s @ m


def _smits_coeffs(rgb, xp):
    """Basis-mixing coefficients [..., 7] of the reference's FromRGB
    (core/spectrum.cpp:154-243): white gets the min channel, one
    secondary (cyan/magenta/yellow) the mid-min span, one primary the
    max-mid span. Branch precedence (ties) matches the C++ if-chain."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    r_min = (r <= g) & (r <= b)
    g_min = ~r_min & (g <= r) & (g <= b)
    b_min = ~r_min & ~g_min
    zero = xp.zeros_like(r)
    white = xp.where(r_min, r, xp.where(g_min, g, b))
    cyan = xp.where(r_min, xp.where(g <= b, g - r, b - r), zero)
    magenta = xp.where(g_min, xp.where(r <= b, r - g, b - g), zero)
    yellow = xp.where(b_min, xp.where(r <= g, r - b, g - b), zero)
    blue = (xp.where(r_min & (g <= b), b - g, zero)
            + xp.where(g_min & (r <= b), b - r, zero))
    green = (xp.where(r_min & (g > b), g - b, zero)
             + xp.where(b_min & (r <= g), g - r, zero))
    red = (xp.where(g_min & (r > b), r - b, zero)
           + xp.where(b_min & (r > g), r - g, zero))
    return xp.stack([white, cyan, magenta, yellow, red, green, blue], -1)


def from_rgb(rgb, kind: str = "reflectance"):
    """RGB [..., 3] -> spectrum [..., 30] via the reference's Smits-style
    basis mixing (SampledSpectrum::FromRGB). NOT an exact round-trip:
    the basis desaturates slightly, identically to pbrt."""
    basis = _REFL_BASIS if kind == "reflectance" else _ILLUM_BASIS
    scale = _REFL_SCALE if kind == "reflectance" else _ILLUM_SCALE
    if isinstance(rgb, jnp.ndarray):
        c = _smits_coeffs(rgb, jnp)
        return jnp.clip(c @ jnp.asarray(basis * scale, jnp.float32), 0.0, None)
    rgb = np.asarray(rgb, np.float64)
    c = _smits_coeffs(rgb, np)
    return np.clip(c @ (basis * scale), 0.0, None).astype(np.float32)


def from_sampled(lambdas, values) -> np.ndarray:
    """Piecewise-linear SPD samples -> binned spectrum (host, NumPy).

    Exact piecewise-linear average over each bin with constant
    extension outside the sample range (reference core/spectrum.cpp
    AverageSpectrumSamples, :58-91).
    """
    lam = np.asarray(lambdas, np.float64)
    val = np.asarray(values, np.float64)
    order = np.argsort(lam, kind="stable")
    lam, val = lam[order], val[order]
    n = len(lam)

    def avg(l0, l1):
        if l1 <= lam[0]:
            return val[0]
        if l0 >= lam[-1]:
            return val[-1]
        if n == 1:
            return val[0]
        s = 0.0
        if l0 < lam[0]:
            s += val[0] * (lam[0] - l0)
        if l1 > lam[-1]:
            s += val[-1] * (l1 - lam[-1])
        i = 0
        while l0 > lam[i + 1]:
            i += 1

        def interp(w, i):
            t = (w - lam[i]) / (lam[i + 1] - lam[i])
            return val[i] * (1 - t) + val[i + 1] * t

        while i + 1 < n and l1 >= lam[i]:
            a, b = max(l0, lam[i]), min(l1, lam[i + 1])
            if b > a:
                s += 0.5 * (interp(a, i) + interp(b, i)) * (b - a)
            i += 1
        return s / (l1 - l0)

    out = np.array([avg(LAMBDAS_EDGE[i], LAMBDAS_EDGE[i + 1])
                    for i in range(N_BINS)])
    return out.astype(np.float32)


def constant(v, shape=()):
    return jnp.full(shape + (N_BINS,), v, jnp.float32)


def blackbody(temp_k: float) -> np.ndarray:
    """Planck blackbody SPD binned (host), normalized to max 1."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lam_m = LAMBDAS * 1e-9
    le = (2 * h * c * c) / (lam_m ** 5 * (np.exp(h * c / (lam_m * kb * temp_k)) - 1.0))
    return (le / le.max()).astype(np.float32)


# ---------------------------------------------------------------------------
# Student dispersion extensions, wavefront form

def intensity_at(s, lam):
    """Linear interp of bin values at wavelength lam (spectrum.h:281-291).

    Uses the reference's (n-1) grid: index = (lam-400)/ (300/29).
    """
    delta = (LAMBDA_END - LAMBDA_START) / (N_BINS - 1)
    iw = (lam - LAMBDA_START) / delta
    i0 = jnp.clip(jnp.floor(iw).astype(jnp.int32), 0, N_BINS - 2)
    t = iw - i0
    v0 = jnp.take_along_axis(s, i0[..., None], axis=-1)[..., 0]
    v1 = jnp.take_along_axis(s, (i0 + 1)[..., None], axis=-1)[..., 0]
    return (1.0 - t) * v0 + t * v1


def band_filter(s, lam):
    """2-bin linear band-pass at lam (reference spectrum.h filter()).

    Out-of-range lam -> zero spectrum. Mirrors the reference's weights:
    bin i gets c[i]*t, bin i+1 gets c[i+1]*(1-t) with
    i = floor((lam-400)/(300/n)).
    """
    delta = (LAMBDA_END - LAMBDA_START) / N_BINS
    iw = (lam - LAMBDA_START) / delta
    idx = jnp.floor(iw).astype(jnp.int32)
    t = iw - idx
    valid = (lam >= LAMBDA_START) & (lam < LAMBDA_END)
    idx = jnp.clip(idx, 0, N_BINS - 1)
    bins = jnp.arange(N_BINS)
    w = jnp.where(bins == idx[..., None], t[..., None], 0.0)
    w = w + jnp.where(bins == (idx + 1)[..., None], (1.0 - t)[..., None], 0.0)
    return jnp.where(valid[..., None], s * w, 0.0)


def one_hot(idx, value=1.0):
    """Monochromatic spectrum: one-hot at bin idx scaled by value."""
    oh = (jnp.arange(N_BINS) == idx[..., None]).astype(jnp.float32)
    return oh * jnp.asarray(value)[..., None]


def bin_wavelength(idx):
    """Wavelength carried by bin idx, matching splitSpectrum's grid."""
    return jnp.take(LAMBDAS_SPLIT_J, idx)


def sample_bin(s, u):
    """Importance-sample ONE wavelength bin per lane: returns (idx, weight).

    weight = total/pdf adjustment such that one_hot(idx)*s[idx]/pdf is an
    unbiased estimator of the dense spectrum. This replaces the
    reference's splitSpectrum 1->k enumeration (photonshooter.cpp:141-145)
    with fixed lane count for the wavefront.
    """
    tot = jnp.sum(s, axis=-1)
    p = s / jnp.maximum(tot[..., None], 1e-20)
    cdf = jnp.cumsum(p, axis=-1)
    idx = jnp.sum((u[..., None] > cdf).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, N_BINS - 1)
    pdf = jnp.take_along_axis(p, idx[..., None], axis=-1)[..., 0]
    return idx, jnp.where(tot > 0, 1.0 / jnp.maximum(pdf, 1e-20), 0.0)


def is_black(s):
    return jnp.all(s <= 0.0, axis=-1)
