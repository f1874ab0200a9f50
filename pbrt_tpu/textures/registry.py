"""Texture descriptors: host objects whose eval() emits jnp ops per hit batch.

Replaces the reference's Texture<T> plugin classes (reference
core/texture.{h,cpp}, textures/*.cpp, api.cpp:418-483 dispatch). The
texture graph of a scene is static, so evaluation is plain Python
recursion over descriptors at trace time — XLA sees one fused graph, no
virtual dispatch. Float textures eval to [H]; spectrum textures to
[H, N_BINS].

ShadingGeom carries the per-hit fields textures consume (world p, uv,
and screen-space differentials for antialiasing).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.error import warning
from pbrt_tpu.core.geometry import length, normalize, spherical_phi, spherical_theta
from pbrt_tpu.core.transform import Transform, xform_point_affine, xform_vector
from pbrt_tpu.textures import noise as perlin


class ShadingGeom(NamedTuple):
    p: jnp.ndarray       # [H, 3] world-space point
    uv: jnp.ndarray      # [H, 2]
    dpdx: jnp.ndarray    # [H, 3] screen-space differentials (may be zeros)
    dpdy: jnp.ndarray    # [H, 3]
    duvdx: jnp.ndarray   # [H, 2]
    duvdy: jnp.ndarray   # [H, 2]

    @staticmethod
    def at(p, uv=None):
        h = p.shape[:-1]
        z3 = jnp.zeros(h + (3,), jnp.float32)
        z2 = jnp.zeros(h + (2,), jnp.float32)
        return ShadingGeom(p, uv if uv is not None else z2, z3, z3, z2, z2)


# ---------------------------------------------------------------------------
# 2D / 3D mappings (reference core/texture.h TextureMapping2D/3D)

class UVMapping2D:
    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = su, sv, du, dv

    def map(self, sg: ShadingGeom):
        s = self.su * sg.uv[..., 0] + self.du
        t = self.sv * sg.uv[..., 1] + self.dv
        dsdx = self.su * sg.duvdx[..., 0]
        dtdx = self.sv * sg.duvdx[..., 1]
        dsdy = self.su * sg.duvdy[..., 0]
        dtdy = self.sv * sg.duvdy[..., 1]
        return s, t, dsdx, dtdx, dsdy, dtdy


class SphericalMapping2D:
    def __init__(self, w2t: Transform):
        self.w2t = jnp.asarray(w2t.m, jnp.float32)

    def _sphere(self, p):
        v = normalize(xform_point_affine(self.w2t, p))
        theta = spherical_theta(v)
        phi = spherical_phi(v)
        return theta * (1.0 / jnp.pi), phi * (1.0 / (2.0 * jnp.pi))

    def map(self, sg: ShadingGeom):
        s, t = self._sphere(sg.p)
        delta = 0.1
        sx, tx = self._sphere(sg.p + delta * sg.dpdx)
        sy, ty = self._sphere(sg.p + delta * sg.dpdy)
        dsdx, dtdx = (sx - s) / delta, (tx - t) / delta
        dsdy, dtdy = (sy - s) / delta, (ty - t) / delta
        # handle phi seam
        dtdx = jnp.where(dtdx > 0.5, 1.0 - dtdx, jnp.where(dtdx < -0.5, -(dtdx + 1), dtdx))
        dtdy = jnp.where(dtdy > 0.5, 1.0 - dtdy, jnp.where(dtdy < -0.5, -(dtdy + 1), dtdy))
        return s, t, dsdx, dtdx, dsdy, dtdy


class CylindricalMapping2D:
    def __init__(self, w2t: Transform):
        self.w2t = jnp.asarray(w2t.m, jnp.float32)

    def _cyl(self, p):
        v = normalize(xform_point_affine(self.w2t, p))
        return (jnp.pi + jnp.arctan2(v[..., 1], v[..., 0])) / (2.0 * jnp.pi), v[..., 2]

    def map(self, sg: ShadingGeom):
        s, t = self._cyl(sg.p)
        delta = 0.01
        sx, tx = self._cyl(sg.p + delta * sg.dpdx)
        sy, ty = self._cyl(sg.p + delta * sg.dpdy)
        return s, t, (sx - s) / delta, (tx - t) / delta, (sy - s) / delta, (ty - t) / delta


class PlanarMapping2D:
    def __init__(self, vs, vt, ds=0.0, dt=0.0):
        self.vs = jnp.asarray(vs, jnp.float32)
        self.vt = jnp.asarray(vt, jnp.float32)
        self.ds, self.dt = ds, dt

    def map(self, sg: ShadingGeom):
        s = self.ds + jnp.sum(sg.p * self.vs, -1)
        t = self.dt + jnp.sum(sg.p * self.vt, -1)
        dsdx = jnp.sum(sg.dpdx * self.vs, -1)
        dtdx = jnp.sum(sg.dpdx * self.vt, -1)
        dsdy = jnp.sum(sg.dpdy * self.vs, -1)
        dtdy = jnp.sum(sg.dpdy * self.vt, -1)
        return s, t, dsdx, dtdx, dsdy, dtdy


class IdentityMapping3D:
    def __init__(self, w2t: Transform):
        self.w2t = jnp.asarray(w2t.m, jnp.float32)

    def map(self, sg: ShadingGeom):
        p = xform_point_affine(self.w2t, sg.p)
        dpdx = xform_vector(self.w2t, sg.dpdx)
        dpdy = xform_vector(self.w2t, sg.dpdy)
        return p, dpdx, dpdy


def _make_mapping_2d(tex2world: Transform, tp) -> object:
    mtype = tp.find_string("mapping", "uv")
    if mtype == "uv":
        return UVMapping2D(
            tp.find_float("uscale", 1.0), tp.find_float("vscale", 1.0),
            tp.find_float("udelta", 0.0), tp.find_float("vdelta", 0.0),
        )
    if mtype == "spherical":
        return SphericalMapping2D(tex2world.inverse())
    if mtype == "cylindrical":
        return CylindricalMapping2D(tex2world.inverse())
    if mtype == "planar":
        return PlanarMapping2D(
            tp.find_vector("v1", [1, 0, 0]), tp.find_vector("v2", [0, 1, 0]),
            tp.find_float("udelta", 0.0), tp.find_float("vdelta", 0.0),
        )
    warning(f'2D texture mapping "{mtype}" unknown')
    return UVMapping2D()


# ---------------------------------------------------------------------------
# Texture descriptors

class Texture:
    spectral: bool = False

    def eval(self, sg: ShadingGeom):
        raise NotImplementedError

    def mean(self) -> float:
        """Rough average value (for light-power estimates)."""
        return 1.0


class ConstantTexture(Texture):
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self.spectral = self.value.ndim > 0

    def eval(self, sg: ShadingGeom):
        h = sg.p.shape[:-1]
        v = jnp.asarray(self.value)
        return jnp.broadcast_to(v, h + v.shape)

    def mean(self):
        return float(np.mean(self.value))


class ScaleTexture(Texture):
    def __init__(self, tex1: Texture, tex2: Texture):
        self.tex1, self.tex2 = tex1, tex2
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        v1, v2 = self.tex1.eval(sg), self.tex2.eval(sg)
        if v1.ndim < v2.ndim:
            v1 = v1[..., None]
        elif v2.ndim < v1.ndim:
            v2 = v2[..., None]
        return v1 * v2

    def mean(self):
        return self.tex1.mean() * self.tex2.mean()


class MixTexture(Texture):
    def __init__(self, tex1: Texture, tex2: Texture, amount: Texture):
        self.tex1, self.tex2, self.amount = tex1, tex2, amount
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        t1, t2 = self.tex1.eval(sg), self.tex2.eval(sg)
        amt = self.amount.eval(sg)
        if t1.ndim > amt.ndim:
            amt = amt[..., None]
        return (1.0 - amt) * t1 + amt * t2


class BilerpTexture(Texture):
    def __init__(self, mapping, v00, v01, v10, v11, spectral: bool):
        self.mapping = mapping
        self.v00, self.v01 = np.asarray(v00, np.float32), np.asarray(v01, np.float32)
        self.v10, self.v11 = np.asarray(v10, np.float32), np.asarray(v11, np.float32)
        self.spectral = spectral

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        if self.spectral:
            s, t = s[..., None], t[..., None]
        return (
            (1 - s) * (1 - t) * jnp.asarray(self.v00)
            + (1 - s) * t * jnp.asarray(self.v01)
            + s * (1 - t) * jnp.asarray(self.v10)
            + s * t * jnp.asarray(self.v11)
        )


class UVTexture(Texture):
    spectral = True

    def __init__(self, mapping):
        self.mapping = mapping

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        rgb = jnp.stack([s - jnp.floor(s), t - jnp.floor(t), jnp.zeros_like(s)], axis=-1)
        return spec.from_rgb(rgb)


class CheckerboardTexture2D(Texture):
    def __init__(self, mapping, tex1: Texture, tex2: Texture, aamode: str = "closedform"):
        self.mapping, self.tex1, self.tex2 = mapping, tex1, tex2
        self.aamode = aamode
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        s, t, dsdx, dtdx, dsdy, dtdy = self.mapping.map(sg)
        v1, v2 = self.tex1.eval(sg), self.tex2.eval(sg)
        if self.aamode == "closedform":
            ds = jnp.maximum(jnp.abs(dsdx), jnp.abs(dsdy))
            dt = jnp.maximum(jnp.abs(dtdx), jnp.abs(dtdy))
            s0, s1 = s - ds, s + ds
            t0, t1 = t - dt, t + dt

            def bump_int(x):
                return jnp.floor(x / 2.0) + 2.0 * jnp.maximum(x / 2.0 - jnp.floor(x / 2.0) - 0.5, 0.0)

            area2 = jnp.where(
                (ds > 0) & (dt > 0),
                (bump_int(s1) - bump_int(s0)) * (bump_int(t1) - bump_int(t0)),
                0.0,
            )
            sint = jnp.where(ds > 0, (bump_int(s1) - bump_int(s0)) / (2.0 * jnp.maximum(ds, 1e-20)), 0.0)
            tint = jnp.where(dt > 0, (bump_int(t1) - bump_int(t0)) / (2.0 * jnp.maximum(dt, 1e-20)), 0.0)
            amt = sint + tint - 2.0 * sint * tint
            amt = jnp.clip(amt, 0.0, 1.0)
            point_check = (jnp.floor(s).astype(jnp.int32) + jnp.floor(t).astype(jnp.int32)) % 2
            filtered = jnp.abs(dsdx) + jnp.abs(dsdy) + jnp.abs(dtdx) + jnp.abs(dtdy) > 1e-12
            amt = jnp.where(filtered, amt, point_check.astype(jnp.float32))
        else:
            amt = ((jnp.floor(s).astype(jnp.int32) + jnp.floor(t).astype(jnp.int32)) % 2).astype(
                jnp.float32
            )
        if v1.ndim > amt.ndim:
            amt = amt[..., None]
        return (1.0 - amt) * v1 + amt * v2

    def mean(self):
        return 0.5 * (self.tex1.mean() + self.tex2.mean())


class CheckerboardTexture3D(Texture):
    def __init__(self, mapping: IdentityMapping3D, tex1: Texture, tex2: Texture):
        self.mapping, self.tex1, self.tex2 = mapping, tex1, tex2
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        p, _, _ = self.mapping.map(sg)
        chk = (
            jnp.floor(p[..., 0]).astype(jnp.int32)
            + jnp.floor(p[..., 1]).astype(jnp.int32)
            + jnp.floor(p[..., 2]).astype(jnp.int32)
        ) % 2
        v1, v2 = self.tex1.eval(sg), self.tex2.eval(sg)
        amt = chk.astype(jnp.float32)
        if v1.ndim > amt.ndim:
            amt = amt[..., None]
        return (1.0 - amt) * v1 + amt * v2


class DotsTexture(Texture):
    def __init__(self, mapping, inside: Texture, outside: Texture):
        self.mapping, self.inside, self.outside = mapping, inside, outside
        self.spectral = inside.spectral or outside.spectral

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        s_cell, t_cell = jnp.floor(s + 0.5), jnp.floor(t + 0.5)
        cell = jnp.stack([s_cell, t_cell, jnp.full_like(s_cell, 0.5)], axis=-1)
        has_dot = perlin.noise(cell) > 0.0
        rad, maxshift = 0.35, 0.5 - 0.35
        s_center = s_cell + maxshift * perlin.noise(
            jnp.stack([s_cell + 1.5, t_cell + 2.8, jnp.full_like(s_cell, 0.5)], axis=-1)
        )
        t_center = t_cell + maxshift * perlin.noise(
            jnp.stack([s_cell + 4.5, t_cell + 9.8, jnp.full_like(s_cell, 0.5)], axis=-1)
        )
        ds, dt = s - s_center, t - t_center
        in_dot = has_dot & (ds * ds + dt * dt < rad * rad)
        vi, vo = self.inside.eval(sg), self.outside.eval(sg)
        m = in_dot
        if vi.ndim > m.ndim:
            m = m[..., None]
        return jnp.where(m, vi, vo)


class FBmTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        return perlin.fbm(p, length(dpdx), length(dpdy), self.roughness, self.octaves)


class WrinkledTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        return perlin.turbulence(p, length(dpdx), length(dpdy), self.roughness, self.octaves)


class WindyTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D):
        self.mapping = mapping

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        wind = perlin.fbm(0.1 * p, 0.1 * length(dpdx), 0.1 * length(dpdy), 0.5, 3)
        wave = perlin.fbm(p, length(dpdx), length(dpdy), 0.5, 6)
        return jnp.abs(wind) * wave


_MARBLE_COLORS = np.array(
    [
        [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
        [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
        [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
    ],
    np.float32,
)


class MarbleTexture(Texture):
    spectral = True

    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float,
                 scale: float, variation: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness
        self.scale, self.variation = scale, variation

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        p = p * self.scale
        marble = p[..., 1] + self.variation * perlin.fbm(
            p, self.scale * length(dpdx), self.scale * length(dpdy),
            self.roughness, self.octaves,
        )
        t = 0.5 + 0.5 * jnp.sin(marble)
        # cubic spline through the marble color ramp
        nseg = _MARBLE_COLORS.shape[0] - 3
        ti = jnp.clip((t * nseg).astype(jnp.int32), 0, nseg - 1)
        tt = t * nseg - ti
        c = jnp.asarray(_MARBLE_COLORS)
        c0, c1, c2, c3 = c[ti], c[ti + 1], c[ti + 2], c[ti + 3]
        s0 = (1 - tt)[..., None]
        s1 = tt[..., None]
        # Bezier-ish smoothing as in the reference's repeated lerp
        d0 = s0 * c0 + s1 * c1
        d1 = s0 * c1 + s1 * c2
        d2 = s0 * c2 + s1 * c3
        e0 = s0 * d0 + s1 * d1
        e1 = s0 * d1 + s1 * d2
        rgb = 1.5 * (s0 * e0 + s1 * e1)
        return spec.from_rgb(rgb)


class ImageMapTexture(Texture):
    """MIPMap'd image texture (reference textures/imagemap.cpp,
    core/mipmap.h). Stores a full mip pyramid. Filtering follows the
    reference's contract: EWA anisotropic filtering by DEFAULT
    (core/mipmap.h:50-97, `doTrilinear` defaults false), trilinear only
    when the scene asks for it. The EWA form has a fixed shape: instead of
    the reference's dynamic-extent ellipse raster loop (mipmap.h EWA),
    a FIXED number of Gaussian-weighted bilinear taps along the
    footprint's major axis, at the mip level set by the minor axis —
    the footprint-assembly approximation of EWA, static shapes by
    construction."""

    _cache: dict = {}
    N_EWA_TAPS = 8

    def __init__(self, mapping, filename: str, spectral: bool, trilinear=True,
                 max_aniso=8.0, wrap="repeat", scale=1.0, gamma=1.0):
        self.mapping = mapping
        self.spectral = spectral
        self.wrap = wrap
        self.scale = scale
        self.trilinear = bool(trilinear)
        self.max_aniso = float(max(max_aniso, 1.0))
        key = (filename, gamma)
        if key in ImageMapTexture._cache:
            img = ImageMapTexture._cache[key]
        else:
            try:
                from pbrt_tpu.io.image import read_image

                img = read_image(filename).astype(np.float32)
            except (OSError, ValueError, ImportError, KeyError,
                    NotImplementedError) as e:
                # reference textures/imagemap.cpp:78-80: missing file ->
                # single WHITE texel (times scale/gamma applied later)
                warning(f'Couldn\'t read image "{filename}": {e}; '
                        f'using white texel')
                img = np.ones((1, 1, 3), np.float32)
            if gamma != 1.0:
                img = np.power(np.maximum(img, 0.0), gamma)
            ImageMapTexture._cache[key] = img
        self.levels = self._build_pyramid(img)
        self._mean = float(img.mean())

    @staticmethod
    def _build_pyramid(img):
        levels = [jnp.asarray(img)]
        cur = img
        while max(cur.shape[0], cur.shape[1]) > 1:
            h = max(1, cur.shape[0] // 2)
            w = max(1, cur.shape[1] // 2)
            cur = cur[: 2 * h, : 2 * w].reshape(h, 2, w, 2, -1).mean(axis=(1, 3))
            levels.append(jnp.asarray(cur))
        return levels

    def mean(self):
        return self._mean * self.scale

    def _lookup_level(self, level_img, s, t):
        h, w = level_img.shape[0], level_img.shape[1]
        x = s * w - 0.5
        yv = t * h - 0.5
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(yv).astype(jnp.int32)
        fx = x - x0
        fy = yv - y0

        def wrap_idx(i, n):
            if self.wrap == "repeat":
                return jnp.mod(i, n)
            if self.wrap == "clamp":
                return jnp.clip(i, 0, n - 1)
            return jnp.clip(i, 0, n - 1)  # "black" handled via mask below

        def texel(xi, yi):
            v = level_img[wrap_idx(yi, h), wrap_idx(xi, w)]
            if self.wrap == "black":
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                v = jnp.where(ok[..., None], v, 0.0)
            return v

        v00 = texel(x0, y0)
        v10 = texel(x0 + 1, y0)
        v01 = texel(x0, y0 + 1)
        v11 = texel(x0 + 1, y0 + 1)
        fx_, fy_ = fx[..., None], fy[..., None]
        return (
            (1 - fx_) * (1 - fy_) * v00 + fx_ * (1 - fy_) * v10
            + (1 - fx_) * fy_ * v01 + fx_ * fy_ * v11
        )

    def _two_level_lerp(self, ss, tt, l0, fl):
        """Bilinear lookup at levels l0 and l0+1, lerped by fl. ss/tt
        may carry a leading taps axis broadcast against l0/fl [H]."""
        n_levels = len(self.levels)
        extra = ss.ndim - l0.ndim
        l0b = l0.reshape((1,) * extra + l0.shape)
        flb = fl.reshape((1,) * extra + fl.shape)
        out0 = self._lookup_level(self.levels[0], ss, tt)
        out1 = out0
        for i in range(1, n_levels):
            li = self._lookup_level(self.levels[i], ss, tt)
            out0 = jnp.where((l0b == i)[..., None], li, out0)
            out1 = jnp.where((l0b + 1 == i)[..., None], li, out1)
        return (1 - flb)[..., None] * out0 + flb[..., None] * out1

    def _ewa(self, s, t, dsdx, dtdx, dsdy, dtdy):
        """Anisotropic footprint filter (reference core/mipmap.h:50-97
        Lookup(..., dstdx, dstdy) -> EWA): mip level from the MINOR
        ellipse axis (clamped to maxanisotropy), Gaussian-weighted taps
        spread along the MAJOR axis."""
        lx = dsdx * dsdx + dtdx * dtdx
        ly = dsdy * dsdy + dtdy * dtdy
        swap = ly > lx
        maj_s = jnp.where(swap, dsdy, dsdx)
        maj_t = jnp.where(swap, dtdy, dtdx)
        maj_len = jnp.sqrt(jnp.maximum(jnp.maximum(lx, ly), 1e-16))
        min_len = jnp.sqrt(jnp.maximum(jnp.minimum(lx, ly), 1e-16))
        # clamp eccentricity (reference mipmap.h: scale minor up so
        # majorLength/minorLength <= maxAnisotropy)
        min_len = jnp.maximum(min_len, maj_len / self.max_aniso)
        n_levels = len(self.levels)
        lvl = jnp.clip(n_levels - 1 + jnp.log2(jnp.maximum(min_len, 1e-8)),
                       0.0, n_levels - 1)
        l0 = jnp.floor(lvl).astype(jnp.int32)
        fl = lvl - l0
        T = self.N_EWA_TAPS
        u = (jnp.arange(T, dtype=jnp.float32) + 0.5) / T - 0.5  # [-.5, .5)
        w = jnp.exp(-2.0 * (2.0 * u) ** 2)
        w = w / jnp.sum(w)
        ss = s[None, ...] + u.reshape((T,) + (1,) * s.ndim) * maj_s[None, ...]
        tt = t[None, ...] + u.reshape((T,) + (1,) * s.ndim) * maj_t[None, ...]
        taps = self._two_level_lerp(ss, tt, l0, fl)      # [T, H, C]
        return jnp.sum(w.reshape((T,) + (1,) * (taps.ndim - 1)) * taps, 0)

    def eval(self, sg):
        s, t, dsdx, dtdx, dsdy, dtdy = self.mapping.map(sg)
        n_levels = len(self.levels)
        if self.trilinear:
            # isotropic width = max differential (reference
            # mipmap.h triangle-filter path)
            width = jnp.maximum(
                jnp.maximum(jnp.abs(dsdx), jnp.abs(dtdx)),
                jnp.maximum(jnp.abs(dsdy), jnp.abs(dtdy)),
            )
            lvl = n_levels - 1 + jnp.log2(jnp.maximum(width, 1e-8))
            lvl = jnp.clip(lvl, 0.0, n_levels - 1)
            l0 = jnp.floor(lvl).astype(jnp.int32)
            rgb = self._two_level_lerp(s, t, l0, lvl - l0) * self.scale
        else:
            rgb = self._ewa(s, t, dsdx, dtdx, dsdy, dtdy) * self.scale
        if self.spectral:
            return spec.from_rgb(rgb)
        return rgb.mean(-1)


# ---------------------------------------------------------------------------
# Factory (reference core/api.cpp:418-483 MakeFloatTexture/MakeSpectrumTexture)

def make_texture(name: str, kind: str, tex2world: Transform, tp) -> Optional[Texture]:
    spectral = kind == "spectrum"

    def one(default):
        if spectral:
            return tp.get_spectrum_texture("tex1", default)
        return tp.get_float_texture("tex1", default)

    if name == "constant":
        if spectral:
            return ConstantTexture(tp.find_spectrum("value", 1.0))
        return ConstantTexture(np.float32(tp.find_float("value", 1.0)))
    if name == "scale":
        t1 = tp.get_spectrum_texture("tex1", 1.0) if spectral else tp.get_float_texture("tex1", 1.0)
        t2 = tp.get_spectrum_texture("tex2", 1.0) if spectral else tp.get_float_texture("tex2", 1.0)
        return ScaleTexture(t1, t2)
    if name == "mix":
        t1 = tp.get_spectrum_texture("tex1", 0.0) if spectral else tp.get_float_texture("tex1", 0.0)
        t2 = tp.get_spectrum_texture("tex2", 1.0) if spectral else tp.get_float_texture("tex2", 1.0)
        return MixTexture(t1, t2, tp.get_float_texture("amount", 0.5))
    if name == "bilerp":
        m = _make_mapping_2d(tex2world, tp)
        if spectral:
            return BilerpTexture(
                m, tp.find_spectrum("v00", 0.0), tp.find_spectrum("v01", 1.0),
                tp.find_spectrum("v10", 0.0), tp.find_spectrum("v11", 1.0), True,
            )
        return BilerpTexture(
            m, tp.find_float("v00", 0.0), tp.find_float("v01", 1.0),
            tp.find_float("v10", 0.0), tp.find_float("v11", 1.0), False,
        )
    if name == "uv":
        return UVTexture(_make_mapping_2d(tex2world, tp))
    if name == "checkerboard":
        dim = tp.find_int("dimension", 2)
        t1 = tp.get_spectrum_texture("tex1", 1.0) if spectral else tp.get_float_texture("tex1", 1.0)
        t2 = tp.get_spectrum_texture("tex2", 0.0) if spectral else tp.get_float_texture("tex2", 0.0)
        if dim == 3:
            return CheckerboardTexture3D(IdentityMapping3D(tex2world.inverse()), t1, t2)
        aa = tp.find_string("aamode", "closedform")
        return CheckerboardTexture2D(_make_mapping_2d(tex2world, tp), t1, t2, aa)
    if name == "dots":
        ti = tp.get_spectrum_texture("inside", 1.0) if spectral else tp.get_float_texture("inside", 1.0)
        to = tp.get_spectrum_texture("outside", 0.0) if spectral else tp.get_float_texture("outside", 0.0)
        return DotsTexture(_make_mapping_2d(tex2world, tp), ti, to)
    if name == "fbm":
        return FBmTexture(
            IdentityMapping3D(tex2world.inverse()),
            tp.find_int("octaves", 8), tp.find_float("roughness", 0.5),
        )
    if name == "wrinkled":
        return WrinkledTexture(
            IdentityMapping3D(tex2world.inverse()),
            tp.find_int("octaves", 8), tp.find_float("roughness", 0.5),
        )
    if name == "windy":
        return WindyTexture(IdentityMapping3D(tex2world.inverse()))
    if name == "marble":
        return MarbleTexture(
            IdentityMapping3D(tex2world.inverse()),
            tp.find_int("octaves", 8), tp.find_float("roughness", 0.5),
            tp.find_float("scale", 1.0), tp.find_float("variation", 0.2),
        )
    if name == "imagemap":
        m = _make_mapping_2d(tex2world, tp)
        fn = tp.find_filename("filename", "")
        gamma = tp.find_float(
            "gamma", 2.2 if fn.lower().endswith((".tga", ".png")) else 1.0
        )
        return ImageMapTexture(
            m, fn, spectral,
            trilinear=tp.find_bool("trilinear", False),
            max_aniso=tp.find_float("maxanisotropy", 8.0),
            wrap=tp.find_string("wrap", "repeat"),
            scale=tp.find_float("scale", 1.0),
            gamma=gamma,
        )
    warning(f'Texture "{name}" unknown.')
    return None
