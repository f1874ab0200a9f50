"""Pixel samplers: batched camera-sample generation.

Replaces reference samplers/*.cpp + core/sampler.h. The reference's
Sampler contract (GetMoreSamples / GetSubSampler window decomposition)
is a CPU-iterator design; the wavefront form generates ALL samples for a
pixel batch at once as flat arrays — the "sub-sampler window" becomes
the wavefront tile the render driver shards over devices.

Kinds: stratified (jittered strata), lowdiscrepancy (default; per-pixel
scrambled (0,2)-sequence, reference samplers/lowdiscrepancy.cpp:87),
halton (global Halton points scaled to the image), random, bestcandidate
(tiled precomputed dart-throwing table, bestcandidate.npy generated by
tools/samplepat — the analog of reference samplers/bestcandidate.out),
adaptive (min-samples pass + contrast veto; failing pixels are
re-rendered at maxsamples and the vetoed samples discarded, reference
samplers/adaptive.cpp:182-185 ReportResults contract — see
renderers/driver.py render_tile).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core.error import warning
from pbrt_tpu.core.sampling import halton_nd, sample02, van_der_corput
from pbrt_tpu.scene.paramset import ParamSet

S_STRATIFIED, S_LOWDISCREPANCY, S_HALTON, S_RANDOM, S_BESTCANDIDATE, S_ADAPTIVE = range(6)


def _round_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


@dataclass
class SamplerSpec:
    kind: int
    spp: int
    jitter: bool = True
    nx: int = 2            # stratified strata
    ny: int = 2
    adaptive_min: int = 4
    adaptive_max: int = 32
    adaptive_method: str = "contrast"  # or "shapeid"


def make_sampler(name: str, params: ParamSet, options=None) -> SamplerSpec:
    options = options or {}
    quick = bool(options.get("quick"))
    if name == "stratified":
        nx = params.find_one_int("xsamples", 2)
        ny = params.find_one_int("ysamples", 2)
        jitter = params.find_one_bool("jitter", True)
        if quick:
            nx, ny = 1, 1
        sp = SamplerSpec(S_STRATIFIED, nx * ny, jitter, nx, ny)
    elif name == "lowdiscrepancy" or name == "bestcandidate":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        kind = S_LOWDISCREPANCY if name == "lowdiscrepancy" else S_BESTCANDIDATE
        sp = SamplerSpec(kind, _round_pow2(ps))
    elif name == "halton":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_HALTON, ps)
    elif name == "random":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_RANDOM, ps)
    elif name == "adaptive":
        mn = params.find_one_int("minsamples", 4)
        mx = params.find_one_int("maxsamples", 32)
        method = params.find_one_string("method", "contrast")
        if method not in ("contrast", "shapeid"):
            warning(f'Adaptive sampling metric "{method}" unknown. '
                    'Using "contrast".')
            method = "contrast"
        if quick:
            mn, mx = 1, 2
        sp = SamplerSpec(S_ADAPTIVE, _round_pow2(mx), adaptive_min=mn,
                         adaptive_max=mx, adaptive_method=method)
    else:
        warning(f'Sampler "{name}" unknown; using "lowdiscrepancy".')
        return make_sampler("lowdiscrepancy", params, options)
    params.report_unused(f'in sampler "{name}"')
    return sp


class CameraSamples(NamedTuple):
    px: jnp.ndarray       # [N] continuous raster x
    py: jnp.ndarray       # [N]
    u_lens1: jnp.ndarray  # [N]
    u_lens2: jnp.ndarray
    u_time: jnp.ndarray
    pixel: jnp.ndarray    # [N] int32 flat pixel index (for film/adaptive)


import functools
import os


@functools.lru_cache(maxsize=8)
def _bc_buckets(spp: int):
    """Bucket the committed best-candidate table (tools/samplepat, the
    analog of reference samplers/bestcandidate.out) into a [W*W, spp, 2]
    per-pixel layout: the table tiles a W x W pixel window with ~spp
    points per pixel; short cells are topped up with jittered points."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bestcandidate.npy")
    pts = np.load(path)                       # [N, 2] in [0,1)^2
    n = len(pts)
    w = max(1, int(np.sqrt(n / max(spp, 1))))
    cell = np.minimum((pts * w).astype(np.int64), w - 1)
    cid = cell[:, 0] * w + cell[:, 1]
    frac = pts * w - cell                     # offset within the pixel
    out = np.zeros((w * w, spp, 2), np.float32)
    rng = np.random.RandomState(11)
    fill = rng.rand(w * w, spp, 2).astype(np.float32)
    counts = np.zeros(w * w, np.int64)
    out[:] = fill
    for i in range(n):
        c = cid[i]
        if counts[c] < spp:
            out[c, counts[c]] = frac[i]
            counts[c] += 1
    return w, jnp.asarray(out)


def _wang_hash(x):
    """Cheap uint32 mixer for per-pixel scrambles (decorrelates the
    (0,2)-sequence between pixels; same role as the reference's RNG-drawn
    scramble words, lowdiscrepancy.cpp LDPixelSample)."""
    x = jnp.asarray(x, jnp.uint32)
    x = (x ^ jnp.uint32(61)) ^ (x >> 16)
    x = x * jnp.uint32(9)
    x = x ^ (x >> 4)
    x = x * jnp.uint32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def camera_samples(spec: SamplerSpec, pix_x, pix_y, width: int, seed: int = 0) -> CameraSamples:
    """Generate spec.spp camera samples for each pixel in the batch.

    pix_x/pix_y: [P] int32 pixel coords. Returns flat arrays [P * spp]
    ordered sample-major per pixel. Deterministic in (pixel, seed).
    """
    P = pix_x.shape[0]
    spp = spec.spp
    pid = (pix_y.astype(jnp.int32) * width + pix_x.astype(jnp.int32))
    pix_xf = jnp.repeat(pix_x.astype(jnp.float32), spp)
    pix_yf = jnp.repeat(pix_y.astype(jnp.float32), spp)
    pid_r = jnp.repeat(pid, spp)
    sidx = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), P)
    base = _wang_hash(pid_r.astype(jnp.uint32) + jnp.uint32(seed * 0x9E3779B9))

    if spec.kind == S_BESTCANDIDATE:
        # tiled precomputed table (reference samplers/bestcandidate.cpp:99
        # + bestcandidate.out): pixel (x, y) indexes its cell of the
        # W x W tile; in-pixel offsets come straight from the table
        w, buckets = _bc_buckets(spp)
        cellx = jnp.remainder(pix_x.astype(jnp.int32), w)
        celly = jnp.remainder(pix_y.astype(jnp.int32), w)
        cid = jnp.repeat(cellx * w + celly, spp)
        pt = buckets[cid, sidx.astype(jnp.int32)]   # [P*spp, 2]
        sx, sy = pt[:, 0], pt[:, 1]
        l1 = van_der_corput(sidx, _wang_hash(base + jnp.uint32(0x02E5BE93)))
        l2 = _uniform(base, sidx, 3)
        tm = van_der_corput(sidx, _wang_hash(base + jnp.uint32(0x368CC8B7)))
    elif spec.kind == S_LOWDISCREPANCY:
        sx = van_der_corput(sidx, base)
        sy_scr = _wang_hash(base + jnp.uint32(0x68BC21EB))
        from pbrt_tpu.core.sampling import sobol2

        sy = sobol2(sidx, sy_scr)
        l1 = van_der_corput(sidx, _wang_hash(base + jnp.uint32(0x02E5BE93)))
        l2 = sobol2(sidx, _wang_hash(base + jnp.uint32(0x967A889B)))
        tm = van_der_corput(sidx, _wang_hash(base + jnp.uint32(0x368CC8B7)))
    elif spec.kind == S_STRATIFIED or spec.kind == S_ADAPTIVE:
        nx = spec.nx if spec.kind == S_STRATIFIED else _round_pow2(int(np.sqrt(spp)))
        ny = max(1, spp // max(nx, 1))
        nx = max(nx, 1)
        ix = (sidx % jnp.uint32(nx)).astype(jnp.float32)
        iy = ((sidx // jnp.uint32(nx)) % jnp.uint32(max(ny, 1))).astype(jnp.float32)
        if spec.jitter:
            jx = _uniform(base, sidx, 0)
            jy = _uniform(base, sidx, 1)
        else:
            jx = jy = jnp.full_like(ix, 0.5)
        sx = (ix + jx) / nx
        sy = (iy + jy) / max(ny, 1)
        l1 = _uniform(base, sidx, 2)
        l2 = _uniform(base, sidx, 3)
        tm = _uniform(base, sidx, 4)
    elif spec.kind == S_HALTON:
        gidx = pid_r.astype(jnp.int32) * spp + sidx.astype(jnp.int32)
        h = halton_nd(gidx, 5)
        # Cranley-Patterson rotation per pixel to decorrelate
        rx = _uniform(base, jnp.zeros_like(sidx), 0)
        ry = _uniform(base, jnp.zeros_like(sidx), 1)
        sx = (h[..., 0] + rx) % 1.0
        sy = (h[..., 1] + ry) % 1.0
        l1, l2, tm = h[..., 2], h[..., 3], h[..., 4]
    else:  # RANDOM
        sx = _uniform(base, sidx, 0)
        sy = _uniform(base, sidx, 1)
        l1 = _uniform(base, sidx, 2)
        l2 = _uniform(base, sidx, 3)
        tm = _uniform(base, sidx, 4)

    return CameraSamples(
        px=pix_xf + sx, py=pix_yf + sy, u_lens1=l1, u_lens2=l2, u_time=tm,
        pixel=pid_r.astype(jnp.int32),
    )


def _uniform(base, sidx, dim: int):
    """Counter-based uniform in [0,1): hash(base, sample, dim)."""
    h = _wang_hash(base ^ (sidx * jnp.uint32(0x85EBCA6B))
                   ^ jnp.uint32((dim * 0xC2B2AE35) & 0xFFFFFFFF))
    return (h >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))


def integrator_uniform(pixel, sample_idx, depth: int, dim: int, seed: int = 0):
    """Per-lane uniform for integrator decisions, counter-based
    (replaces the reference's Sample 1D/2D request arrays with
    on-demand deterministic streams keyed by (pixel, sample, depth, dim))."""
    # seed may be a traced int32 (e.g. the photon shooter jits over it):
    # do the mixing in uint32 so no oversized Python literal reaches an op
    base = _wang_hash(
        jnp.asarray(pixel, jnp.uint32)
        ^ (jnp.asarray(sample_idx, jnp.uint32) * jnp.uint32(0x9E3779B9))
        ^ (jnp.asarray(seed, jnp.uint32) * jnp.uint32(0x51633E2D))
    )
    # depth/dim may be traced int32 (lax.scan/fori_loop over march steps
    # or gather samples): do the mixing in uint32 — identical mod-2^32
    # arithmetic to the Python-int path, so streams are unchanged.
    dmix = (jnp.asarray(depth, jnp.uint32) * jnp.uint32(0x68BC21EB)
            + jnp.asarray(dim, jnp.uint32) * jnp.uint32(0x02E5BE93))
    h = _wang_hash(base ^ dmix)
    return (h >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))


# --- adaptive sampler veto (reference samplers/adaptive.cpp) ---------------

ADAPTIVE_MAX_CONTRAST = 0.5


def adaptive_needs(y, n_pix: int, spp: int):
    """Contrast veto: per-pixel True when any of the pixel's spp sample
    luminances deviates from their mean by more than
    ADAPTIVE_MAX_CONTRAST (relative) — those pixels re-render at
    maxsamples and these samples are discarded (ReportResults false)."""
    ys = y.reshape(n_pix, spp)
    mean = jnp.mean(ys, axis=1, keepdims=True)
    contrast = jnp.abs(ys - mean) / jnp.maximum(mean, 1e-9)
    return jnp.any(contrast > ADAPTIVE_MAX_CONTRAST, axis=1) & (mean[:, 0] > 0)


def adaptive_needs_shapeid(prim, n_pix: int, spp: int):
    """Shape-id veto (reference samplers/adaptive.cpp:182-185
    "needsSupersampling, method shapeid"): supersample any pixel whose
    min-pass samples hit DIFFERENT primitives (or mix hits and misses)
    — a geometric-discontinuity detector. prim: [n_pix*spp] int32
    primary-hit primitive ids (-1 = miss)."""
    ps = prim.reshape(n_pix, spp)
    return jnp.any(ps != ps[:, :1], axis=1)
