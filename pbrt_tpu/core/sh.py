"""Real spherical harmonics: evaluation, projection, convolution.

Replaces reference core/sh.{h,cpp} (~700 LoC): SHTerms/SHIndex,
SHEvaluate (real SH basis via the standard recurrences), matrix-free
cosine-lobe convolution (lambda_l), and Monte Carlo projection of
environment maps / incident radiance. The z-axis rotation and the
full rotation matrices of shrots.cpp are replaced where consumed
(glossyprt) by re-projection, which vectorizes better than banded
rotation matrices.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def sh_terms(lmax: int) -> int:
    return (lmax + 1) * (lmax + 1)


def sh_index(l: int, m: int) -> int:
    return l * l + l + m


def _legendre_p(lmax: int, z):
    """Associated Legendre P_l^m(z) for all l<=lmax, m>=0.
    Returns dict[(l, m)] -> array like z. Standard recurrences
    (reference core/sh.cpp legendrep)."""
    P = {}
    P[(0, 0)] = jnp.ones_like(z)
    if lmax == 0:
        return P
    z2 = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    for m in range(0, lmax + 1):
        if m > 0:
            P[(m, m)] = (1.0 - 2.0 * m) * z2 * P[(m - 1, m - 1)]
        if m + 1 <= lmax:
            P[(m + 1, m)] = z * (2.0 * m + 1.0) * P[(m, m)]
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = (
                (2.0 * l - 1.0) * z * P[(l - 1, m)]
                - (l + m - 1.0) * P[(l - 2, m)]
            ) / (l - m)
    return P


def _K(l: int, m: int) -> float:
    from math import factorial, pi, sqrt

    return sqrt((2.0 * l + 1.0) * factorial(l - abs(m))
                / (4.0 * pi * factorial(l + abs(m))))


def sh_evaluate(w, lmax: int):
    """Real SH basis values at unit directions w [..., 3] ->
    [..., sh_terms(lmax)] (reference core/sh.h:55 SHEvaluate)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    P = _legendre_p(lmax, z)
    phi = jnp.arctan2(y, x)
    out = []
    sqrt2 = np.sqrt(2.0)
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            if m == 0:
                out.append(_K(l, 0) * P[(l, 0)])
            elif m > 0:
                out.append(sqrt2 * _K(l, m) * jnp.cos(m * phi) * P[(l, m)])
            else:
                out.append(sqrt2 * _K(l, m) * jnp.sin(-m * phi) * P[(l, -m)])
    return jnp.stack(out, axis=-1)


def lambda_l(lmax: int) -> np.ndarray:
    """Cosine-lobe convolution coefficients A_l (Ramamoorthi-Hanrahan),
    expanded per (l, m): E(n) = sum A_l c_lm Y_lm(n)
    (reference core/sh.cpp SHConvolveCosTheta). A_0 = pi, A_1 = 2pi/3,
    A_2 = pi/4, odd l > 1 vanish."""
    from math import factorial, pi

    coeffs = np.zeros(sh_terms(lmax))
    for l in range(lmax + 1):
        if l == 0:
            a = pi
        elif l == 1:
            a = 2.0 * pi / 3.0
        elif l % 2 == 1:
            a = 0.0
        else:
            a = (2.0 * pi * (-1.0) ** (l // 2 - 1)
                 / ((l + 2) * (l - 1))
                 * factorial(l) / (2 ** l * factorial(l // 2) ** 2))
        for m in range(-l, l + 1):
            coeffs[sh_index(l, m)] = a
    return coeffs


def project_function(fn_vals, dirs, weights, lmax: int):
    """MC/quadrature projection: sum_i w_i f_i Y(w_i).

    fn_vals [N, C], dirs [N, 3], weights [N] -> [terms, C]."""
    Y = sh_evaluate(dirs, lmax)  # [N, T]
    return jnp.einsum("nt,nc->tc", Y * weights[:, None], fn_vals)


def sphere_quadrature(n_theta: int = 32, n_phi: int = 64):
    """Product quadrature over the sphere -> (dirs [N,3], weights [N])."""
    th = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    ph = (np.arange(n_phi) + 0.5) / n_phi * 2.0 * np.pi
    T, PH = np.meshgrid(th, ph, indexing="ij")
    st = np.sin(T)
    dirs = np.stack([st * np.cos(PH), st * np.sin(PH), np.cos(T)], -1).reshape(-1, 3)
    w = (st * (np.pi / n_theta) * (2.0 * np.pi / n_phi)).reshape(-1)
    return jnp.asarray(dirs, jnp.float32), jnp.asarray(w, jnp.float32)


# ---------------------------------------------------------------------------
# SH rotation (reference core/shrots.cpp SHRotate / sh.h:55-58).
#
# The reference carries 1471 lines of generated per-band rotation code;
# this build computes the same block-diagonal real-SH rotation
# matrices with the Ivanic-Ruedenberg recurrence (J. Phys. Chem. 1996,
# with the 1998 errata signs) on the host — rotation matrices are tiny
# ((2l+1)^2 per band) and scene-constant, so host NumPy is the right
# site; applying them to coefficient vectors is a jnp matmul.

def _ir_block(l: int, R1, Rlm1):
    """Band-l rotation block from the band-1 matrix and band-(l-1)
    block. R1 indexed [m+1][n+1] (m,n in -1..1), Rlm1 is the previous
    (2l-1)^2 block indexed [m+l-1][n+l-1]."""
    import math

    def r1(i, j):
        return R1[i + 1][j + 1]

    def rp(a, b):
        return Rlm1[a + l - 1][b + l - 1]

    def P(i, a, b):
        if b == l:
            return r1(i, 1) * rp(a, l - 1) - r1(i, -1) * rp(a, -(l - 1))
        if b == -l:
            return r1(i, 1) * rp(a, -(l - 1)) + r1(i, -1) * rp(a, l - 1)
        return r1(i, 0) * rp(a, b)

    M = np.zeros((2 * l + 1, 2 * l + 1))
    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            if abs(n) < l:
                denom = (l + n) * (l - n)
            else:
                denom = (2 * l) * (2 * l - 1)
            u = math.sqrt((l + m) * (l - m) / denom)
            dm0 = 1.0 if m == 0 else 0.0
            v = (0.5 * math.sqrt((1 + dm0) * (l + abs(m) - 1) * (l + abs(m))
                                 / denom) * (1 - 2 * dm0))
            w = (-0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom)
                 * (1 - dm0))
            val = 0.0
            if u != 0.0:
                val += u * P(0, m, n)
            if v != 0.0:
                if m == 0:
                    V = P(1, 1, n) + P(-1, -1, n)
                elif m > 0:
                    d = 1.0 if m == 1 else 0.0
                    V = (P(1, m - 1, n) * math.sqrt(1 + d)
                         - P(-1, -(m - 1), n) * (1 - d))
                else:
                    d = 1.0 if m == -1 else 0.0
                    V = (P(1, m + 1, n) * (1 - d)
                         + P(-1, -(m + 1), n) * math.sqrt(1 + d))
                val += v * V
            if w != 0.0:
                if m > 0:
                    W = P(1, m + 1, n) + P(-1, -(m + 1), n)
                else:
                    W = P(1, m - 1, n) - P(-1, -(m - 1), n)
                val += w * W
            M[m + l][n + l] = val
    return M


def sh_rotation_blocks(R, lmax: int):
    """Per-band real-SH rotation matrices for world rotation R [3,3]:
    list of [2l+1, 2l+1] NumPy arrays with
    Y_l(R w) = M_l @ Y_l(w) for every band l (this package's
    sh_evaluate basis, which carries the Condon-Shortley phase).

    The Ivanic-Ruedenberg recurrence is stated for the CS-FREE real
    basis; since the two bases differ by the diagonal sign D_l =
    diag((-1)^m), each band is conjugated D_l M_l D_l on the way out
    (validated in tests/test_sh_rotation.py)."""
    R = np.asarray(R, np.float64)
    blocks = [np.ones((1, 1))]
    if lmax == 0:
        return blocks
    # band 1 (CS-free): real SH basis order (m=-1,0,1) spans (y, z, x)
    perm = [1, 2, 0]
    M1 = np.array([[R[perm[i]][perm[j]] for j in range(3)]
                   for i in range(3)])
    raw = [M1]
    prev = M1
    for l in range(2, lmax + 1):
        cur = _ir_block(l, M1, prev)
        raw.append(cur)
        prev = cur
    for l, bl in enumerate(raw, start=1):
        d = np.array([(-1.0) ** m for m in range(-l, l + 1)])
        blocks.append(bl * d[:, None] * d[None, :])
    return blocks


def sh_rotation_matrix(R, lmax: int) -> np.ndarray:
    """Block-diagonal [T, T] rotation of a full coefficient vector."""
    T = sh_terms(lmax)
    M = np.zeros((T, T))
    o = 0
    for bl in sh_rotation_blocks(R, lmax):
        n = bl.shape[0]
        M[o:o + n, o:o + n] = bl
        o += n
    return M


def rotate_sh(c, R, lmax: int):
    """Rotate SH coefficients: f'(w) = f(R^T w) <=> c' = M(R) c.
    c: [..., T] or [T, C]; returns the matching shape."""
    M = jnp.asarray(sh_rotation_matrix(R, lmax), jnp.float32)
    if c.ndim == 2 and c.shape[0] == M.shape[0]:
        return M @ c
    return jnp.einsum("ts,...s->...t", M, c)
