"""SH rotation machinery (reference core/shrots.cpp / sh.h:55-58),
validated against the defining property: rotating coefficients must
equal rotating the function's argument."""
import numpy as np
import jax.numpy as jnp

from pbrt_tpu.core import sh as shm


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


def test_rotation_matches_function_rotation():
    """c' = M(R) c  must satisfy  sum c'_i Y_i(w) = sum c_i Y_i(R^T w)
    for every direction w — the definition of SH rotation."""
    rng = np.random.RandomState(7)
    lmax = 4
    T = shm.sh_terms(lmax)
    c = rng.normal(size=(T,)).astype(np.float32)
    for trial in range(3):
        R = _rot(rng.normal(size=3), rng.uniform(0, 2 * np.pi))
        c_rot = np.asarray(shm.rotate_sh(jnp.asarray(c), R, lmax))
        w = rng.normal(size=(64, 3))
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        Yw = np.asarray(shm.sh_evaluate(jnp.asarray(w, jnp.float32), lmax))
        YRtw = np.asarray(shm.sh_evaluate(
            jnp.asarray(w @ R, jnp.float32), lmax))  # rows: R^T w
        f_rotated_coeffs = Yw @ c_rot
        f_rotated_arg = YRtw @ c
        np.testing.assert_allclose(f_rotated_coeffs, f_rotated_arg,
                                   rtol=2e-4, atol=2e-4)


def test_rotation_blocks_are_orthogonal():
    rng = np.random.RandomState(3)
    R = _rot(rng.normal(size=3), 1.234)
    for l, bl in enumerate(shm.sh_rotation_blocks(R, 5)):
        np.testing.assert_allclose(bl @ bl.T, np.eye(2 * l + 1),
                                   atol=1e-10, err_msg=f"band {l}")


def test_zh_reprojection_is_exact_rotation():
    """glossyprt rotates a zonal (ZH) lobe by re-projection:
    c'_{lm} = z_l sqrt(4pi/(2l+1)) Y_{lm}(axis) (integrators/extra.py
    li_glossyprt). Verify that identity against the full rotation
    machinery — i.e. the re-projection IS the exact SH rotation of a
    ZH lobe, so the only approximation in glossyprt is the
    Torrance->ZH fit itself."""
    rng = np.random.RandomState(11)
    lmax = 4
    T = shm.sh_terms(lmax)
    z = rng.rand(lmax + 1)
    c = np.zeros(T, np.float32)
    for l in range(lmax + 1):
        c[shm.sh_index(l, 0)] = z[l]
    # rotation taking +z to an arbitrary axis
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    zhat = np.array([0.0, 0.0, 1.0])
    v = np.cross(zhat, axis)
    s = np.linalg.norm(v)
    if s < 1e-12:
        R = np.eye(3)
    else:
        ang = np.arctan2(s, float(zhat @ axis))
        R = _rot(v, ang)
    c_rot = np.asarray(shm.rotate_sh(jnp.asarray(c), R, lmax))
    # ZH re-projection identity
    Ya = np.asarray(shm.sh_evaluate(
        jnp.asarray(axis[None, :], jnp.float32), lmax))[0]
    c_zh = np.zeros(T)
    for l in range(lmax + 1):
        scale = z[l] * np.sqrt(4.0 * np.pi / (2 * l + 1))
        for m in range(-l, l + 1):
            c_zh[shm.sh_index(l, m)] = scale * Ya[shm.sh_index(l, m)]
    np.testing.assert_allclose(c_rot, c_zh, rtol=1e-3, atol=1e-4)
