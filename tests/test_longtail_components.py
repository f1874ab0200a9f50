"""Direct tests for the long-tail components that previously only ran
inside scene smoke tests: goniometric/projection lights and the
loopsubdiv/nurbs tessellators."""
import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_tpu.core.transform import Transform
from pbrt_tpu.scene.paramset import ParamSet


# ---------------------------------------------------------------------------
# lights

def _light_scene(tmp_path, kind, extra):
    """Compile a scene containing only one image-driven light."""
    from pbrt_tpu.io.image import write_image
    from pbrt_tpu.scene import api
    from pbrt_tpu.scene.compile import compile_scene

    # map: top half (v < 0.5) bright 1.0, bottom half dim 0.25
    img = np.full((16, 16, 3), 0.25, np.float32)
    img[:8, :, :] = 1.0
    fn = str(tmp_path / "map.pfm")
    write_image(fn, img)

    api._state.__init__()
    api.pbrt_init({"quiet": True})
    cam_p = ParamSet()
    cam_p.add("float", "fov", [45.0])
    api.pbrt_camera("perspective", cam_p)
    api.pbrt_world_begin()
    lp = ParamSet()
    lp.add("rgb", "I", [10.0, 10.0, 10.0])
    lp.add("string", "mapname", [fn])
    for k, vals in extra:
        lp.add(k.split()[0], k.split()[1], vals)
    api.pbrt_light_source(kind, lp)
    scene = compile_scene(api.get_state().render_options)
    api._state.__init__()
    return scene


def _L_at(scene, pts):
    from pbrt_tpu.lights.lighting import sample_light
    from pbrt_tpu.core import spectrum as spec

    p = jnp.asarray(np.asarray(pts, np.float32))
    n = p.shape[0]
    li = jnp.zeros((n,), jnp.int32)
    ls = sample_light(scene.lights, scene.envs, li, p,
                      jnp.full((n,), 0.5), jnp.full((n,), 0.5))
    return np.asarray(spec.y(ls.L))


def test_goniometric_light_uses_map(tmp_path):
    """Intensity scaled by the angular map (reference lights/
    goniometric.cpp:74: Scale(w) = image[theta, phi]): a receiver seen
    through the map's bright half must get 4x the dim half."""
    scene = _light_scene(tmp_path, "goniometric", [])
    y = _L_at(scene, [[0.0, 0.0, 2.0],    # light->pt along +z: theta 0
                      [0.0, 0.0, -2.0]])  # theta pi (bottom of map)
    assert y[0] > 0 and y[1] > 0
    np.testing.assert_allclose(y[0] / y[1], 4.0, rtol=0.05)


def test_projection_light_frustum_and_map(tmp_path):
    """Projection light: image modulates inside the fov frustum, zero
    outside (reference lights/projection.cpp:114)."""
    scene = _light_scene(tmp_path, "projection", [("float fov", [40.0])])
    y = _L_at(scene, [[0.0, 0.0, 3.0],     # on-axis: inside frustum
                      [0.0, 0.8, 3.0],     # upper part of the image
                      [0.0, -0.8, 3.0],    # lower part
                      [3.0, 0.0, 0.0]])    # perpendicular: outside
    assert y[0] > 0
    assert y[3] == 0.0
    # map halves differ by 4x (which half is up depends on the raster
    # convention; assert the asymmetry itself)
    hi, lo = max(y[1], y[2]), min(y[1], y[2])
    assert lo > 0
    np.testing.assert_allclose(hi / lo, 4.0, rtol=0.08)


# ---------------------------------------------------------------------------
# shapes

def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    return v, f


def test_loopsubdiv_icosahedron_smooths_toward_sphere():
    """Loop subdivision of a unit icosahedron: 4x triangles per level,
    vertices pulled inside the control hull toward a sphere-like limit
    surface with shrinking radius spread (reference shapes/
    loopsubdiv.cpp:497)."""
    from pbrt_tpu.shapes.loopsubdiv import make_loop_subdiv

    v, f = _icosahedron()

    def tess(nlevels):
        p = ParamSet()
        p.add("integer", "nlevels", [nlevels])
        p.add("integer", "indices", f.ravel().tolist())
        p.add("point", "P", v.ravel().tolist())
        return make_loop_subdiv(p, Transform())

    t1 = tess(1)
    t3 = tess(3)
    assert len(t3.indices) == 20 * 4 ** 3
    assert len(t1.indices) == 20 * 4
    r3 = np.linalg.norm(t3.p, axis=-1)
    # limit surface sits strictly inside the unit control hull, in a
    # tight nearly-spherical radius band (it is NOT a sphere — the
    # Loop limit of an icosahedron keeps ~3% radial variation)
    assert r3.max() <= 1.0 + 1e-5
    assert 0.68 < r3.min() and r3.max() < 0.76
    assert np.ptp(r3) < 0.05
    # the subdivided mesh stays watertight: every edge shared by 2 tris
    e = np.sort(t3.indices[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert np.all(counts == 2)


def test_nurbs_bilinear_patch_is_flat():
    """A bilinear NURBS patch (order 2, 2x2 control net) must
    tessellate exactly onto its plane with the right extent
    (reference shapes/nurbs.cpp:310)."""
    from pbrt_tpu.shapes.nurbs import make_nurbs

    p = ParamSet()
    p.add("integer", "nu", [2])
    p.add("integer", "nv", [2])
    p.add("integer", "uorder", [2])
    p.add("integer", "vorder", [2])
    p.add("float", "uknots", [0.0, 0.0, 1.0, 1.0])
    p.add("float", "vknots", [0.0, 0.0, 1.0, 1.0])
    p.add("point", "P", [0, 0, 0, 2, 0, 0, 0, 3, 0, 2, 3, 0])
    tri = make_nurbs(p, Transform())
    assert tri is not None and len(tri.indices) > 0
    assert np.abs(tri.p[:, 2]).max() < 1e-5
    assert abs(tri.p[:, 0].max() - 2.0) < 1e-4
    assert abs(tri.p[:, 1].max() - 3.0) < 1e-4
    # interior point check: the patch covers the rectangle
    assert tri.p[:, 0].min() < 1e-4 and tri.p[:, 1].min() < 1e-4
