"""Scene compiler: host records -> device tensors.

The tensor analog of RenderOptions::MakeScene + MakeRenderer
(reference core/api.cpp:1197-1288): instead of instantiating a
Primitive/Light object graph, lower everything to struct-of-arrays
tensors (SceneGeom, LightsT, VolumeT) plus a small host-side list of
unique materials whose textures are evaluated masked at shading time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.error import info, warning
from pbrt_tpu.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu.core.transform import Transform, xform_point_affine
from pbrt_tpu.accel.intersect import SceneGeom
from pbrt_tpu.lights.lighting import (
    EnvMap,
    L_AREA,
    L_DISTANT,
    L_GONIO,
    L_INFINITE,
    L_POINT,
    L_PROJECTION,
    L_SPOT,
    LightsT,
)
from pbrt_tpu.materials.bsdf import BsdfParams
from pbrt_tpu.materials.registry import KIND_ID, MaterialRecord
from pbrt_tpu.scene.records import RenderOptions, ShapeRecord
from pbrt_tpu.shapes.registry import QUAD_SPHERE, QuadricData, TriangleData, make_shape
from pbrt_tpu.textures.registry import ShadingGeom
from pbrt_tpu.volumes.registry import VolumeT, build_volumes

S = spec.N_BINS


@dataclass
class CompiledScene:
    """Host container; the jnp fields are closed over by jitted fns."""

    geom: SceneGeom
    lights: Optional[LightsT]
    envs: List[EnvMap]
    light_dist: Optional[Distribution1D]   # power-weighted pick CDF
    materials: List[MaterialRecord]        # index aligns with geom.*_mat
    material_dispersive: jnp.ndarray       # [M] bool
    volume: Optional[VolumeT]
    volume_records: list = field(default_factory=list)
    world_lo: np.ndarray = None
    world_hi: np.ndarray = None
    accel: object = None                   # BvhScene (set in compile_scene)
    kd_scale: object = None                # [M, S] diff-param albedo scale
    meas_tables: object = None             # [T,TH,TD,PD,3] measured BRDFs
    meas_index: dict = field(default_factory=dict)  # id(material) -> table row
    alpha_textures: list = field(default_factory=list)  # alpha masks

    # how many alpha-masked layers a single ray can punch through
    # (the reference's recursive skip is unbounded; 4 covers real scenes)
    ALPHA_LAYERS = 4

    @property
    def n_lights(self) -> int:
        return 0 if self.lights is None else int(self.lights.kind.shape[0])

    def _alpha_of(self, hit):
        """[R] alpha at each hit (1.0 for prims with no alpha texture).
        Reference shapes/trianglemesh.cpp:379-437: alpha evaluated at
        the hit's differential geometry; 0 means the hit is discarded."""
        from pbrt_tpu.textures.registry import ShadingGeom

        T = self.geom.n_tris
        is_tri = hit.valid & (hit.prim >= 0) & (hit.prim < max(T, 1))
        ai = jnp.where(is_tri,
                       self.geom.tri_alpha[jnp.clip(hit.prim, 0, max(T - 1, 0))],
                       -1)
        a = jnp.ones(hit.t.shape, jnp.float32)
        sg = ShadingGeom.at(hit.p, hit.uv)
        for k, tex in enumerate(self.alpha_textures):
            if isinstance(tex, float):
                v = jnp.full_like(a, tex)
            else:
                v = jnp.broadcast_to(
                    jnp.asarray(tex.eval(sg), jnp.float32), a.shape)
            a = jnp.where(ai == k, v, a)
        return a

    def _intersect_alpha(self, ray, coherent=False):
        """Closest hit skipping alpha==0 surfaces: bounded re-trace with
        tmin advanced past each masked hit."""
        from pbrt_tpu.core.geometry import Ray as _Ray

        hit = self.accel.intersect(ray, coherent=coherent)
        tmin = ray.tmin
        for _ in range(self.ALPHA_LAYERS):
            a = self._alpha_of(hit)
            masked = hit.valid & (a <= 0.0)
            tmin = jnp.where(masked, hit.t * (1.0 + 1e-4) + 1e-5, tmin)
            hit2 = self.accel.intersect(
                _Ray(ray.o, ray.d, tmin, ray.tmax, ray.time),
                coherent=coherent)

            def sel(new, old, m=masked):
                mm = m.reshape(m.shape + (1,) * (new.ndim - m.ndim))
                return jnp.where(mm, new, old)

            hit = jax.tree_util.tree_map(sel, hit2, hit)
        return hit

    def intersect(self, ray, coherent=False):
        """coherent: caller vouches the batch is beam-like (camera or
        light-convergent rays); selects the cheaper frustum cull in the
        packet pipeline. Safe either way — only performance changes."""
        if self.alpha_textures and self.geom.tri_alpha is not None:
            return self._intersect_alpha(ray, coherent=coherent)
        return self.accel.intersect(ray, coherent=coherent)

    def intersect_p(self, ray, coherent=False):
        if self.alpha_textures and self.geom.tri_alpha is not None:
            return self._intersect_alpha(ray, coherent=coherent).valid
        return self.accel.intersect_p(ray, coherent=coherent)


def _material_index(mat: Optional[MaterialRecord], materials: List[MaterialRecord],
                    index: Dict[int, int]) -> int:
    if mat is None:
        return -1
    key = id(mat)
    if key not in index:
        index[key] = len(materials)
        materials.append(mat)
    return index[key]


def compile_scene(ro: RenderOptions, accel_threshold: int = 64) -> CompiledScene:
    """Lower RenderOptions to device tensors (reference api.cpp:1197).

    Scenes with more than accel_threshold primitives get a BVH
    (split method from the Accelerator statement); tiny scenes stay on
    the brute-force blocked scan, which XLA fuses into one loop.
    """
    materials: List[MaterialRecord] = []
    mat_index: Dict[int, int] = {}

    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n, tri_has_n, tri_uv = [], [], []
    tri_mat, tri_light, tri_alpha = [], [], []
    alpha_textures: list = []          # unique alpha textures/constants
    alpha_index: Dict[int, int] = {}   # id(tex) -> row
    tri_dv0, tri_de1, tri_de2 = [], [], []  # motion-blur vertex deltas
    quads: List[Tuple[QuadricData, int, int]] = []  # (data, mat, light)
    quad_o2w_end: List[np.ndarray] = []
    any_motion = [False]

    # Area lights get one LightsT row per emitting shape record.
    area_rows = []  # (spectrum [S], tri_index_range | sphere info)
    al_v0, al_e1, al_e2, al_area = [], [], [], []

    def add_shape_record(srec: ShapeRecord, extra_xform: Optional[Transform] = None,
                         extra_xform_end: Optional[Transform] = None):
        o2w = srec.o2w if extra_xform is None else (extra_xform * srec.o2w)
        w2o = o2w.inverse()
        sd = make_shape(srec.kind, srec.params, o2w, w2o, srec.reverse_orientation)
        if sd is None:
            return
        # end-of-shutter transform (reference TransformedPrimitive,
        # core/primitive.h:115-117): shape and/or instance animated CTM
        base_end = srec.animated.end if srec.animated is not None else srec.o2w
        xe = extra_xform_end if extra_xform_end is not None else extra_xform
        o2w_end = base_end if xe is None else (xe * base_end)
        animated = not np.allclose(o2w_end.m, o2w.m, atol=1e-12)
        if animated:
            any_motion[0] = True
        # world-delta: v_end = delta @ v_start for already-baked vertices
        delta = (o2w_end.m @ np.linalg.inv(o2w.m)).astype(np.float64)
        mi = _material_index(srec.material, materials, mat_index)
        # alpha-texture masking row (reference trianglemesh.cpp:379-437)
        ai = -1
        if srec.alpha_tex is not None:
            key = id(srec.alpha_tex)
            if key not in alpha_index:
                alpha_index[key] = len(alpha_textures)
                alpha_textures.append(srec.alpha_tex)
            ai = alpha_index[key]
        li = -1
        if srec.area_light is not None:
            p = srec.area_light.params
            lemit = np.asarray(
                p.find_one_spectrum("L", spec.from_rgb(np.ones(3, np.float32))), np.float32
            )
            scale = np.asarray(
                p.find_one_spectrum("scale", spec.from_rgb(np.ones(3, np.float32))), np.float32
            )
            nsamp = p.find_one_int("nsamples", 1)
            li = len(area_rows)
            area_rows.append({
                "L": lemit * scale, "nsamples": nsamp,
                "tri_start": sum(len(a) for a in al_v0), "tri_count": 0,
                "is_sphere": False, "center": np.zeros(3, np.float32), "radius": 0.0,
                "area": 0.0,
            })
        for tri in sd.triangles:
            p = tri.p
            idx = tri.indices
            v0 = p[idx[:, 0]]
            v1 = p[idx[:, 1]]
            v2 = p[idx[:, 2]]
            tri_v0.append(v0)
            tri_e1.append(v1 - v0)
            tri_e2.append(v2 - v0)
            if animated:
                v0e = xform_point_affine(delta, v0).astype(np.float32)
                v1e = xform_point_affine(delta, v1).astype(np.float32)
                v2e = xform_point_affine(delta, v2).astype(np.float32)
                tri_dv0.append(v0e - v0)
                tri_de1.append((v1e - v0e) - (v1 - v0))
                tri_de2.append((v2e - v0e) - (v2 - v0))
            else:
                z = np.zeros_like(v0)
                tri_dv0.append(z)
                tri_de1.append(z)
                tri_de2.append(z)
            if tri.n is not None:
                tri_n.append(np.stack([tri.n[idx[:, 0]], tri.n[idx[:, 1]], tri.n[idx[:, 2]]], 1))
                tri_has_n.append(np.ones(len(idx), bool))
            else:
                tri_n.append(np.zeros((len(idx), 3, 3), np.float32))
                tri_has_n.append(np.zeros(len(idx), bool))
            if tri.uv is not None:
                tri_uv.append(np.stack([tri.uv[idx[:, 0]], tri.uv[idx[:, 1]], tri.uv[idx[:, 2]]], 1))
            else:
                default_uv = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
                tri_uv.append(np.tile(default_uv[None], (len(idx), 1, 1)))
            tri_mat.append(np.full(len(idx), mi, np.int32))
            tri_light.append(np.full(len(idx), li, np.int32))
            tri_alpha.append(np.full(len(idx), ai, np.int32))
            if li >= 0:
                e1, e2 = v1 - v0, v2 - v0
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                al_v0.append(v0)
                al_e1.append(e1)
                al_e2.append(e2)
                al_area.append(areas)
                area_rows[li]["tri_count"] += len(idx)
                area_rows[li]["area"] += float(areas.sum())
        for q in sd.quadrics:
            quads.append((q, mi, li))
            quad_o2w_end.append(
                (delta @ q.o2w).astype(np.float32) if animated
                else np.asarray(q.o2w, np.float32))
            if li >= 0:
                r = float(q.params[0])
                full_sphere = (
                    q.qtype == QUAD_SPHERE
                    and float(q.params[1]) <= -r + 1e-6
                    and float(q.params[2]) >= r - 1e-6
                    and float(q.params[3]) >= 2.0 * np.pi - 1e-5
                )
                if full_sphere:
                    # analytic cone sampling (reference shapes/sphere.cpp
                    # Sample with uniform-cone toward the sphere)
                    area_rows[li]["is_sphere"] = True
                    area_rows[li]["center"] = np.asarray(q.o2w[:3, 3], np.float32)
                    area_rows[li]["radius"] = r
                    area_rows[li]["area"] += 4.0 * np.pi * r * r
                else:
                    # partial sphere / disk / other quadric emitters:
                    # tessellate for light sampling only (shapes/registry
                    # .tessellate_quadric); intersection stays analytic
                    from pbrt_tpu.shapes.registry import tessellate_quadric

                    tv0, te1, te2, ta = tessellate_quadric(q)
                    al_v0.append(tv0)
                    al_e1.append(te1)
                    al_e2.append(te2)
                    al_area.append(ta)
                    area_rows[li]["tri_count"] += len(tv0)
                    area_rows[li]["area"] += float(ta.sum())

    for srec in ro.shapes:
        add_shape_record(srec)
    for inst in ro.instances:
        inst_end = inst.animated.end if inst.animated is not None else None
        for srec in inst.shapes:
            add_shape_record(srec, extra_xform=inst.i2w, extra_xform_end=inst_end)

    if tri_v0:
        TV0 = np.concatenate(tri_v0).astype(np.float32)
        TE1 = np.concatenate(tri_e1).astype(np.float32)
        TE2 = np.concatenate(tri_e2).astype(np.float32)
        TN = np.concatenate(tri_n).astype(np.float32)
        THN = np.concatenate(tri_has_n)
        TUV = np.concatenate(tri_uv).astype(np.float32)
        TM = np.concatenate(tri_mat)
        TL = np.concatenate(tri_light)
    else:
        TV0 = TE1 = TE2 = np.zeros((0, 3), np.float32)
        TN = np.zeros((0, 3, 3), np.float32)
        THN = np.zeros((0,), bool)
        TUV = np.zeros((0, 3, 2), np.float32)
        TM = TL = np.zeros((0,), np.int32)

    if any_motion[0] and tri_v0:
        TDV0 = np.concatenate(tri_dv0).astype(np.float32)
        TDE1 = np.concatenate(tri_de1).astype(np.float32)
        TDE2 = np.concatenate(tri_de2).astype(np.float32)
    else:
        TDV0 = TDE1 = TDE2 = None

    # world bound
    pts = [TV0, TV0 + TE1, TV0 + TE2]
    if TDV0 is not None:
        pts += [TV0 + TDV0, TV0 + TDV0 + TE1 + TDE1, TV0 + TDV0 + TE2 + TDE2]
    for qi, (q, _, _) in enumerate(quads):
        # transform object bbox corners (conservative)
        r = abs(float(q.params[0]))
        zmin, zmax = float(q.params[1]), float(q.params[2])
        lo = np.array([-r, -r, min(zmin, -r if q.qtype == QUAD_SPHERE else zmin)])
        hi = np.array([r, r, max(zmax, r if q.qtype == QUAD_SPHERE else zmax)])
        corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        pts.append(xform_point_affine(q.o2w, corners).astype(np.float32))
        if any_motion[0]:
            pts.append(xform_point_affine(quad_o2w_end[qi], corners).astype(np.float32))
    allp = np.concatenate([p for p in pts if len(p)]) if any(len(p) for p in pts) else np.zeros((1, 3), np.float32)
    world_lo = allp.min(0) - 1e-3
    world_hi = allp.max(0) + 1e-3

    geom = SceneGeom(
        tri_v0=jnp.asarray(TV0), tri_e1=jnp.asarray(TE1), tri_e2=jnp.asarray(TE2),
        tri_n=jnp.asarray(TN), tri_has_n=jnp.asarray(THN), tri_uv=jnp.asarray(TUV),
        tri_mat=jnp.asarray(TM), tri_light=jnp.asarray(TL),
        tri_alpha=(jnp.asarray(np.concatenate(tri_alpha))
                   if (alpha_textures and tri_alpha) else None),
        quad_type=jnp.asarray([q.qtype for q, _, _ in quads], jnp.int32),
        quad_o2w=jnp.asarray(np.stack([q.o2w for q, _, _ in quads]) if quads else np.zeros((0, 4, 4), np.float32)),
        quad_w2o=jnp.asarray(np.stack([q.w2o for q, _, _ in quads]) if quads else np.zeros((0, 4, 4), np.float32)),
        quad_params=jnp.asarray(np.stack([q.params for q, _, _ in quads]) if quads else np.zeros((0, 8), np.float32)),
        quad_mat=jnp.asarray([m for _, m, _ in quads], jnp.int32),
        quad_light=jnp.asarray([l for _, _, l in quads], jnp.int32),
        quad_flip=jnp.asarray(
            [q.reverse_orientation ^ q.swaps_handedness for q, _, _ in quads], bool
        ),
        world_lo=jnp.asarray(world_lo, jnp.float32),
        world_hi=jnp.asarray(world_hi, jnp.float32),
        tri_dv0=None if TDV0 is None else jnp.asarray(TDV0),
        tri_de1=None if TDE1 is None else jnp.asarray(TDE1),
        tri_de2=None if TDE2 is None else jnp.asarray(TDE2),
        quad_o2w_end=(jnp.asarray(np.stack(quad_o2w_end))
                      if (any_motion[0] and quad_o2w_end) else None),
        quad_w2o_end=(jnp.asarray(np.stack(
            [np.linalg.inv(m.astype(np.float64)).astype(np.float32)
             for m in quad_o2w_end]))
            if (any_motion[0] and quad_o2w_end) else None),
        time0=float(ro.transform_start_time),
        time1=float(ro.transform_end_time),
    )
    # packed single-gather reconstruct rows (accel/intersect.py
    # _reconstruct_packed; one row gather replaces ~15 padded gathers)
    from pbrt_tpu.accel.intersect import make_quad_pack, make_tri_pack

    q_o2w = np.stack([q.o2w for q, _, _ in quads]) if quads else np.zeros((0, 4, 4), np.float32)
    q_w2o = np.stack([q.w2o for q, _, _ in quads]) if quads else np.zeros((0, 4, 4), np.float32)
    q_params = np.stack([q.params for q, _, _ in quads]) if quads else np.zeros((0, 8), np.float32)
    q_end = (np.stack(quad_o2w_end) if (any_motion[0] and quad_o2w_end) else None)
    q_w2o_end = (np.stack([np.linalg.inv(mm.astype(np.float64)).astype(np.float32)
                           for mm in quad_o2w_end])
                 if (any_motion[0] and quad_o2w_end) else None)
    geom = geom._replace(
        tri_pack=jnp.asarray(make_tri_pack(
            TV0, TE1, TE2, TN, TUV, THN, TM, TL, TDV0, TDE1, TDE2)),
        quad_pack=jnp.asarray(make_quad_pack(
            q_o2w, q_w2o, q_params,
            [q.qtype for q, _, _ in quads],
            [q.reverse_orientation ^ q.swaps_handedness for q, _, _ in quads],
            [m for _, m, _ in quads], [l for _, _, l in quads],
            q_end, q_w2o_end)),
    )

    lights, envs, light_dist = _build_lights(ro, area_rows, al_v0, al_e1, al_e2, al_area,
                                             world_lo, world_hi)
    volume = build_volumes(ro.volume_regions)

    disp = np.asarray([m.dispersive() for m in materials], bool) if materials else np.zeros(0, bool)
    info(f"compiled scene: {len(TV0)} tris, {len(quads)} quadrics, "
         f"{0 if lights is None else int(lights.kind.shape[0])} lights, "
         f"{len(materials)} materials")

    from pbrt_tpu.accel.bvh import make_accel

    accel_name = ro.accelerator_name
    split = ro.accelerator_params.find_one_string("splitmethod", "sah")
    if accel_name not in ("bvh", "grid", "kdtree", "none"):
        warning(f'Accelerator "{accel_name}" unknown; using "bvh".')
        accel_name = "bvh"
    if accel_name == "grid":
        # uniform voxel grid with wavefront 3DDDA (accel/grid.py)
        from pbrt_tpu.accel.grid import make_grid_accel

        accel = make_grid_accel(geom)
    elif accel_name == "kdtree":
        # SAH kd-tree with short-stack wavefront traversal (accel/kdtree.py)
        from pbrt_tpu.accel.kdtree import make_kdtree_accel

        accel = make_kdtree_accel(geom, ro.accelerator_params)
    else:
        accel = make_accel(geom, split,
                           force="flat" if accel_name == "none" else "")
    # stack measured half-angle BRDF tables (materials/measured.py); each
    # measured material gets an index into the [T,TH,TD,PD,3] stack
    meas_tables = None
    meas_index = {}
    for m in materials:
        if m.kind == "measured" and "merl" in m.spectra:
            meas_index[id(m)] = len(meas_index)
    if meas_index:
        meas_tables = jnp.asarray(np.stack(
            [m.spectra["merl"] for m in materials
             if m.kind == "measured" and "merl" in m.spectra]))
    return CompiledScene(
        geom=geom, lights=lights, envs=envs, light_dist=light_dist,
        materials=materials, material_dispersive=jnp.asarray(disp),
        volume=volume, volume_records=list(ro.volume_regions),
        world_lo=world_lo, world_hi=world_hi, accel=accel,
        meas_tables=meas_tables, meas_index=meas_index,
        alpha_textures=alpha_textures,
    )


def _build_lights(ro: RenderOptions, area_rows, al_v0, al_e1, al_e2, al_area,
                  world_lo, world_hi):
    """Lower light records + collected area-light rows to LightsT."""
    kinds, l2w, spectra, params, power, nsamples = [], [], [], [], [], []
    env_specs = []  # (row_index, image_np, kind)
    world_c = 0.5 * (world_lo + world_hi)
    world_rad = float(np.linalg.norm(world_hi - world_c)) + 1e-3

    def add(kind, xform: Transform, spectrum, pr, pw, ns=1):
        kinds.append(kind)
        l2w.append(xform.m.astype(np.float32))
        spectra.append(np.asarray(spectrum, np.float32))
        p12 = np.zeros(12, np.float32)
        p12[: len(pr)] = pr
        params.append(p12)
        power.append(np.asarray(pw, np.float32))
        nsamples.append(ns)
        return len(kinds) - 1

    for rec in ro.lights:
        p = rec.params
        name = rec.kind
        ns = p.find_one_int("nsamples", 1)
        sc = np.asarray(p.find_one_spectrum("scale", spec.from_rgb(np.ones(3, np.float32))), np.float32)
        if name == "point":
            I = np.asarray(p.find_one_spectrum("I", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            xf = rec.l2w * Transform.translate(frm)
            add(L_POINT, xf, I, [], 4.0 * np.pi * I, ns)
        elif name == "spot":
            I = np.asarray(p.find_one_spectrum("I", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            cone = p.find_one_float("coneangle", 30.0)
            delta = p.find_one_float("conedeltaangle", 5.0)
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point("to", [0, 0, 1]), np.float64)
            d = to - frm
            dn = d / max(np.linalg.norm(d), 1e-12)
            # build light-to-world: +z along direction (reference spot.cpp)
            du = np.array([0.0, 1.0, 0.0]) if abs(dn[2]) > 0.9 else np.array([0.0, 0.0, 1.0])
            x = np.cross(du, dn); x /= max(np.linalg.norm(x), 1e-12)
            yv = np.cross(dn, x)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, yv, dn, frm
            xf = rec.l2w * Transform(m)
            cw = np.cos(np.deg2rad(cone))
            cf = np.cos(np.deg2rad(cone - delta))
            pw = I * 2.0 * np.pi * (1.0 - 0.5 * (cw + cf))
            add(L_SPOT, xf, I, [cw, cf], pw, ns)
        elif name == "goniometric":
            I = np.asarray(p.find_one_spectrum("I", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            fn = p.find_one_filename("mapname", "")
            img = _load_light_image(fn)
            row = add(L_GONIO, rec.l2w, I, [], 4.0 * np.pi * I * (img[1] if img else 1.0), ns)
            if img is not None:
                env_specs.append((row, img[0], L_GONIO))
        elif name == "projection":
            I = np.asarray(p.find_one_spectrum("I", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            fov = p.find_one_float("fov", 45.0)
            fn = p.find_one_filename("mapname", "")
            img = _load_light_image(fn)
            aspect = (img[0].shape[1] / img[0].shape[0]) if img else 1.0
            t = np.tan(np.deg2rad(fov) / 2.0)
            if aspect > 1.0:
                x0, x1, y0, y1 = -t * aspect, t * aspect, -t, t
            else:
                x0, x1, y0, y1 = -t, t, -t / aspect, t / aspect
            cw = np.cos(np.arctan(t * np.hypot(1.0, 1.0 / (1.0 if aspect <= 1 else aspect))))
            row = add(L_PROJECTION, rec.l2w, I, [cw, x0, x1, y0, y1, 1e-3],
                      2.0 * np.pi * (1.0 - cw) * I, ns)
            if img is not None:
                env_specs.append((row, img[0], L_PROJECTION))
        elif name == "distant":
            L = np.asarray(p.find_one_spectrum("L", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point("to", [0, 0, 1]), np.float64)
            d = frm - to  # direction TOWARD the light
            dn = rec.l2w.vector(d / max(np.linalg.norm(d), 1e-12))
            pw = L * np.pi * world_rad * world_rad
            add(L_DISTANT, Transform(), L, list(np.asarray(dn, np.float64)), pw, ns)
        elif name in ("infinite", "exinfinite"):
            L = np.asarray(p.find_one_spectrum("L", spec.from_rgb(np.ones(3, np.float32))), np.float32) * sc
            fn = p.find_one_filename("mapname", "")
            img = _load_light_image(fn)
            mean = img[1] if img else 1.0
            row = add(L_INFINITE, rec.l2w, L, [],
                      np.pi * world_rad * world_rad * L * mean,
                      p.find_one_int("nsamples", 1))
            env_specs.append((row, img[0] if img else np.ones((1, 1, 3), np.float32), L_INFINITE))
        else:
            warning(f'Light "{name}" unknown.')
            continue
        p.report_unused(f'in light "{name}"')

    for row in area_rows:
        pr = [row["area"], 1.0 if row["is_sphere"] else 0.0,
              row["center"][0], row["center"][1], row["center"][2], row["radius"],
              row["tri_start"], row["tri_count"]]
        add(L_AREA, Transform(), row["L"], pr, row["L"] * np.pi * row["area"],
            row["nsamples"])

    if not kinds:
        return None, [], None

    # area-light CDF within each segment (normalized per light)
    if al_v0:
        AV0 = np.concatenate(al_v0).astype(np.float32)
        AE1 = np.concatenate(al_e1).astype(np.float32)
        AE2 = np.concatenate(al_e2).astype(np.float32)
        AAR = np.concatenate(al_area).astype(np.float64)
        ACDF = np.zeros(len(AAR), np.float32)
        for row in area_rows:
            s, c = row["tri_start"], row["tri_count"]
            if c > 0:
                seg = AAR[s:s + c]
                ACDF[s:s + c] = (np.cumsum(seg) / max(seg.sum(), 1e-20)).astype(np.float32)
    else:
        AV0 = AE1 = AE2 = np.zeros((0, 3), np.float32)
        ACDF = np.zeros((0,), np.float32)

    L2W = np.stack(l2w)
    lights = LightsT(
        kind=jnp.asarray(kinds, jnp.int32),
        l2w=jnp.asarray(L2W),
        w2l=jnp.asarray(np.stack([np.linalg.inv(m) for m in L2W]).astype(np.float32)),
        spectra=jnp.asarray(np.stack(spectra)),
        params=jnp.asarray(np.stack(params)),
        power=jnp.asarray(np.stack(power)),
        n_samples=jnp.asarray(nsamples, jnp.int32),
        al_v0=jnp.asarray(AV0), al_e1=jnp.asarray(AE1), al_e2=jnp.asarray(AE2),
        al_cdf=jnp.asarray(ACDF),
    )

    envs = []
    for row, img, kind in env_specs:
        img_spec = spec.from_rgb(img.astype(np.float32))
        # importance: luminance * sin(theta) over rows (reference infinite.cpp:85)
        lum = spec.y(img_spec)
        h = img.shape[0]
        sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
        dist = Distribution2D.make(np.asarray(lum) * sin_t[:, None])
        envs.append(EnvMap(light_idx=row, image=jnp.asarray(np.asarray(img_spec, np.float32)),
                           dist=dist))

    # power-weighted light pick CDF (reference core/integrator.h:110)
    pw = np.stack([np.asarray(spec.y(np.asarray(p))) for p in power]).reshape(len(power))
    pw = np.maximum(pw, 1e-9)
    light_dist = Distribution1D.make(pw)
    return lights, envs, light_dist


def _load_light_image(fn: str):
    """-> (rgb [h, w, 3] float array, mean luminance) or None."""
    if not fn:
        return None
    from pbrt_tpu.io.image import read_image

    try:
        img = read_image(fn)
    except Exception as e:  # missing texture: warn, fall back to constant
        warning(f'Unable to read image "{fn}": {e}')
        return None
    mean = float(np.mean(0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]))
    return img, mean


# ---------------------------------------------------------------------------
# Shading-time material evaluation

def eval_bsdf_params(scene: CompiledScene, hit) -> BsdfParams:
    """Per-hit BsdfParams from the unique-material list, masked select.

    Texture graphs are Python closures evaluated batched; the loop over
    unique materials is unrolled in the trace (materials are few).
    """
    H = hit.p.shape[0]
    sg = ShadingGeom.at(hit.p, hit.uv)
    out = BsdfParams.none(H)
    meas_id = jnp.full((H,), -1, jnp.int32)
    has_mix = any(m.kind == "mix" for m in scene.materials)
    if has_mix:
        out = out._replace(mix2=BsdfParams.none(H),
                           mix_amt=jnp.ones((H, S), jnp.float32))

    def merge(sel, p, old):
        merged = BsdfParams(
            kind=jnp.where(sel, p.kind, old.kind),
            kd=jnp.where(sel[:, None], p.kd, old.kd),
            ks=jnp.where(sel[:, None], p.ks, old.ks),
            kr=jnp.where(sel[:, None], p.kr, old.kr),
            kt=jnp.where(sel[:, None], p.kt, old.kt),
            opacity=jnp.where(sel[:, None], p.opacity, old.opacity),
            rough_u=jnp.where(sel, p.rough_u, old.rough_u),
            rough_v=jnp.where(sel, p.rough_v, old.rough_v),
            eta=jnp.where(sel, p.eta, old.eta),
            vn=jnp.where(sel, p.vn, old.vn),
            sigma=jnp.where(sel, p.sigma, old.sigma),
        )
        if old.mix2 is not None:
            merged = merged._replace(
                mix2=merge(sel, p.mix2, old.mix2),
                mix_amt=jnp.where(sel[:, None], p.mix_amt, old.mix_amt),
            )
        return merged

    for mi, mat in enumerate(scene.materials):
        sel = hit.mat == mi
        p = _lower_material(mat, sg, H)
        if scene.kd_scale is not None:
            # differentiable-parameter hook (pbrt_tpu.diff): per-material
            # spectral scale on the diffuse albedo — gradients w.r.t.
            # BSDF albedos flow through here
            p = p._replace(kd=p.kd * scene.kd_scale[mi])
        if has_mix and p.mix2 is None:
            # non-mix materials in a mix scene: uniform pytree structure
            # (amount 1 routes all weight to the primary constituent)
            p = p._replace(mix2=BsdfParams.none(H),
                           mix_amt=jnp.ones((H, S), jnp.float32))
        out = merge(sel, p, out)
        if id(mat) in scene.meas_index:
            meas_id = jnp.where(sel, scene.meas_index[id(mat)], meas_id)
    if scene.meas_tables is not None:
        out = out._replace(meas_id=meas_id, meas_tables=scene.meas_tables)
    return out


def _tex_spec(mat, name, sg, H, default=0.0):
    tex = mat.textures.get(name)
    if tex is None:
        return jnp.full((H, S), default, jnp.float32)
    v = tex.eval(sg)
    v = jnp.asarray(v, jnp.float32)
    if v.ndim == 0:
        v = jnp.full((H, S), v)
    elif v.shape[-1] != S:
        v = jnp.broadcast_to(v[..., None], (H, S))
    return jnp.broadcast_to(v, (H, S))


def _tex_float(mat, name, sg, H, default=0.0):
    tex = mat.textures.get(name)
    if tex is None:
        return jnp.full((H,), default, jnp.float32)
    v = jnp.asarray(tex.eval(sg), jnp.float32)
    return jnp.broadcast_to(v, (H,))


def _lower_material(mat: MaterialRecord, sg: ShadingGeom, H: int) -> BsdfParams:
    """One material record -> full BsdfParams slots (see bsdf.material_lobes
    for the slot-per-kind conventions)."""
    kind = mat.kind
    zs = jnp.zeros((H, S), jnp.float32)
    zf = jnp.zeros((H,), jnp.float32)
    ones_s = jnp.ones((H, S), jnp.float32)
    kd = ks = kr = kt = zs
    opacity = ones_s
    rough_u = rough_v = zf
    eta = jnp.full((H,), 1.5, jnp.float32)
    vn = zf
    sigma = zf

    if kind == "matte":
        kd = _tex_spec(mat, "Kd", sg, H, 0.5)
        sigma = _tex_float(mat, "sigma", sg, H, 0.0)
    elif kind == "plastic":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "translucent":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        kr = _tex_spec(mat, "reflect", sg, H, 0.5)
        kt = _tex_spec(mat, "transmit", sg, H, 0.5)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "glass":
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        kt = _tex_spec(mat, "Kt", sg, H, 1.0)
        eta = _tex_float(mat, "index", sg, H, 1.5)
        vn = jnp.full((H,), mat.consts.get("Vn", 0.0), jnp.float32)
    elif kind == "mirror":
        kr = _tex_spec(mat, "Kr", sg, H, 0.9)
    elif kind == "metal":
        kd = jnp.broadcast_to(jnp.asarray(mat.spectra["eta"]), (H, S))
        ks = jnp.broadcast_to(jnp.asarray(mat.spectra["k"]), (H, S))
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.01)
    elif kind == "substrate":
        kd = _tex_spec(mat, "Kd", sg, H, 0.5)
        ks = _tex_spec(mat, "Ks", sg, H, 0.5)
        rough_u = _tex_float(mat, "uroughness", sg, H, 0.1)
        rough_v = _tex_float(mat, "vroughness", sg, H, 0.1)
    elif kind == "uber":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        kr = _tex_spec(mat, "Kr", sg, H, 0.0)
        kt = _tex_spec(mat, "Kt", sg, H, 0.0)
        opacity = _tex_spec(mat, "opacity", sg, H, 1.0)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
        eta = _tex_float(mat, "index", sg, H, 1.5)
    elif kind == "shinymetal":
        ks = _tex_spec(mat, "Ks", sg, H, 1.0)
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "measured":
        kd = jnp.broadcast_to(jnp.asarray(mat.spectra["albedo"]), (H, S))
    elif kind in ("subsurface", "kdsubsurface"):
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        eta = jnp.full((H,), mat.consts.get("index", 1.3), jnp.float32)
    elif kind == "mix":
        # TRUE two-constituent mix (reference materials/mixmat.cpp:62):
        # both children lowered to full param sets; bsdf_f/pdf/sample
        # evaluate BOTH lobe sets and blend by the spectral amount
        # (materials/bsdf.py mix wrappers). Nested mixes flatten to
        # their first constituent.
        m1, m2 = mat.children
        if any(getattr(c, "kind", None) == "mix" for c in (m1, m2)):
            from pbrt_tpu.core.error import warning
            warning("nested mix materials flatten to their first "
                    "constituent (mix(mix(a,b),c) renders as mix(a,c)); "
                    "the reference recursively concatenates ScaledBxDFs")
        amt = _tex_spec(mat, "amount", sg, H, 0.5)
        p1 = _lower_material(m1, sg, H)
        p2 = _lower_material(m2, sg, H)
        p2 = p2._replace(mix2=None, mix_amt=None)
        return p1._replace(mix2=p2, mix_amt=jnp.clip(amt, 0.0, 1.0))

    kid = KIND_ID.get(kind, KIND_ID["matte"])
    return BsdfParams(
        kind=jnp.full((H,), kid, jnp.int32),
        kd=kd, ks=ks, kr=kr, kt=kt, opacity=opacity,
        rough_u=rough_u, rough_v=rough_v, eta=eta, vn=vn, sigma=sigma,
    )


def eval_bump(scene: CompiledScene, hit, frame):
    """Bump-mapped shading normal (reference core/material.cpp Bump):
    displace p along dpdu/dpdv by the bump texture's finite differences
    and rebuild ns. No-op when no material carries a bumpmap."""
    if not any(m.textures.get("bumpmap") is not None for m in scene.materials):
        return frame
    H = hit.p.shape[0]
    du = 0.5 * (jnp.abs(hit.uv[:, 0]) + 1e-3)
    dv = 0.5 * (jnp.abs(hit.uv[:, 1]) + 1e-3)
    dpdv = jnp.cross(hit.ns, hit.dpdu)
    disp = jnp.zeros((H,), jnp.float32)
    disp_u = jnp.zeros((H,), jnp.float32)
    disp_v = jnp.zeros((H,), jnp.float32)
    for mi, mat in enumerate(scene.materials):
        tex = mat.textures.get("bumpmap")
        if tex is None:
            continue
        sel = hit.mat == mi
        sg0 = ShadingGeom.at(hit.p, hit.uv)
        sgu = ShadingGeom.at(hit.p + du[:, None] * hit.dpdu,
                             hit.uv + jnp.stack([du, jnp.zeros_like(du)], -1))
        sgv = ShadingGeom.at(hit.p + dv[:, None] * dpdv,
                             hit.uv + jnp.stack([jnp.zeros_like(dv), dv], -1))
        d0 = jnp.broadcast_to(jnp.asarray(tex.eval(sg0), jnp.float32), (H,))
        du_ = jnp.broadcast_to(jnp.asarray(tex.eval(sgu), jnp.float32), (H,))
        dv_ = jnp.broadcast_to(jnp.asarray(tex.eval(sgv), jnp.float32), (H,))
        disp = jnp.where(sel, d0, disp)
        disp_u = jnp.where(sel, du_, disp_u)
        disp_v = jnp.where(sel, dv_, disp_v)
    from pbrt_tpu.core.geometry import normalize as _norm

    dddu = (disp_u - disp) / jnp.maximum(du, 1e-6)
    dddv = (disp_v - disp) / jnp.maximum(dv, 1e-6)
    dpdu_b = hit.dpdu + dddu[:, None] * hit.ns
    dpdv_b = dpdv + dddv[:, None] * hit.ns
    ns = _norm(jnp.cross(dpdu_b, dpdv_b))
    # keep orientation consistent with the original shading normal
    ns = jnp.where((jnp.sum(ns * hit.ns, -1) < 0)[:, None], -ns, ns)
    ss = _norm(dpdu_b - ns * jnp.sum(dpdu_b * ns, -1, keepdims=True))
    ts = jnp.cross(ns, ss)
    return frame._replace(ss=ss, ts=ts, ns=ns)
