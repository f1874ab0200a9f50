"""BVH accelerator: host build (SAH / middle / equal / AAC), device
traversal over ray wavefronts.

Replaces reference accelerators/bvh.cpp. The reference already flattens
its tree into a LinearBVHNode array with first-child-adjacent layout
(bvh.cpp:154,559); we keep that layout as plain tensors:

  node_lo/node_hi [N, 3]   bounds
  node_meta      [N, 3]    (second_child|prim_offset, n_prims, axis)
                           n_prims == 0 -> interior

Split methods (reference bvh.cpp:196-204): "sah" (12-bucket binned,
bvh.cpp:476), "middle", "equal", and the student "aac" mode —
Approximate Agglomerative Clustering with 30-bit Morton codes
(bvh.cpp:47-78,258-389): sort by Morton code, recursively partition at
Morton bit boundaries down to <= delta prims, greedily merge clusters
bottom-up by minimum union surface area, keeping f(x) = c*x^alpha
clusters per level (delta=4, eps=0.2, c=0.5*delta^0.7, alpha=0.3,
reference bvh.h:85-91).

Device traversal: lockstep wavefront — every ray keeps a short stack in
a [R, DEPTH] register array inside one lax.while_loop; nodes are
gathered per lane. Front-to-back child ordering by ray direction sign
(reference bvh.cpp:585-638).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core.error import info, warning
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.core.transform import xform_point_affine, xform_vector
from pbrt_tpu.accel.intersect import (
    BIG,
    SceneGeom,
    _quad_candidates,
    _tri_t,
    reconstruct,
)

MAX_DEPTH = 64
LEAF_MAX = 4


class BVH(NamedTuple):
    node_lo: jnp.ndarray    # [N, 3]
    node_hi: jnp.ndarray    # [N, 3]
    node_meta: jnp.ndarray  # [N, 3] int32: (offset, n_prims, axis)
    prim_ids: jnp.ndarray   # [P] int32 global prim ids (leaf order)

    @property
    def n_nodes(self):
        return self.node_lo.shape[0]


# ---------------------------------------------------------------------------
# Host build

def _prim_bounds(geom: SceneGeom) -> Tuple[np.ndarray, np.ndarray]:
    """World bounds of every primitive (tris then quadrics)."""
    v0 = np.asarray(geom.tri_v0)
    e1 = np.asarray(geom.tri_e1)
    e2 = np.asarray(geom.tri_e2)
    p1, p2 = v0 + e1, v0 + e2
    lo_t = np.minimum(np.minimum(v0, p1), p2)
    hi_t = np.maximum(np.maximum(v0, p1), p2)
    if geom.tri_dv0 is not None:
        # motion: union with end-of-shutter vertex bounds (linear motion
        # stays within the endpoint hull per vertex)
        v0e = v0 + np.asarray(geom.tri_dv0)
        p1e = v0e + e1 + np.asarray(geom.tri_de1)
        p2e = v0e + e2 + np.asarray(geom.tri_de2)
        lo_t = np.minimum(lo_t, np.minimum(np.minimum(v0e, p1e), p2e))
        hi_t = np.maximum(hi_t, np.maximum(np.maximum(v0e, p1e), p2e))

    qt = np.asarray(geom.quad_type)
    qo2w = np.asarray(geom.quad_o2w)
    qo2w_end = None if geom.quad_o2w_end is None else np.asarray(geom.quad_o2w_end)
    qp = np.asarray(geom.quad_params)
    lo_q = np.zeros((len(qt), 3), np.float32)
    hi_q = np.zeros((len(qt), 3), np.float32)
    for i in range(len(qt)):
        r = abs(float(qp[i, 0]))
        zmin, zmax = float(qp[i, 1]), float(qp[i, 2])
        # object-space box (generous; exact for sphere/cyl/disk)
        lo = np.array([-r, -r, zmin], np.float64)
        hi = np.array([r, r, zmax], np.float64)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        wc = xform_point_affine(qo2w[i], corners)
        if qo2w_end is not None:
            wc = np.concatenate([wc, xform_point_affine(qo2w_end[i], corners)])
        lo_q[i] = wc.min(0)
        hi_q[i] = wc.max(0)
    lo = np.concatenate([lo_t, lo_q]) if len(qt) else lo_t
    hi = np.concatenate([hi_t, hi_q]) if len(qt) else hi_t
    if len(lo) == 0:
        lo = np.zeros((0, 3), np.float32)
        hi = np.zeros((0, 3), np.float32)
    return lo.astype(np.float32), hi.astype(np.float32)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


class _Builder:
    """Flattens during build: first child adjacent, second child indexed
    (reference bvh.cpp flattenBVHTree :559)."""

    def __init__(self):
        self.lo, self.hi, self.meta = [], [], []
        self.order = []

    def add_node(self):
        self.lo.append(None)
        self.hi.append(None)
        self.meta.append(None)
        return len(self.lo) - 1

    def set_leaf(self, idx, lo, hi, first, count):
        self.lo[idx], self.hi[idx] = lo, hi
        self.meta[idx] = (first, count, 0)

    def set_interior(self, idx, lo, hi, second_child, axis):
        self.lo[idx], self.hi[idx] = lo, hi
        self.meta[idx] = (second_child, 0, axis)


def _build_topdown(lo, hi, method: str):
    """SAH / middle / equal top-down build. Returns (nodes..., order)."""
    n = len(lo)
    cent = 0.5 * (lo + hi)
    b = _Builder()
    order: list = []

    def recurse(idx_arr) -> int:
        node = b.add_node()
        nlo = lo[idx_arr].min(0)
        nhi = hi[idx_arr].max(0)
        if len(idx_arr) <= LEAF_MAX:
            b.set_leaf(node, nlo, nhi, len(order), len(idx_arr))
            order.extend(idx_arr.tolist())
            return node
        c = cent[idx_arr]
        clo, chi = c.min(0), c.max(0)
        axis = int(np.argmax(chi - clo))
        if chi[axis] - clo[axis] < 1e-12:
            b.set_leaf(node, nlo, nhi, len(order), len(idx_arr))
            order.extend(idx_arr.tolist())
            return node
        if method == "middle":
            mid_val = 0.5 * (clo[axis] + chi[axis])
            mask = c[:, axis] < mid_val
            if mask.all() or not mask.any():
                half = len(idx_arr) // 2
                part = np.argpartition(c[:, axis], half)
                left, right = idx_arr[part[:half]], idx_arr[part[half:]]
            else:
                left, right = idx_arr[mask], idx_arr[~mask]
        elif method == "equal":
            half = len(idx_arr) // 2
            part = np.argpartition(c[:, axis], half)
            left, right = idx_arr[part[:half]], idx_arr[part[half:]]
        else:  # sah, 12 buckets (reference bvh.cpp:476 region)
            NB = 12
            t = (c[:, axis] - clo[axis]) / max(chi[axis] - clo[axis], 1e-12)
            bk = np.minimum((t * NB).astype(np.int32), NB - 1)
            blo = np.full((NB, 3), np.inf)
            bhi = np.full((NB, 3), -np.inf)
            cnt = np.zeros(NB, np.int64)
            for bi in range(NB):
                m = bk == bi
                if m.any():
                    cnt[bi] = m.sum()
                    blo[bi] = lo[idx_arr[m]].min(0)
                    bhi[bi] = hi[idx_arr[m]].max(0)
            cost = np.full(NB - 1, np.inf)
            for split in range(NB - 1):
                cl = cnt[: split + 1].sum()
                cr = cnt[split + 1:].sum()
                if cl == 0 or cr == 0:
                    continue
                l_lo = blo[: split + 1].min(0)
                l_hi = bhi[: split + 1].max(0)
                r_lo = blo[split + 1:].min(0)
                r_hi = bhi[split + 1:].max(0)
                cost[split] = 0.125 + (
                    cl * _surface_area(l_lo, l_hi) + cr * _surface_area(r_lo, r_hi)
                ) / max(_surface_area(nlo, nhi), 1e-20)
            best = int(np.argmin(cost))
            if len(idx_arr) > LEAF_MAX or cost[best] < len(idx_arr):
                mask = bk <= best
                if mask.all() or not mask.any():
                    half = len(idx_arr) // 2
                    part = np.argpartition(c[:, axis], half)
                    left, right = idx_arr[part[:half]], idx_arr[part[half:]]
                else:
                    left, right = idx_arr[mask], idx_arr[~mask]
            else:
                b.set_leaf(node, nlo, nhi, len(order), len(idx_arr))
                order.extend(idx_arr.tolist())
                return node
        recurse(left)
        second = recurse(right)
        b.set_interior(node, nlo, nhi, second, axis)
        return node

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        recurse(np.arange(n))
    finally:
        sys.setrecursionlimit(old)
    return b, order


# --- AAC (student mode, reference bvh.cpp:258-389) -------------------------

_AAC_DELTA = 4
_AAC_ALPHA = 0.3
_AAC_C = 0.5 * _AAC_DELTA ** 0.7


def _aac_f(x: int) -> int:
    return max(1, int(np.ceil(_AAC_C * x ** _AAC_ALPHA)))


def _morton30(cent, world_lo, world_hi):
    """30-bit Morton codes via magic-bits interleave (bvh.cpp:47-78)."""
    t = (cent - world_lo) / np.maximum(world_hi - world_lo, 1e-12)
    q = np.clip((t * 1024.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


@dataclass
class _Cluster:
    lo: np.ndarray
    hi: np.ndarray
    node: int  # builder node index (already emitted subtree), or -1 for leaf prim
    prim: int  # prim id when a raw leaf


def _aac_combine(b: _Builder, order: list, clusters, lo, hi, target: int):
    """Greedy closest-pair (min union surface area) merging down to
    `target` clusters (reference bvh.cpp CombineClusters :279-389)."""
    cl = list(clusters)
    while len(cl) > target:
        best = (np.inf, -1, -1)
        for i in range(len(cl)):
            for j in range(i + 1, len(cl)):
                u_lo = np.minimum(cl[i].lo, cl[j].lo)
                u_hi = np.maximum(cl[i].hi, cl[j].hi)
                sa = _surface_area(u_lo, u_hi)
                if sa < best[0]:
                    best = (sa, i, j)
        _, i, j = best
        a, c = cl[i], cl[j]
        node = b.add_node()
        for child in (a, c):
            if child.node < 0:
                leaf = b.add_node()
                b.set_leaf(leaf, child.lo, child.hi, len(order), 1)
                order.append(child.prim)
                child.node = leaf
        # emit interior with explicit children: our layout expects first
        # child adjacent; AAC emits out of order, so re-point via meta
        u_lo = np.minimum(a.lo, c.lo)
        u_hi = np.maximum(a.hi, c.hi)
        b.lo[node], b.hi[node] = u_lo, u_hi
        b.meta[node] = (-a.node - 2, -c.node - 2, 0)  # explicit two-child form
        merged = _Cluster(u_lo, u_hi, node, -1)
        cl.pop(j)
        cl[i] = merged
    return cl


def _build_aac(lo, hi, world_lo, world_hi):
    """AAC build. Emits a mixed node form (explicit children for merged
    interiors), normalized to the linear layout afterwards."""
    n = len(lo)
    cent = 0.5 * (lo + hi)
    codes = _morton30(cent, world_lo, world_hi)
    sort = np.argsort(codes, kind="stable")
    codes_s = codes[sort]
    b = _Builder()
    order: list = []

    def build_range(s, e, bit) -> list:
        if e - s <= _AAC_DELTA:
            cls = [_Cluster(lo[sort[i]], hi[sort[i]], -1, int(sort[i]))
                   for i in range(s, e)]
            return _aac_combine(b, order, cls, lo, hi, _aac_f(_AAC_DELTA))
        if bit < 0:
            cls = [_Cluster(lo[sort[i]], hi[sort[i]], -1, int(sort[i]))
                   for i in range(s, e)]
            return _aac_combine(b, order, cls, lo, hi, _aac_f(e - s))
        mask = np.uint64(1) << np.uint64(bit)
        # binary search for the bit boundary (bvh.cpp:258-277)
        seg = codes_s[s:e] & mask
        split = s + int(np.searchsorted(seg, np.uint64(1)))
        if split == s or split == e:
            return build_range(s, e, bit - 1)
        left = build_range(s, split, bit - 1)
        right = build_range(split, e, bit - 1)
        return _aac_combine(b, order, left + right, lo, hi, _aac_f(e - s))

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        roots = build_range(0, n, 29)
        roots = _aac_combine(b, order, roots, lo, hi, 1)
    finally:
        sys.setrecursionlimit(old)
    root = roots[0]
    if root.node < 0:  # single-prim scene
        leaf = b.add_node()
        b.set_leaf(leaf, root.lo, root.hi, len(order), 1)
        order.append(root.prim)
        root.node = leaf
    return b, order, root.node


def _normalize_aac(b: _Builder, root: int):
    """Re-emit AAC's explicit-children nodes into the linear
    first-child-adjacent layout by DFS."""
    lo, hi, meta = [], [], []

    def emit(i) -> int:
        me = len(lo)
        lo.append(b.lo[i])
        hi.append(b.hi[i])
        meta.append(None)
        m = b.meta[i]
        if m[1] > 0 or (m[1] == 0 and m[0] >= 0 and m[1] >= 0 and False):
            pass
        if m[0] <= -2:  # explicit interior
            a_child = -m[0] - 2
            c_child = -m[1] - 2
            emit(a_child)
            second = emit(c_child)
            meta[me] = (second, 0, 0)
        else:  # leaf
            meta[me] = (m[0], m[1], m[2])
        return me

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old)
    nb = _Builder()
    nb.lo, nb.hi, nb.meta = lo, hi, meta
    return nb


def build_bvh(geom: SceneGeom, split_method: str = "sah") -> Optional[BVH]:
    lo, hi = _prim_bounds(geom)
    n = len(lo)
    if n == 0:
        return None
    # native C++ builder first (pbrt_tpu/native/bvh_builder.cpp);
    # the pure-Python builders below are the portable fallback
    from pbrt_tpu.native import native_build_bvh

    nat = native_build_bvh(lo, hi, split_method)
    if nat is not None:
        node_lo, node_hi, meta, order = nat
        info(f"BVH[native]: {len(meta)} nodes over {n} prims ({split_method})")
        return BVH(
            node_lo=jnp.asarray(node_lo), node_hi=jnp.asarray(node_hi),
            node_meta=jnp.asarray(meta), prim_ids=jnp.asarray(order),
        )
    if split_method == "aac":
        wl = np.asarray(geom.world_lo)
        wh = np.asarray(geom.world_hi)
        b, order, root = _build_aac(lo, hi, wl, wh)
        b = _normalize_aac(b, root)
    else:
        if split_method not in ("sah", "middle", "equal"):
            warning(f'BVH split method "{split_method}" unknown; using "sah"')
            split_method = "sah"
        b, order = _build_topdown(lo, hi, split_method)
    info(f"BVH: {len(b.lo)} nodes over {n} prims ({split_method})")
    return BVH(
        node_lo=jnp.asarray(np.stack(b.lo).astype(np.float32)),
        node_hi=jnp.asarray(np.stack(b.hi).astype(np.float32)),
        node_meta=jnp.asarray(np.asarray(b.meta, np.int32)),
        prim_ids=jnp.asarray(np.asarray(order, np.int32)),
    )


# ---------------------------------------------------------------------------
# Device traversal

def _leaf_prims_t(geom: SceneGeom, prim_ids, o, d, tmin, tmax, time):
    """Candidate t for up to LEAF_MAX gathered prims per ray.

    prim_ids: [R, K] global ids (-1 = none). Returns (t [R,K], valid)."""
    T = geom.n_tris
    is_tri = (prim_ids >= 0) & (prim_ids < T)
    tri_idx = jnp.clip(jnp.where(is_tri, prim_ids, 0), 0, max(T - 1, 0))
    q_idx = jnp.clip(jnp.where(prim_ids >= T, prim_ids - T, 0), 0,
                     max(geom.n_quads - 1, 0))
    tb = jnp.full(prim_ids.shape, BIG)
    vb = jnp.zeros(prim_ids.shape, bool)
    if T > 0:
        v0, e1, e2 = geom.tri_at(tri_idx, time[:, None])
        t, v = _tri_t(v0, e1, e2, o[:, None], d[:, None], tmin[:, None], tmax[:, None])
        tb = jnp.where(is_tri & v, t, tb)
        vb = vb | (is_tri & v)
    if geom.n_quads > 0:
        qt = geom.quad_type[q_idx]
        qp = geom.quad_params[q_idx]
        _, w2o = geom.quad_xforms_at(q_idx, time[:, None])
        oo = xform_point_affine(w2o, o[:, None])
        od = xform_vector(w2o, d[:, None])
        present = set(int(x) for x in np.asarray(geom.quad_type))
        t, v = _quad_candidates(qt, qp, oo, od, tmin[:, None], tmax[:, None],
                                present=present)
        is_q = prim_ids >= T
        tb = jnp.where(is_q & v, t, tb)
        vb = vb | (is_q & v)
    return tb, vb


def t_pass_bvh(bvh: BVH, geom: SceneGeom, ray: Ray, any_hit: bool = False):
    """Wavefront BVH traversal. Returns (t [R], prim [R])."""
    R = ray.o.shape[0]
    o, d = ray.o, ray.d
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    neg = (inv_d < 0.0)  # [R, 3]
    t_best = jnp.where(jnp.isfinite(ray.tmax), ray.tmax, BIG)
    prim_best = jnp.full((R,), -1, jnp.int32)

    stack = jnp.zeros((R, MAX_DEPTH), jnp.int32)
    sp = jnp.ones((R,), jnp.int32)  # stack[*,0] = 0 (root) pre-pushed
    active = jnp.ones((R,), bool)

    node_lo, node_hi, node_meta, prim_ids = (
        bvh.node_lo, bvh.node_hi, bvh.node_meta, bvh.prim_ids
    )
    P = prim_ids.shape[0]

    def cond(state):
        _, _, _, sp, done_any = state
        return jnp.any(sp > 0) & ~done_any

    def body(state):
        t_best, prim_best, stack, sp, _ = state
        has = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(has, jnp.take_along_axis(stack, top[:, None], 1)[:, 0], 0)
        sp2 = jnp.where(has, sp - 1, sp)

        lo = node_lo[node]
        hi = node_hi[node]
        m = node_meta[node]
        # slab test against current best t
        t_lo = (lo - o) * inv_d
        t_hi = (hi - o) * inv_d
        tn = jnp.maximum(jnp.max(jnp.minimum(t_lo, t_hi), -1), ray.tmin)
        tf = jnp.minimum(jnp.min(jnp.maximum(t_lo, t_hi), -1), t_best)
        box_hit = has & (tn <= tf * 1.0001)

        is_leaf = m[:, 1] > 0
        # --- leaf: test up to LEAF_MAX prims
        first = m[:, 0]
        count = m[:, 1]
        k = jnp.arange(LEAF_MAX)
        pidx = first[:, None] + k[None, :]
        in_range = (k[None, :] < count[:, None]) & box_hit[:, None] & is_leaf[:, None]
        pidx = jnp.clip(pidx, 0, max(P - 1, 0))
        gids = jnp.where(in_range, prim_ids[pidx], -1)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = jnp.where(v_c, t_c, BIG)
        jbest = jnp.argmin(t_c, -1)
        t_leaf = jnp.take_along_axis(t_c, jbest[:, None], 1)[:, 0]
        g_leaf = jnp.take_along_axis(gids, jbest[:, None], 1)[:, 0]
        better = box_hit & is_leaf & (t_leaf < t_best)
        t_best2 = jnp.where(better, t_leaf, t_best)
        prim_best2 = jnp.where(better, g_leaf, prim_best)

        # --- interior: push children (near first -> push far first)
        axis = jnp.clip(m[:, 2], 0, 2)
        neg_ax = jnp.take_along_axis(neg, axis[:, None], 1)[:, 0]
        c1 = node + 1          # first child (adjacent)
        c2 = m[:, 0]           # second child
        near = jnp.where(neg_ax, c2, c1)
        far = jnp.where(neg_ax, c1, c2)
        push = box_hit & ~is_leaf
        # push far then near (near popped first)
        sp3 = sp2
        stack2 = stack
        can = push & (sp3 < MAX_DEPTH)
        stack2 = jnp.where(
            can[:, None] & (jnp.arange(MAX_DEPTH)[None, :] == sp3[:, None]),
            far[:, None], stack2,
        )
        sp3 = jnp.where(can, sp3 + 1, sp3)
        can2 = push & (sp3 < MAX_DEPTH)
        stack2 = jnp.where(
            can2[:, None] & (jnp.arange(MAX_DEPTH)[None, :] == sp3[:, None]),
            near[:, None], stack2,
        )
        sp3 = jnp.where(can2, sp3 + 1, sp3)

        done_any = jnp.asarray(False)
        if any_hit:
            done_any = jnp.all((prim_best2 >= 0) | (sp3 == 0))
        return t_best2, prim_best2, stack2, sp3, done_any

    t_best, prim_best, _, _, _ = jax.lax.while_loop(
        cond, body, (t_best, prim_best, stack, sp, jnp.asarray(False))
    )
    hit_valid = prim_best >= 0
    return jnp.where(hit_valid, t_best, BIG), prim_best


class BvhScene(NamedTuple):
    """Geometry + acceleration. On the GPU, triangle-heavy static scenes
    use the packet-traversal pipeline (accel/wide_bvh.py +
    ops/bvh_pallas.py): coherence-sorted ray tiles, culling over wide
    leaf blocks, and a Pallas Moller-Trumbore leaf sweep. Otherwise the
    pure-jnp paths: the short-stack BVH for large scenes, the blocked
    brute-force scan for small ones."""

    geom: SceneGeom
    bvh: Optional[BVH]
    wide: object = None      # accel.wide_bvh.WideBVH (GPU packet pipeline)

    def _t_pass(self, ray: Ray, any_hit: bool = False,
                coherent: bool = False):
        if self.wide is not None:
            from pbrt_tpu.accel.intersect import _quad_t_pass
            from pbrt_tpu.ops.bvh_pallas import wide_t_pass

            t, prim = wide_t_pass(self.wide, ray.o, ray.d, ray.tmin,
                                  ray.tmax, any_hit=any_hit,
                                  coherent=coherent)
            if self.geom.n_quads > 0:
                t, prim = _quad_t_pass(self.geom, ray, t, prim)
            return t, prim
        if self.bvh is not None:
            return t_pass_bvh(self.bvh, self.geom, ray, any_hit=any_hit)
        from pbrt_tpu.accel.intersect import t_pass_brute

        return t_pass_brute(self.geom, ray)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray, coherent=coherent)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True, coherent=coherent)
        return prim >= 0


def make_accel(geom: SceneGeom, split_method: str = "sah",
               bvh_threshold: int = 32768, force: str = "",
               wide_threshold: int = 8192) -> BvhScene:
    """Pick the acceleration strategy for a compiled scene.

    The choice follows the backend JAX runs on:
      "gpu" — the packet pipeline with the Pallas leaf-sweep kernel for
              static scenes with >= wide_threshold triangles;
      "cpu" — the jnp paths only;
    then, on either, the jnp BVH above bvh_threshold primitives and the
    brute-force scan below it; force="bvh" / "flat" pins one of those.
    Any other backend is an error."""
    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"make_accel: unsupported JAX backend {backend!r} "
                         "(expected 'gpu' or 'cpu')")
    n_prims = geom.n_tris + geom.n_quads
    if (backend == "gpu" and not force and not geom.has_motion
            and geom.n_tris >= wide_threshold):
        narrow = build_bvh(geom, split_method)
        if narrow is not None:
            from pbrt_tpu.accel.wide_bvh import build_wide_bvh

            wide = build_wide_bvh(narrow, geom)
            if wide is not None:
                return BvhScene(geom=geom, bvh=None, wide=wide)
    use_bvh = force == "bvh" or (force != "flat" and n_prims > bvh_threshold)
    bvh = build_bvh(geom, split_method) if use_bvh and n_prims > 0 else None
    return BvhScene(geom=geom, bvh=bvh)
