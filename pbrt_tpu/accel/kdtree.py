"""SAH kd-tree accelerator: host event-based build + wavefront
short-stack traversal.

Replaces reference accelerators/kdtreeaccel.{h,cpp} (KdTreeAccel):
exact edge-event SAH with the reference's cost model — intersectcost=80,
traversalcost=1, emptybonus=0.5, maxprims=1, maxdepth auto =
8 + 1.3*log2(N) (kdtreeaccel.cpp:475-479) — built on the host in NumPy,
then flattened to tensors:

  node_split [N]   float32 split plane position
  node_meta  [N,3] int32: interior (axis 0..2, above_child, 0)
                          leaf     (3, prim_offset, n_prims<=LEAF_MAX)
  prim_ids   [P]   int32 CSR leaf prim list (global ids)

Wavefront traversal: classic (node, t_near, t_far) short-stack kd
descent, run lockstep across the ray wavefront inside one
lax.while_loop (no recursion, no pointers). Front-to-back ordering
gives the reference's early exit: once a leaf hit lands inside the
popped interval the ray's remaining stack is discarded.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core.error import info
from pbrt_tpu.core.geometry import Ray
from pbrt_tpu.accel.intersect import BIG, SceneGeom, reconstruct
from pbrt_tpu.accel.bvh import _leaf_prims_t, _prim_bounds

MAX_DEPTH = 64   # traversal stack depth
LEAF_MAX = 4     # prims per leaf tested in one wavefront iteration

_LEAF_FLAG = 3


class KdTree(NamedTuple):
    lo: jnp.ndarray          # [3] world bounds
    hi: jnp.ndarray          # [3]
    node_split: jnp.ndarray  # [N] float32
    node_meta: jnp.ndarray   # [N, 3] int32
    prim_ids: jnp.ndarray    # [P] int32


def build_kdtree(geom: SceneGeom, isect_cost: float = 80.0,
                 trav_cost: float = 1.0, empty_bonus: float = 0.5,
                 max_prims: int = 1, max_depth: int = 0) -> Optional[KdTree]:
    lo_p, hi_p = _prim_bounds(geom)
    n = len(lo_p)
    if n == 0:
        return None
    if max_depth <= 0:
        # reference kdtreeaccel.cpp: 8 + 1.3 * log2(N)
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 1))))
    if max_depth > MAX_DEPTH:
        # the traversal short stack is MAX_DEPTH deep and silently drops
        # pushes past it; never build deeper than we can traverse
        from pbrt_tpu.core.error import warning

        warning(f"kdtree maxdepth {max_depth} clamped to traversal stack "
                f"depth {MAX_DEPTH}")
        max_depth = MAX_DEPTH

    wlo = lo_p.min(0).astype(np.float64)
    whi = hi_p.max(0).astype(np.float64)

    split_pos: list = []
    meta: list = []
    order: list = []

    def add_node():
        split_pos.append(0.0)
        meta.append((0, 0, 0))
        return len(meta) - 1

    def set_leaf(idx, prims):
        # leaves may exceed LEAF_MAX; traversal chunks through them with a
        # per-ray cursor (see t_pass_kdtree)
        split_pos[idx] = 0.0
        meta[idx] = (_LEAF_FLAG, len(order), len(prims))
        order.extend(int(p) for p in prims)

    def recurse(prims: np.ndarray, nlo, nhi, depth: int, bad_refines: int):
        idx = add_node()
        if len(prims) <= max_prims or depth == 0:
            set_leaf(idx, prims)
            return idx
        # exact edge-event SAH over the three axes
        # (reference kdtreeaccel.cpp BuildTree retry loop)
        d = np.maximum(nhi - nlo, 0.0)
        inv_sa = 1.0 / max(
            2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]), 1e-30)
        old_cost = isect_cost * len(prims)
        best = (np.inf, -1, 0.0)  # (cost, axis, position)
        axis0 = int(np.argmax(d))
        for trial in range(3):
            axis = (axis0 + trial) % 3
            starts = lo_p[prims, axis]
            ends = hi_p[prims, axis]
            # events: (pos, type) with type 0=start(open) before 1=end? pbrt
            # sorts END before START at equal positions
            pos = np.concatenate([starts, ends])
            typ = np.concatenate([np.zeros(len(prims)), np.ones(len(prims))])
            srt = np.lexsort((1.0 - typ, pos))  # ends (typ=1) first on ties
            pos_s = pos[srt]
            is_start = typ[srt] == 0
            n_above = np.full(len(pos_s), 0, np.int64)
            # sweep: below count after processing all events < here
            below_inc = np.cumsum(is_start.astype(np.int64))
            above_dec = len(prims) - np.cumsum((~is_start).astype(np.int64))
            # at event i (a candidate plane at pos_s[i]):
            #   nAbove = prims whose end > pos  -> above_dec adjusted pre-event
            #   nBelow = prims whose start < pos -> below_inc pre-event
            n_below = np.concatenate([[0], below_inc[:-1]])
            n_above = np.concatenate([[len(prims)], above_dec[:-1]])
            # pbrt decrements nAbove when passing an END event before
            # evaluating the plane at it:
            n_above = np.where(~is_start, n_above - 1, n_above)
            inside = (pos_s > nlo[axis]) & (pos_s < nhi[axis])
            # SA of the two children for each candidate
            oth = [a for a in range(3) if a != axis]
            sa_base = d[oth[0]] * d[oth[1]]
            sa_edge = d[oth[0]] + d[oth[1]]
            below_sa = 2.0 * (sa_base + (pos_s - nlo[axis]) * sa_edge)
            above_sa = 2.0 * (sa_base + (nhi[axis] - pos_s) * sa_edge)
            pb = below_sa * inv_sa
            pa = above_sa * inv_sa
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus, 0.0)
            cost = trav_cost + isect_cost * (1.0 - eb) * (pb * n_below + pa * n_above)
            cost = np.where(inside, cost, np.inf)
            if cost.size and cost.min() < best[0]:
                i = int(np.argmin(cost))
                best = (float(cost[i]), axis, float(pos_s[i]))
            if best[1] >= 0:
                break  # found a plane on this axis; pbrt retries only on failure
        cost_best, axis, pos = best
        if cost_best > old_cost:
            bad_refines += 1
        if (cost_best > 4.0 * old_cost and len(prims) < 16) or axis < 0 \
                or bad_refines == 3:
            set_leaf(idx, prims)
            return idx
        # flat prims exactly on the plane go to both sides (safe; the
        # event-sorted reference handles this via edge ordering)
        flat = (lo_p[prims, axis] == pos) & (hi_p[prims, axis] == pos)
        below = prims[(lo_p[prims, axis] < pos) | flat]
        above = prims[(hi_p[prims, axis] > pos) | flat]
        if len(below) == len(prims) and len(above) == len(prims):
            # degenerate: the plane separates nothing
            set_leaf(idx, prims)
            return idx
        # An empty side is exactly what the empty-bonus rewards: recurse
        # with an empty leaf for it to cut away the empty space (the
        # reference creates the empty child too, kdtreeaccel.cpp).
        blo, bhi = nlo.copy(), nhi.copy()
        bhi[axis] = pos
        alo, ahi = nlo.copy(), nhi.copy()
        alo[axis] = pos
        recurse(below, blo, bhi, depth - 1, bad_refines)
        above_idx_pos = idx  # fill after the below subtree is emitted
        a_idx = recurse(above, alo, ahi, depth - 1, bad_refines)
        meta[above_idx_pos] = (axis, a_idx, 0)
        split_pos[above_idx_pos] = pos
        return idx

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        recurse(np.arange(n), wlo.copy(), whi.copy(), max_depth, 0)
    finally:
        sys.setrecursionlimit(old)

    info(f"KdTree: {len(meta)} nodes over {n} prims, depth<={max_depth}")
    return KdTree(
        lo=jnp.asarray(wlo, jnp.float32), hi=jnp.asarray(whi, jnp.float32),
        node_split=jnp.asarray(np.asarray(split_pos, np.float32)),
        node_meta=jnp.asarray(np.asarray(meta, np.int32)),
        prim_ids=jnp.asarray(np.asarray(order, np.int32) if order
                             else np.zeros(1, np.int32)),
    )


def t_pass_kdtree(kd: KdTree, geom: SceneGeom, ray: Ray,
                  any_hit: bool = False):
    """Wavefront kd traversal. Returns (t [R], prim [R], -1 = miss)."""
    R = ray.o.shape[0]
    o, d = ray.o, ray.d
    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    inv_d = 1.0 / safe_d

    t_lo = (kd.lo[None] - o) * inv_d
    t_hi = (kd.hi[None] - o) * inv_d
    tn0 = jnp.maximum(jnp.max(jnp.minimum(t_lo, t_hi), -1), ray.tmin)
    tmax0 = jnp.where(jnp.isfinite(ray.tmax), ray.tmax, BIG)
    tf0 = jnp.minimum(jnp.min(jnp.maximum(t_lo, t_hi), -1), tmax0)
    inside = tn0 <= tf0

    node_split, node_meta, prim_ids = kd.node_split, kd.node_meta, kd.prim_ids
    P = prim_ids.shape[0]

    s_node = jnp.zeros((R, MAX_DEPTH), jnp.int32)
    s_tn = jnp.zeros((R, MAX_DEPTH), jnp.float32)
    s_tf = jnp.zeros((R, MAX_DEPTH), jnp.float32)
    lanes = jnp.arange(MAX_DEPTH)[None, :]
    # pre-push the root interval where the ray overlaps the tree bounds
    s_tn = s_tn.at[:, 0].set(tn0)
    s_tf = s_tf.at[:, 0].set(tf0)
    sp = jnp.where(inside, 1, 0).astype(jnp.int32)

    t_best = tmax0
    prim_best = jnp.full((R,), -1, jnp.int32)

    def push(s_node, s_tn, s_tf, sp, can, node, tn, tf):
        at = can[:, None] & (lanes == sp[:, None])
        s_node = jnp.where(at, node[:, None], s_node)
        s_tn = jnp.where(at, tn[:, None], s_tn)
        s_tf = jnp.where(at, tf[:, None], s_tf)
        return s_node, s_tn, s_tf, jnp.where(can, sp + 1, sp)

    cursor0 = jnp.zeros((R,), jnp.int32)  # chunk offset into the top leaf

    def cond(state):
        return jnp.any(state[3] > 0)

    def body(state):
        t_best, prim_best, (s_node, s_tn, s_tf), sp, cursor = state
        has = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(has, jnp.take_along_axis(s_node, top[:, None], 1)[:, 0], 0)
        tn = jnp.take_along_axis(s_tn, top[:, None], 1)[:, 0]
        tf = jnp.minimum(jnp.take_along_axis(s_tf, top[:, None], 1)[:, 0], t_best)
        live = has & (tn <= tf * 1.0001 + 1e-6)

        m = node_meta[node]
        flag = m[:, 0]
        is_leaf = flag == _LEAF_FLAG

        # --- leaf: test the next chunk of LEAF_MAX prims (cursor walks
        # oversize leaves across iterations; the entry stays on the stack
        # until its list is exhausted)
        first = m[:, 1]
        count = m[:, 2]
        k = jnp.arange(LEAF_MAX)
        off = cursor[:, None] + k[None, :]
        pidx = jnp.clip(first[:, None] + off, 0, max(P - 1, 0))
        in_leaf = (off < count[:, None]) & live[:, None] & is_leaf[:, None]
        gids = jnp.where(in_leaf, prim_ids[pidx], -1)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = jnp.where(v_c, t_c, BIG)
        jb = jnp.argmin(t_c, -1)
        t_leaf = jnp.take_along_axis(t_c, jb[:, None], 1)[:, 0]
        g_leaf = jnp.take_along_axis(gids, jb[:, None], 1)[:, 0]
        better = live & is_leaf & (t_leaf < t_best)
        t_best2 = jnp.where(better, t_leaf, t_best)
        prim_best2 = jnp.where(better, g_leaf, prim_best)

        leaf_done = cursor + LEAF_MAX >= count
        # pop rule: dead entries and exhausted/interior nodes pop; an
        # unfinished leaf stays with an advanced cursor
        stay = live & is_leaf & ~leaf_done
        sp2 = jnp.where(has & ~stay, sp - 1, sp)
        cursor2 = jnp.where(stay, cursor + LEAF_MAX, 0)

        # front-to-back early out: a hit inside the popped interval ends
        # the ray once the leaf's whole list has been tested
        if any_hit:
            finish = prim_best2 >= 0
        else:
            finish = (prim_best2 >= 0) & (t_best2 <= tf * 1.0001 + 1e-6)
        sp2 = jnp.where(live & is_leaf & leaf_done & finish, 0, sp2)

        # --- interior: split-plane classification
        axis = jnp.clip(flag, 0, 2)
        split = node_split[node]
        o_ax = jnp.take_along_axis(o, axis[:, None], 1)[:, 0]
        d_ax = jnp.take_along_axis(safe_d, axis[:, None], 1)[:, 0]
        t_plane = (split - o_ax) * (1.0 / d_ax)
        below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0.0))
        below_child = node + 1
        above_child = m[:, 1]
        near = jnp.where(below_first, below_child, above_child)
        far = jnp.where(below_first, above_child, below_child)

        interior = live & ~is_leaf
        only_near = interior & ((t_plane > tf) | (t_plane <= 0.0))
        only_far = interior & ~only_near & (t_plane < tn)
        both = interior & ~only_near & ~only_far

        # push far interval first (popped second), then near
        can_far = (both | only_far) & (sp2 < MAX_DEPTH)
        far_tn = jnp.where(only_far, tn, t_plane)
        s_node2, s_tn2, s_tf2, sp3 = push(
            s_node, s_tn, s_tf, sp2, can_far, far, far_tn, tf)
        can_near = (both | only_near) & (sp3 < MAX_DEPTH)
        near_tf = jnp.where(only_near, tf, t_plane)
        s_node2, s_tn2, s_tf2, sp4 = push(
            s_node2, s_tn2, s_tf2, sp3, can_near, near, tn, near_tf)
        return t_best2, prim_best2, (s_node2, s_tn2, s_tf2), sp4, cursor2

    t_best, prim_best, _, _, _ = jax.lax.while_loop(
        cond, body, (t_best, prim_best, (s_node, s_tn, s_tf), sp, cursor0)
    )
    hit = prim_best >= 0
    return jnp.where(hit, t_best, BIG), prim_best


class KdScene(NamedTuple):
    """Geometry + SAH kd-tree acceleration (Accelerator "kdtree")."""

    geom: SceneGeom
    kd: Optional[KdTree]

    def _t_pass(self, ray: Ray, any_hit: bool = False):
        if self.kd is None:
            from pbrt_tpu.accel.intersect import t_pass_brute

            return t_pass_brute(self.geom, ray)
        return t_pass_kdtree(self.kd, self.geom, ray, any_hit=any_hit)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True)
        return prim >= 0


def make_kdtree_accel(geom: SceneGeom, params=None) -> KdScene:
    """Accelerator "kdtree" factory (reference kdtreeaccel.cpp:475-484)."""
    if params is None:
        kd = build_kdtree(geom)
    else:
        kd = build_kdtree(
            geom,
            isect_cost=float(params.find_one_int("intersectcost", 80)),
            trav_cost=float(params.find_one_int("traversalcost", 1)),
            empty_bonus=float(params.find_one_float("emptybonus", 0.5)),
            max_prims=int(params.find_one_int("maxprims", 1)),
            max_depth=int(params.find_one_int("maxdepth", -1)),
        )
    return KdScene(geom=geom, kd=kd)
