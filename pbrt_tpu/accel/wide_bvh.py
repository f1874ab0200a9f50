"""Wide-leaf BVH for the packet-traversal pipeline.

The reference's hot loop is a per-ray BVH node walk with 1-4 triangle
leaves (accelerators/bvh.cpp:585-687): divergent, pointer-chasing work.
The packet re-design collapses the binary SAH tree into leaves of up
to LEAF_W=128 triangles, so that

  * culling is a dense [rays, leaf blocks] box test (B ~ prims/100),
  * every leaf is one contiguous block of a component-major [16, P']
    triangle table, which the leaf-sweep kernel (ops/bvh_pallas.py)
    reads as LEAF_W-wide row slices,
  * rays are swept per PACKET of TILE rays sharing one leaf list, so
    list bookkeeping is O(tiles), not O(rays).

Build path: the normal (narrow) BVH build — native C++ builder when
available — then a host collapse pass over the flattened tree.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

LEAF_W = 128          # triangles per wide leaf block
TILE = 1024           # rays per packet sharing one leaf list
MAX_L = 64            # leaf-list slots per tile per wave


class WideBVH(NamedTuple):
    block_lo: jnp.ndarray   # [B, 3] f32 leaf-block bounds
    block_hi: jnp.ndarray   # [B, 3] f32
    tris16: jnp.ndarray     # [16, P'] f32 component-major (v0,e1,e2 rows 0-8)
    prim_map: jnp.ndarray   # [P'] i32 padded slot -> global prim id (-1 pad)
    world_lo: jnp.ndarray   # [3] f32 root bounds (coherence-sort domain)
    world_hi: jnp.ndarray   # [3] f32
    n_blocks: int           # number of real leaf blocks (sentinel block = n_blocks)


def _subtree_counts(meta: np.ndarray) -> np.ndarray:
    """Prim count per node of a flattened first-child-adjacent tree."""
    n = len(meta)
    cnt = np.zeros(n, np.int64)
    # reverse order: children always have larger indices than parents
    for i in range(n - 1, -1, -1):
        if meta[i, 1] > 0:
            cnt[i] = meta[i, 1]
        else:
            cnt[i] = cnt[i + 1] + cnt[meta[i, 0]]
    return cnt


def _gather_subtree_prims(meta, order, root) -> list:
    """All prim ids under `root` (iterative DFS; order may be any layout)."""
    out, stack = [], [root]
    while stack:
        i = stack.pop()
        if meta[i, 1] > 0:
            out.extend(order[meta[i, 0]: meta[i, 0] + meta[i, 1]])
        else:
            stack.append(meta[i, 0])
            stack.append(i + 1)
    return out


def build_wide_bvh(bvh, geom) -> Optional[WideBVH]:
    """Collapse a narrow BVH (accel/bvh.py BVH over tris+quads) into the
    wide-leaf kernel layout. Only triangle geometry is packed; scenes
    whose BVH contains quadrics should intersect them separately."""
    node_lo = np.asarray(bvh.node_lo)
    node_hi = np.asarray(bvh.node_hi)
    meta = np.asarray(bvh.node_meta)
    order = np.asarray(bvh.prim_ids)
    T = geom.n_tris
    if T == 0:
        return None
    cnt = _subtree_counts(meta)

    w_lo, w_hi, w_meta = [], [], []
    leaf_prims: list = []   # list of per-leaf prim-id lists
    stack = [(0, -1, False)]  # (node, parent_slot, is_second)
    # iterative DFS emitting first-child-adjacent wide tree
    out_idx = {}

    def emit(node_i):
        w_lo.append(node_lo[node_i])
        w_hi.append(node_hi[node_i])
        w_meta.append([0, 0, int(meta[node_i, 2])])
        return len(w_lo) - 1

    def dfs(node_i) -> int:
        me = emit(node_i)
        if cnt[node_i] <= LEAF_W:
            prims = _gather_subtree_prims(meta, order, node_i)
            w_meta[me][0] = len(leaf_prims)       # leaf block id
            w_meta[me][1] = len(prims)            # count > 0 -> leaf
            leaf_prims.append(prims)
            return me
        dfs(node_i + 1)
        second = dfs(meta[node_i, 0])
        w_meta[me][0] = second
        w_meta[me][1] = 0
        return me

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        dfs(0)
    finally:
        sys.setrecursionlimit(old)

    n_blocks = len(leaf_prims)
    Pp = (n_blocks + 1) * LEAF_W  # +1 sentinel (all-degenerate) block
    tris16 = np.zeros((16, Pp), np.float32)
    prim_map = np.full(Pp, -1, np.int32)
    v0 = np.asarray(geom.tri_v0)
    e1 = np.asarray(geom.tri_e1)
    e2 = np.asarray(geom.tri_e2)
    for b, prims in enumerate(leaf_prims):
        ids = np.asarray([p for p in prims if p < T], np.int64)
        s = b * LEAF_W
        k = len(ids)
        if k:
            tris16[0:3, s:s + k] = v0[ids].T
            tris16[3:6, s:s + k] = e1[ids].T
            tris16[6:9, s:s + k] = e2[ids].T
            prim_map[s:s + k] = ids
    w_meta_a = np.asarray(w_meta, np.int32)
    lo_a = np.stack(w_lo).astype(np.float32)
    hi_a = np.stack(w_hi).astype(np.float32)
    is_leaf = w_meta_a[:, 1] > 0
    blk = w_meta_a[is_leaf, 0]
    block_lo = np.zeros((n_blocks, 3), np.float32)
    block_hi = np.zeros((n_blocks, 3), np.float32)
    block_lo[blk] = lo_a[is_leaf]
    block_hi[blk] = hi_a[is_leaf]
    return WideBVH(
        block_lo=jnp.asarray(block_lo),
        block_hi=jnp.asarray(block_hi),
        tris16=jnp.asarray(tris16),
        prim_map=jnp.asarray(prim_map),
        world_lo=jnp.asarray(lo_a[0]),
        world_hi=jnp.asarray(hi_a[0]),
        n_blocks=n_blocks,
    )
