"""Packet BVH traversal: jnp culling + a Pallas (Triton) leaf sweep.

Replaces the per-ray short-stack walk (reference accelerators/bvh.cpp
:585-687) with a two-phase wavefront design:

  Phase A (jnp): rays are sorted by a coherence key (origin Morton,
  then direction octant + direction Morton) and grouped into TILE-ray
  packets. Candidate leaf blocks come either from a per-wave tile-
  frustum test (beam-like batches) or from an EXACT dense per-ray slab
  test ([R, B], reduced to per-tile nearest-first lists), which stays
  precise for direction-incoherent secondary bounces where a
  conservative tile-frustum test degenerates to "everything".

  Phase B (Pallas, Triton route): grid (T, TILE // RB); program (t, s)
  owns RB rays of ray tile t. It reads tile t's leaf list itself, loops
  over it, loads each [16, LEAF_W] component-major leaf block slice by
  slice and folds Moller-Trumbore's per-ray (t, slot) minimum in
  registers. Each ray's result is written once, so no accumulator is
  shared between programs and program order does not matter.

  Waves: A fills lists -> B sweeps -> per-tile t_max tightens -> A
  takes the next window. Repeats until every list drains, which also
  makes leaf-list overflow benign (stalled tiles continue next wave).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pbrt_tpu.accel.wide_bvh import WideBVH, LEAF_W, TILE, MAX_L

BIG = 1e30
CHUNK = 1 << 20     # rays per dispatch (bounds the [T, B] cull tables)

# Leaf-sweep launch shape: RB rays per program, TC triangles per inner
# step ([RB, TC] Moller-Trumbore tile in registers). Powers of two;
# picked on an H100 (registers, not shared memory, bound the tile).
RB = 32
TC = 32
NUM_WARPS = 4
NUM_STAGES = 1


# ---------------------------------------------------------------------------
# Phase B: leaf sweep

def _mt_fold(o, d, tmin, tb, pb, tri_row, off, tc):
    """Fold one [RB, tc] Moller-Trumbore tile into the running per-ray
    (t, slot). o/d: 3-tuples of [RB, 1]; tri_row(r) -> [1, tc] row r of
    the component-major triangle slice starting at slot `off`. The
    running best t is the upper bound, so ties keep the earlier slot."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = tri_row(0), tri_row(1), tri_row(2)
    e1x, e1y, e1z = tri_row(3), tri_row(4), tri_row(5)
    e2x, e2y, e2z = tri_row(6), tri_row(7), tri_row(8)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / det, 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = (ok_det & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
             & (t > tmin) & (t < tb[..., None]))
    t = jnp.where(valid, t, BIG)
    t_min = jnp.min(t, axis=-1)
    lane = lax.broadcasted_iota(jnp.int32, t.shape, t.ndim - 1)
    first = jnp.min(jnp.where(t == t_min[..., None], lane, tc), axis=-1)
    better = t_min < tb
    return (jnp.where(better, t_min, tb),
            jnp.where(better, off + first, pb))


def _sweep_kernel(lst_ref, nl_ref, rays_ref, tin_ref, pin_ref, tris_ref,
                  tout_ref, pout_ref, *, tc):
    tile = pl.program_id(0)
    col = [rays_ref[k, :][:, None] for k in range(7)]
    o, d, tmin = tuple(col[0:3]), tuple(col[3:6]), col[6]

    def leaf(i, carry):
        base = lst_ref[tile, i] * LEAF_W

        def step(c, carry):
            off = base + c * tc
            return _mt_fold(
                o, d, tmin, *carry,
                lambda r: tris_ref[r, pl.ds(off, tc)][None, :], off, tc)

        return lax.fori_loop(0, LEAF_W // tc, step, carry)

    tb, pb = lax.fori_loop(0, nl_ref[tile], leaf,
                           (tin_ref[...], pin_ref[...]))
    tout_ref[...] = tb
    pout_ref[...] = pb


@functools.partial(jax.jit, static_argnames=("interpret",))
def sweep_leaves(lst, nl, rays8, t_in, p_in, tris16, interpret=False):
    """One wave of the leaf sweep (Pallas kernel, Triton route).

    lst [T, MAX_L] i32 leaf-block ids, nl [T] i32 valid entries per tile;
    rays8 [8, T*TILE] f32 component-major (o, d, tmin, unused);
    t_in/p_in [T*TILE] running per-ray best t (doubles as t_max) and
    padded triangle slot (-1 none); tris16 [16, P'] leaf blocks.
    Returns the updated (t, slot)."""
    T = lst.shape[0]
    R = t_in.shape[0]
    S = TILE // RB
    assert R == T * TILE
    ray_blk = pl.BlockSpec((RB,), lambda t, s: (t * S + s,))
    return pl.pallas_call(
        functools.partial(_sweep_kernel, tc=TC),
        grid=(T, S),
        in_specs=[
            pl.no_block_spec,                                   # lst
            pl.no_block_spec,                                   # nl
            pl.BlockSpec((8, RB), lambda t, s: (0, t * S + s)),  # rays8
            ray_blk,                                            # t_in
            ray_blk,                                            # p_in
            pl.no_block_spec,                                   # tris16
        ],
        out_specs=[ray_blk, ray_blk],
        out_shape=[jax.ShapeDtypeStruct((R,), jnp.float32),
                   jax.ShapeDtypeStruct((R,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        name="leaf_sweep",
        interpret=interpret,
    )(lst, nl, rays8, t_in, p_in, tris16)


def sweep_leaves_ref(lst, nl, rays8, t_in, p_in, tris16):
    """Plain jnp reference of `sweep_leaves` (same arguments, same
    result): per list slot, gather every tile's leaf block and fold the
    [T, TILE, LEAF_W] Moller-Trumbore minimum."""
    T = lst.shape[0]
    r = rays8.reshape(8, T, TILE, 1)
    o, d, tmin = (r[0], r[1], r[2]), (r[3], r[4], r[5]), r[6]
    blocks = tris16[:9].reshape(9, -1, LEAF_W)

    def slot(j, carry):
        tb, pb = carry
        b = lst[:, j]
        blk = blocks[:, b][:, :, None, :]                  # [9, T, 1, LEAF_W]
        live = (j < nl)[:, None]
        t2, p2 = _mt_fold(o, d, tmin, tb, pb, lambda k: blk[k],
                          (b * LEAF_W)[:, None], LEAF_W)
        return jnp.where(live, t2, tb), jnp.where(live, p2, pb)

    tb, pb = lax.fori_loop(0, jnp.max(nl), slot,
                           (t_in.reshape(T, TILE), p_in.reshape(T, TILE)))
    return tb.reshape(-1), pb.reshape(-1)


# ---------------------------------------------------------------------------
# Phase A: dense per-ray culling. With ~LEAF_W-triangle leaves the leaf
# count is small (B ~ prims/100), so instead of walking a tree we slab-
# test EVERY ray against EVERY leaf box as a fused [R, B] elementwise
# op and top_k each tile's entered blocks into per-tile lists. It stays
# EXACT for direction-incoherent secondary bounces, unlike a
# tile-frustum test.

def _frusta(o, d, tmin, tmax, live, T):
    """Per-tile conservative interval bounds:
    (olo, ohi, ilo, ihi [T,3]; tmin_t, tmax_t [T]; alive [T] bool)."""
    o3 = o.reshape(T, TILE, 3)
    d3 = d.reshape(T, TILE, 3)
    lv = live.reshape(T, TILE, 1)
    safe_d = jnp.where(jnp.abs(d3) > 1e-20, d3, jnp.where(d3 < 0, -1e-20, 1e-20))
    inv = 1.0 / safe_d
    olo = jnp.min(jnp.where(lv, o3, BIG), 1)
    ohi = jnp.max(jnp.where(lv, o3, -BIG), 1)
    ilo = jnp.min(jnp.where(lv, inv, BIG), 1)
    ihi = jnp.max(jnp.where(lv, inv, -BIG), 1)
    lvf = lv[:, :, 0]
    tmin_tile = jnp.min(jnp.where(lvf, tmin.reshape(T, TILE), BIG), 1)
    tmax_c = jnp.where(jnp.isfinite(tmax), tmax, BIG).reshape(T, TILE)
    tmax_tile = jnp.max(jnp.where(lvf, tmax_c, -BIG), 1)
    alive = jnp.any(lvf, 1)
    return olo, ohi, ilo, ihi, tmin_tile, tmax_tile, alive


def _dense_cull(wb: WideBVH, frus, tmax_t, swept):
    """frus: per-tile interval bounds; tmax_t [T]: current per-tile
    farthest useful t (tightens between waves); swept [T, B]: blocks
    already swept. Selects up to MAX_L NEAREST (by conservative entry
    t) unswept candidate blocks per tile. Returns (lst [T, MAX_L] with
    sentinel padding, nl [T], swept', done [T])."""
    olo, ohi, ilo, ihi, tmin_t, _, alive = frus
    T = olo.shape[0]
    B = wb.block_lo.shape[0]
    blo = wb.block_lo[None, :, :]      # [1, B, 3]
    bhi = wb.block_hi[None, :, :]
    u1 = blo - ohi[:, None, :]         # [T, B, 3]
    u2 = blo - olo[:, None, :]
    v1 = bhi - ohi[:, None, :]
    v2 = bhi - olo[:, None, :]
    il = ilo[:, None, :]
    ih = ihi[:, None, :]
    p = (u1 * il, u1 * ih, u2 * il, u2 * ih, v1 * il, v1 * ih, v2 * il, v2 * ih)
    e_min = p[0]
    x_max = p[0]
    for q in p[1:]:
        e_min = jnp.minimum(e_min, q)
        x_max = jnp.maximum(x_max, q)
    L = jnp.maximum(jnp.max(e_min, -1), tmin_t[:, None])   # [T, B]
    U = jnp.min(x_max, -1)
    sel = ((L <= U * 1.0001) & (L <= tmax_t[:, None]) & alive[:, None]
           & ~swept)
    count = jnp.sum(sel, 1)
    # nearest-first: top_k by -entry_t over candidates
    score = jnp.where(sel, -L, -jnp.inf)
    k = min(MAX_L, B)
    val, idx = jax.lax.top_k(score, k)
    got = val > -jnp.inf
    lst = jnp.where(got, idx.astype(jnp.int32), wb.n_blocks)
    if k < MAX_L:
        lst = jnp.concatenate(
            [lst, jnp.full((T, MAX_L - k), wb.n_blocks, jnp.int32)], -1)
        got = jnp.concatenate([got, jnp.zeros((T, MAX_L - k), bool)], -1)
    newly = jnp.zeros((T, B), bool).at[
        jnp.arange(T)[:, None], jnp.clip(lst, 0, B - 1)].max(got)
    swept = swept | newly
    nl = jnp.minimum(count, MAX_L).astype(jnp.int32)
    done = count <= MAX_L
    return lst, nl, swept, done


def _perray_candidates(wb: WideBVH, o_s, inv_s, tmin_s, t_cap, live):
    """Exact per-ray slab culling into per-tile entry-sorted candidate
    lists, computed ONCE per traversal.

    The tile-frustum interval test collapses for direction-mixed tiles
    (secondary bounces): reciprocal intervals straddling zero make the
    conservative bound infinite, so EVERY leaf block becomes a
    candidate. Testing each RAY against each block costs a dense fused
    [R, B] slab test (~20 flops per pair). Wave bodies then just
    CONSUME successive windows of the sorted list with a per-tile
    pointer — no re-culling, and the ascending entry order makes the
    per-wave acceptance test a prefix check against the tile's
    tightening t bound.

    Dead lanes dominate secondary bounces (they sort to the end), so
    the slab test runs through a while_loop over 64-tile chunks that
    stops at the last live chunk.

    Returns (cand_L [T, B] ascending entry t per tile (inf pad),
             cand_b [T, B] block ids in that order,
             count [T] number of real candidates)."""
    R = o_s.shape[0]
    T = R // TILE
    B = wb.block_lo.shape[0]
    TC_ = 64                                  # tiles per chunk
    nT = -(-T // TC_)
    pad_t = nT * TC_ - T

    o_p = jnp.pad(o_s, ((0, pad_t * TILE), (0, 0)))
    i_p = jnp.pad(inv_s, ((0, pad_t * TILE), (0, 0)))
    tmin_p = jnp.pad(tmin_s, (0, pad_t * TILE))
    tcap_p = jnp.pad(t_cap, (0, pad_t * TILE), constant_values=-BIG)
    live_p = jnp.pad(live, (0, pad_t * TILE))

    blo = wb.block_lo                         # [B, 3]
    bhi = wb.block_hi

    # live tiles are a sorted prefix: stop chunking at the last one
    live_tiles = jnp.any(live_p.reshape(nT * TC_, TILE), -1)
    n_live_chunks = jnp.max(jnp.where(
        jnp.any(live_tiles.reshape(nT, TC_), -1),
        jnp.arange(nT, dtype=jnp.int32) + 1, 0))

    def chunk_at(c, Lt):
        s = c * TC_ * TILE
        oc = lax.dynamic_slice(o_p, (s, 0), (TC_ * TILE, 3))
        ic = lax.dynamic_slice(i_p, (s, 0), (TC_ * TILE, 3))
        tminc = lax.dynamic_slice(tmin_p, (s,), (TC_ * TILE,))
        tcapc = lax.dynamic_slice(tcap_p, (s,), (TC_ * TILE,))
        livec = lax.dynamic_slice(live_p, (s,), (TC_ * TILE,))
        t1 = (blo[None, :, :] - oc[:, None, :]) * ic[:, None, :]
        t2 = (bhi[None, :, :] - oc[:, None, :]) * ic[:, None, :]
        L = jnp.maximum(jnp.max(jnp.minimum(t1, t2), -1), tminc[:, None])
        U = jnp.min(jnp.maximum(t1, t2), -1)
        ok = (L <= U * 1.0001) & (L <= tcapc[:, None]) & livec[:, None]
        Lm = jnp.where(ok, L, jnp.inf)        # [TC_*TILE, B]
        Lc = jnp.min(Lm.reshape(TC_, TILE, B), axis=1)
        return lax.dynamic_update_slice(Lt, Lc, (c * TC_, 0))

    Lt0 = jnp.full((nT * TC_, B), jnp.inf, jnp.float32)
    Lt = lax.while_loop(
        lambda s: s[0] < n_live_chunks,
        lambda s: (s[0] + 1, chunk_at(s[0], s[1])),
        (jnp.int32(0), Lt0))[1][:T]           # [T, B]

    bids = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[None, :], (T, B))
    cand_L, cand_b = lax.sort((Lt, bids), dimension=1, num_keys=1)
    count = jnp.sum(jnp.isfinite(Lt), 1).astype(jnp.int32)
    return cand_L, cand_b, count


def _window_cull(cand_L, cand_b, count, ptr, tile_t, sentinel_block):
    """Consume the next <= MAX_L candidates per tile whose entry t is
    within the tile's current bound. Ascending order makes acceptance a
    prefix; tile_t only tightens, so rejected entries stay rejected.
    Returns (lst [T, MAX_L], nl [T], ptr', done [T])."""
    T, B = cand_L.shape
    win = ptr[:, None] + jnp.arange(MAX_L, dtype=jnp.int32)[None, :]
    win_c = jnp.clip(win, 0, B - 1)
    wl = jnp.take_along_axis(cand_L, win_c, axis=1)
    wb_ = jnp.take_along_axis(cand_b, win_c, axis=1)
    ok = (win < count[:, None]) & (wl <= tile_t[:, None] * 1.0001)
    lst = jnp.where(ok, wb_, sentinel_block)
    nl = jnp.sum(ok.astype(jnp.int32), 1)
    ptr2 = ptr + nl
    done = (ptr2 >= count) | (nl == 0)
    return lst, nl, ptr2, done


def _morton3(q, bits):
    m = jnp.zeros(q.shape[0], jnp.uint32)
    for b in range(bits):
        m = (m
             | (((q[:, 0] >> b) & 1) << (3 * b))
             | (((q[:, 1] >> b) & 1) << (3 * b + 1))
             | (((q[:, 2] >> b) & 1) << (3 * b + 2)))
    return m


def _coherence_sort(o, d, world_lo, world_hi):
    """Sort key: origin Morton (high), direction octant+Morton (low).
    Pinhole batches (equal origins) sort into image-space blocks via the
    direction bits; scattered secondary rays group spatially first."""
    on = jnp.clip((o - world_lo) / jnp.maximum(world_hi - world_lo, 1e-12),
                  0.0, 1.0)
    qo = (on * 31.0).astype(jnp.uint32)          # 5 bits/axis -> 15
    mo = _morton3(qo, 5)
    oct_ = ((d[:, 0] < 0).astype(jnp.uint32)
            | ((d[:, 1] < 0).astype(jnp.uint32) << 1)
            | ((d[:, 2] < 0).astype(jnp.uint32) << 2))
    qd = (jnp.clip(d * 0.5 + 0.5, 0.0, 1.0) * 15.0).astype(jnp.uint32)
    md = _morton3(qd, 4)                          # 12 bits
    return (mo << 15) | (oct_ << 12) | md


def _sort_rays(o, d, tmin, tmax, world_lo, world_hi):
    """Coherence-sort rays. The ray columns ride along as lax.sort
    payload operands (one sort, no gathers through argsort indices).
    Returns sorted columns + the original index column (for the
    payload-unsort at the end). Dead rays (tmax <= tmin) sort to the
    end, packing themselves into all-dead tiles with empty leaf lists."""
    key = _coherence_sort(o, d, world_lo, world_hi)
    key = jnp.where(tmax > tmin, key, jnp.uint32(0xFFFFFFFF))
    idx = jnp.arange(o.shape[0], dtype=jnp.int32)
    (_, ox, oy, oz, dx, dy, dz, tmn, tmx, idx_s) = lax.sort(
        (key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         tmin, tmax, idx),
        dimension=0, num_keys=1, is_stable=True)
    o_s = jnp.stack([ox, oy, oz], -1)
    d_s = jnp.stack([dx, dy, dz], -1)
    return o_s, d_s, tmn, tmx, idx_s


@functools.partial(jax.jit,
                   static_argnames=("any_hit", "coherent", "interpret"))
def _wide_t_pass_chunk(wb: WideBVH, o, d, tmin, tmax, any_hit=False,
                       coherent=False, interpret=False):
    R = o.shape[0]
    T = R // TILE
    o_s, d_s, tmin_s, tmax_s, idx_s = _sort_rays(
        o, d, tmin, tmax, wb.world_lo, wb.world_hi)
    live_s = tmax_s > tmin_s
    frus = (_frusta(o_s, d_s, tmin_s, tmax_s, live_s, T)
            if coherent else None)

    rays8 = jnp.concatenate([o_s.T, d_s.T, tmin_s[None, :],
                             jnp.zeros((1, R), jnp.float32)], 0)

    # cap the pruning bound at the world-bbox exit: no hit can lie
    # beyond it, and it keeps miss rays from pinning their tile's
    # t_max at infinity (which would defeat inter-wave culling)
    safe_d = jnp.where(jnp.abs(d_s) > 1e-20, d_s,
                       jnp.where(d_s < 0, -1e-20, 1e-20))
    inv_s = 1.0 / safe_d
    t_a = (wb.world_lo[None, :] - o_s) * inv_s
    t_b = (wb.world_hi[None, :] - o_s) * inv_s
    exit_t = jnp.min(jnp.maximum(t_a, t_b), -1) * 1.001 + 1e-4
    cap = jnp.minimum(jnp.where(jnp.isfinite(tmax_s), tmax_s, BIG),
                      jnp.maximum(exit_t, 0.0))
    t_acc = jnp.where(live_s, cap, -BIG)
    p_acc = jnp.full((R,), -1, jnp.int32)
    done = jnp.zeros((T,), bool)

    def sweep(lst, nl, t_acc, p_acc):
        return sweep_leaves(lst, nl, rays8, t_acc, p_acc, wb.tris16,
                            interpret=interpret)

    def tile_bound(t_acc, p_acc):
        # per-tile farthest useful t; any-hit (shadow) queries retire a
        # lane at its FIRST hit — the reference's dedicated IntersectP
        # early-out (bvh.cpp:639-687)
        cap_lane = t_acc.reshape(T, TILE)
        if any_hit:
            hit_lane = (p_acc >= 0).reshape(T, TILE)
            return jnp.max(jnp.where(hit_lane, -BIG, cap_lane), 1)
        return jnp.max(cap_lane, 1)

    # Cull selection (static `coherent` hint from the caller):
    #   coherent  — per-wave tile-frustum interval test: near-free for
    #               camera/shadow beams whose tiles share signs.
    #   otherwise — ONE exact dense per-ray slab cull into entry-sorted
    #               per-tile candidate lists; waves consume successive
    #               windows via a pointer. For direction-mixed secondary
    #               bounces the frustum degenerates to "sweep
    #               everything".
    if coherent:
        swept = jnp.zeros((T, wb.block_lo.shape[0]), bool)

        def wave_body(s):
            swept, done, t_acc, p_acc, w = s
            lst, nl, swept, done = _dense_cull(
                wb, frus, tile_bound(t_acc, p_acc), swept)
            t_acc, p_acc = sweep(lst, nl, t_acc, p_acc)
            return swept, done, t_acc, p_acc, w + 1

        init = swept
    else:
        cand_L, cand_b, count = _perray_candidates(
            wb, o_s, inv_s, tmin_s, cap, live_s)

        def wave_body(s):
            ptr, done, t_acc, p_acc, w = s
            lst, nl, ptr, done = _window_cull(
                cand_L, cand_b, count, ptr, tile_bound(t_acc, p_acc),
                wb.n_blocks)
            t_acc, p_acc = sweep(lst, nl, t_acc, p_acc)
            return ptr, done, t_acc, p_acc, w + 1

        init = jnp.zeros((T,), jnp.int32)

    _, _, t_best, prim, _ = lax.while_loop(
        lambda s: jnp.any(~s[1]) & (s[4] < 64), wave_body,
        (init, done, t_acc, p_acc, jnp.int32(0)))

    # padded-slot -> global prim id; then undo the coherence sort
    # (payload-sort by the original index — no scatter)
    gprim = jnp.where(prim >= 0, wb.prim_map[jnp.clip(prim, 0, None)], -1)
    miss = (gprim < 0) | (t_best >= BIG) | ~live_s
    t_o = jnp.where(miss, BIG, t_best)
    p_o = jnp.where(miss, -1, gprim)
    _, t_out, p_out = lax.sort((idx_s, t_o, p_o), dimension=0, num_keys=1)
    return t_out, p_out


def wide_t_pass(wb: WideBVH, ray_o, ray_d, tmin, tmax, any_hit=False,
                coherent=False, interpret=False):
    """[R] rays -> (t [R], global prim [R], -1 = miss). Handles padding
    to TILE multiples and chunking for very large wavefronts. any_hit:
    occlusion semantics — lanes retire at the first confirmed hit (the
    returned t is then SOME hit, not the nearest). coherent: caller
    vouches the batch is beam-like (camera/shadow rays) — selects the
    cheap tile-frustum cull instead of the per-ray slab cull.
    interpret: run the leaf-sweep kernel in the Pallas interpreter
    (CPU tests)."""
    R = ray_o.shape[0]
    Rpad = max(TILE, (R + TILE - 1) // TILE * TILE)
    if Rpad != R:
        pad = Rpad - R
        ray_o = jnp.concatenate([ray_o, jnp.zeros((pad, 3), ray_o.dtype)])
        ray_d = jnp.concatenate([ray_d, jnp.ones((pad, 3), ray_d.dtype)])
        tmin = jnp.concatenate([tmin, jnp.zeros((pad,), tmin.dtype)])
        tmax = jnp.concatenate([tmax, jnp.full((pad,), -1.0, tmax.dtype)])
    outs_t, outs_p = [], []
    for s in range(0, Rpad, CHUNK):
        e = min(s + CHUNK, Rpad)
        t, p = _wide_t_pass_chunk(wb, ray_o[s:e], ray_d[s:e], tmin[s:e],
                                  tmax[s:e], any_hit=any_hit,
                                  coherent=coherent, interpret=interpret)
        outs_t.append(t)
        outs_p.append(p)
    t = outs_t[0] if len(outs_t) == 1 else jnp.concatenate(outs_t)
    p = outs_p[0] if len(outs_p) == 1 else jnp.concatenate(outs_p)
    return t[:R], p[:R]
