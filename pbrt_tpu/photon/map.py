"""Photon maps as sorted spatial-hash grids with fused, blocked kNN.

Replaces the reference's KdTree<Photon> + ClosePhoton max-heap kNN
(reference core/kdtree.h:63-186, core/photonshooter.h:186-203). The
batched form (SURVEY.md section 7): photons sorted by uniform-grid cell id;
cell start offsets by binary search; a kNN lookup gathers the 3x3x3
neighbor cells (capped per cell), computes squared distances and
top-k's them — fixed shapes, no heap, fully batched over query points.

Memory shaping:
  * Coordinates and directions are stored PACKED as [P, 4] rows
    (xyz + pad): one gather moves a contiguous 16-byte row instead of
    three scalar gathers of split [P] component arrays; XLA consumes
    the gathered rows in the fused distance computation without
    materializing [Q, M, 3] candidate tensors.
  * Spectra are stored TRANSPOSED [S, P] so the per-candidate gather
    is [S, Q, K], contiguous along the candidate axis.
  * The kNN lookups are two-phase (top-k on distances only, then
    gather k spectra) and FUSED: `knn_weighted_flux` takes a per-photon
    weight function and reduces to [Q, S] inside a query-blocked
    lax.map, so no [Q, K, S] tensor is ever materialized at full lane
    count.

The density-estimate normalization matches the reference kd-tree
contract (core/photonshooter.cpp:17-35 EPhoton, integrators/photonmap
.cpp LPhoton): the lookup radius passed to the kernel is the SHRUNK
maxDist2 — the kth-nearest distance when the heap filled (n_found >=
k), else the caller's maxDist2 unchanged.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.core import spectrum as spec

S = spec.N_BINS

# Default query block: bounds peak per-block kNN temps to ~tens of MB
# regardless of the wavefront tile size.
DEFAULT_BLOCK = 4096


class PhotonMap(NamedTuple):
    pxyz: jnp.ndarray        # [P, 4] packed coords (xyz + 0 pad),
                             # sorted by cell id
    alpha_t: jnp.ndarray     # [S, P] transposed spectra
    wixyz: jnp.ndarray       # [P, 4] packed incident directions
    cell_start: jnp.ndarray  # [C + 1] int32 prefix offsets
    grid_lo: jnp.ndarray     # [3]
    inv_cell: jnp.ndarray    # [3] cells per unit length
    dims: Tuple[int, int, int]  # static grid dims
    count: int               # number of photons (static)
    occ: jnp.ndarray = None  # [P] f32 occupancy of each photon's cell
    # (dense-cell truncation correction: a lookup that truncates a
    # cell to `cap` candidates weights each by occ/cap — the candidates
    # are a uniform subsample of the cell, keeping flux sums unbiased)


class MapStructure(NamedTuple):
    """Host-computed sorted-grid structure (the discrete part of a
    photon map). Separated from the alpha payload so pbrt_tpu.diff can
    rebuild maps with TRACED alphas over a fixed structure: the sort
    order is a constant index array, `alpha[order]` is a differentiable
    gather, and gradients flow from density estimates back into photon
    weights (and from there to light power / BSDF params)."""

    order: np.ndarray        # [P] photon sort order
    cell_start: np.ndarray   # [C + 1]
    occ: np.ndarray          # [P] cell occupancy (sorted order)
    lo: np.ndarray           # [3]
    inv_cell: np.ndarray     # [3]
    dims: Tuple[int, int, int]


def photon_map_structure(pos: np.ndarray, cell_size: float,
                         target_k: int = 0) -> Optional[MapStructure]:
    """Host: bucket photons on a uniform grid of `cell_size` (pick ~ the
    query maxdist so a 3x3x3 neighborhood covers the search radius).

    target_k > 0 enables density-adaptive sizing: the cell is grown so
    a 3x3x3 neighborhood holds >= ~2*target_k photons on average, which
    keeps kNN queries for large `nused` (pinkfloyd's 500) serviceable
    from the fixed 27-cell gather. Total cell count is bounded (not the
    per-axis dims) so huge maps can't blow up cell_start memory."""
    P = len(pos)
    if P == 0:
        return None
    pos = np.asarray(pos, np.float32)
    lo = pos.min(0) - 1e-4
    hi = pos.max(0) + 1e-4
    cell = max(float(cell_size), 1e-6)
    if target_k > 0:
        vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
        # 27 c^3 (P/V) >= 2k  =>  c >= (2 k V / (27 P))^(1/3)
        c_dens = (2.0 * target_k * vol / (27.0 * max(P, 1))) ** (1.0 / 3.0)
        cell = max(cell, c_dens)
    dims = np.maximum(1, np.ceil((hi - lo) / cell)).astype(np.int64)
    # bound TOTAL cells (cell_start memory), not per-axis dims
    max_cells = 1 << 24
    while int(np.prod(dims)) > max_cells:
        dims = np.maximum(1, dims // 2)
    inv_cell = dims / np.maximum(hi - lo, 1e-12)  # cells per unit
    cx = np.clip(((pos - lo) * inv_cell).astype(np.int64), 0, dims - 1)
    cid = (cx[:, 2] * dims[1] + cx[:, 1]) * dims[0] + cx[:, 0]
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    C = int(dims[0] * dims[1] * dims[2])
    cell_start = np.searchsorted(cid_s, np.arange(C + 1)).astype(np.int32)
    occ_p = np.bincount(cid_s, minlength=C)[cid_s].astype(np.float32)
    return MapStructure(order=order, cell_start=cell_start, occ=occ_p,
                        lo=lo.astype(np.float32),
                        inv_cell=inv_cell.astype(np.float32),
                        dims=(int(dims[0]), int(dims[1]), int(dims[2])))


def _pack4(a: np.ndarray) -> jnp.ndarray:
    out = np.zeros((len(a), 4), np.float32)
    out[:, :3] = a
    return jnp.asarray(out)


def build_photon_map_from(st: MapStructure, pos: np.ndarray, alpha,
                          wi: np.ndarray) -> PhotonMap:
    """Assemble a PhotonMap over a fixed structure. `alpha` [P, S] may
    be a TRACED array (differentiable path); pos/wi are concrete."""
    pos_s = np.asarray(pos, np.float32)[st.order]
    wi_s = np.asarray(wi, np.float32)[st.order]
    if isinstance(alpha, np.ndarray):
        alpha_t = jnp.asarray(np.asarray(alpha, np.float32)[st.order].T.copy())
    else:
        alpha_t = jnp.take(alpha, jnp.asarray(st.order), axis=0).T
    return PhotonMap(
        pxyz=_pack4(pos_s),
        alpha_t=alpha_t,
        wixyz=_pack4(wi_s),
        cell_start=jnp.asarray(st.cell_start),
        grid_lo=jnp.asarray(st.lo),
        inv_cell=jnp.asarray(st.inv_cell),
        dims=st.dims,
        count=len(pos_s),
        occ=jnp.asarray(st.occ),
    )


def build_photon_map(pos: np.ndarray, alpha: np.ndarray, wi: np.ndarray,
                     cell_size: float,
                     target_k: int = 0) -> Optional[PhotonMap]:
    """Host build (structure + concrete payload in one step)."""
    st = photon_map_structure(pos, cell_size, target_k)
    if st is None:
        return None
    return build_photon_map_from(st, pos, np.asarray(alpha, np.float32), wi)


def _gather_candidates(pm, q, per_cell_cap: int):
    """Candidate photon indices from the 3x3x3 cell neighborhood of
    each query: ([Q, 27*cap] indices, [Q, 27*cap] validity). Cells
    denser than per_cell_cap are TRUNCATED to their first `cap` photons
    (build order — spatially random within the cell); lookups correct
    for this via the per-photon cell occupancy (PhotonMap.occ)."""
    nx, ny, nz = pm.dims
    cq = ((q - pm.grid_lo) * pm.inv_cell)
    cxi = jnp.clip(jnp.floor(cq[..., 0]).astype(jnp.int32), 0, nx - 1)
    cyi = jnp.clip(jnp.floor(cq[..., 1]).astype(jnp.int32), 0, ny - 1)
    czi = jnp.clip(jnp.floor(cq[..., 2]).astype(jnp.int32), 0, nz - 1)

    cand_idx = []
    cand_ok = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                x = cxi + dx
                y = cyi + dy
                z = czi + dz
                inb = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
                xc = jnp.clip(x, 0, nx - 1)
                yc = jnp.clip(y, 0, ny - 1)
                zc = jnp.clip(z, 0, nz - 1)
                cid = (zc * ny + yc) * nx + xc
                start = pm.cell_start[cid]
                end = pm.cell_start[cid + 1]
                offs = jnp.arange(per_cell_cap, dtype=jnp.int32)
                idx = start[:, None] + offs[None, :]
                ok = inb[:, None] & (idx < end[:, None])
                cand_idx.append(jnp.clip(idx, 0, pm.count - 1))
                cand_ok.append(ok)
    return (jnp.concatenate(cand_idx, axis=1),
            jnp.concatenate(cand_ok, axis=1))


def _candidate_count(pm, qb) -> jnp.ndarray:
    """Total photon candidates in the 27-cell neighborhoods of a query
    block — a cheap [B, 27] cell_start probe, used to lax.cond-skip the
    full gather+top-k for blocks whose neighborhoods are all empty
    (march steps outside the photon cloud: most of a beam-localized
    workload like pinkfloyd's prism)."""
    nx, ny, nz = pm.dims
    cq = ((qb - pm.grid_lo) * pm.inv_cell)
    cxi = jnp.clip(jnp.floor(cq[..., 0]).astype(jnp.int32), 0, nx - 1)
    cyi = jnp.clip(jnp.floor(cq[..., 1]).astype(jnp.int32), 0, ny - 1)
    czi = jnp.clip(jnp.floor(cq[..., 2]).astype(jnp.int32), 0, nz - 1)
    total = jnp.zeros(qb.shape[:-1], jnp.int32)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                x, y, z = cxi + dx, cyi + dy, czi + dz
                inb = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny)
                       & (z >= 0) & (z < nz))
                cid = ((jnp.clip(z, 0, nz - 1) * ny + jnp.clip(y, 0, ny - 1))
                       * nx + jnp.clip(x, 0, nx - 1))
                cnt = pm.cell_start[cid + 1] - pm.cell_start[cid]
                total = total + jnp.where(inb, cnt, 0)
    return total


def _default_cap(k: int) -> int:
    # at least 24/cell: dense-cell truncation is corrected by the
    # inclusion-fraction weight, but a larger cap lowers its variance
    # AND tightens the found-set radius for big k (a 2k/27 cap made the
    # subsampled 300th-nearest radius overshoot in dense caustic cores,
    # smearing peaks ~2x low there)
    return max(24, -(-4 * k // 27))


def _topk_phase(pm, qb, k: int, max_dist2: float, per_cell_cap: int):
    """Phase 1 of the two-phase lookup, for ONE query block.

    Distances only: gathers candidate indices and split coordinates,
    top-k's squared distances. Returns (gi [B,K] photon ids, d2k [B,K],
    valid [B,K], r2_norm [B], r2_found [B], n_found [B]).

    r2_norm: the reference kd-tree's post-shrink maxDist2 — the kth
    distance only once the heap FILLS, else the caller's maxDist2
    (core/kdtree.h Lookup; used by EPhoton/surface LPhoton kernels).
    r2_found: max distance2 of the found set (used by the VOLUME
    LPhoton's 4/3 pi r^3 cell, photonvolume.cpp:88-100 maxmd).
    invf: per-selected-photon inverse inclusion fraction (dense-cell
    truncation correction; 1.0 for untruncated cells)."""
    idx, ok = _gather_candidates(pm, qb, per_cell_cap)      # [B, M]
    cand = jnp.take(pm.pxyz, idx, axis=0)                   # [B, M, 4] rows
    d2 = ((cand[..., 0] - qb[:, 0:1]) ** 2
          + (cand[..., 1] - qb[:, 1:2]) ** 2
          + (cand[..., 2] - qb[:, 2:3]) ** 2)
    d2 = jnp.where(ok & (d2 <= max_dist2), d2, jnp.inf)
    k_eff = min(k, d2.shape[1])
    neg_top, top_i = jax.lax.top_k(-d2, k_eff)
    d2k = -neg_top
    valid = jnp.isfinite(d2k)
    gi = jnp.take_along_axis(idx, top_i, axis=1)
    # dense-cell truncation correction from the photon's cell
    # occupancy (a [P]-array gather like wix/wiy, not a gather of a
    # broadcast [B, M] tensor)
    if pm.occ is not None:
        invf_k = jnp.maximum(pm.occ[gi] / float(per_cell_cap), 1.0)
    else:
        invf_k = jnp.ones_like(d2k)
    n_found = jnp.sum(valid.astype(jnp.int32), axis=1)
    kth = jnp.max(jnp.where(valid, d2k, 0.0), axis=1)
    r2_norm = jnp.where(n_found >= k_eff, kth, max_dist2)
    return (gi, d2k, valid, jnp.maximum(r2_norm, 1e-12),
            jnp.maximum(kth, 1e-12), n_found, invf_k)


def _block_map(fn, q, extras, block: int):
    """Run fn(q_block, *extras_block) over query blocks with lax.map.

    q: [Q, 3]; extras: arrays with leading dim Q. Outputs of fn (pytree
    with leading dim B) are concatenated back to leading dim Q."""
    Q = q.shape[0]
    if block <= 0 or Q <= block:
        return fn(q, *extras)
    nb = -(-Q // block)
    pad = nb * block - Q

    def padded(x):
        if pad:
            # pad with the LAST element: under occupancy compaction the
            # tail is the dead partition, so padding keeps it skippable
            x = jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)
        return x.reshape((nb, block) + x.shape[1:])

    xs = (padded(q),) + tuple(padded(e) for e in extras)
    out = jax.lax.map(lambda args: fn(*args), xs)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((nb * block,) + x.shape[2:])[:Q], out)


class FluxResult(NamedTuple):
    flux: jnp.ndarray      # [Q, S] (or [Q, W, S] for multi-channel weights)
    n_found: jnp.ndarray   # [Q] int32
    r2_norm: jnp.ndarray   # [Q] post-shrink kernel radius (surface contract)
    r2_found: jnp.ndarray  # [Q] found-set max dist2 (volume contract)


def knn_weighted_flux(pm: Optional[PhotonMap], q: jnp.ndarray, k: int,
                      max_dist2: float, weight_fn, extras=(),
                      per_cell_cap: int = 0,
                      block: int = DEFAULT_BLOCK,
                      compact: bool = False) -> FluxResult:
    """Fused kNN density estimate: flux[q] = sum_k w_k * alpha_k.

    weight_fn(wix, wiy, wiz, d2, valid, r2_norm, *extras_block) returns
    per-photon weights [B, K] — or [B, K, W] for W independent weight
    channels (e.g. reflection/transmission hemispheres), giving flux
    [Q, W, S]. extras are arrays with leading dim Q, sliced per block.

    Never materializes a [Q, K, S] tensor: queries run in
    `block`-sized chunks inside a lax.map.

    compact=True partitions queries by neighborhood occupancy before
    blocking (live first), so the block-level empty skip fires on the
    whole dead tail instead of only on blocks that HAPPEN to be all-
    empty. For beam-localized maps (pinkfloyd's prism: most march
    samples are nowhere near a photon) this turns most blocks into the
    54-gather probe. Costs one argsort + two permutations of [Q]-sized
    arrays — noise next to a single live block's top-k.
    """
    if pm is None:
        Q = q.shape[0]
        return FluxResult(
            flux=jnp.zeros((Q, S), jnp.float32),
            n_found=jnp.zeros((Q,), jnp.int32),
            r2_norm=jnp.full((Q,), max_dist2, jnp.float32),
            r2_found=jnp.full((Q,), max_dist2, jnp.float32),
        )
    cap = per_cell_cap if per_cell_cap > 0 else _default_cap(k)
    if block == DEFAULT_BLOCK:
        # auto-shrink for large k: bound the [S, B, K] gather to ~96 MB
        # (pinkfloyd's nused=500 would otherwise hold ~250 MB per
        # buffer inside the march loop)
        while block > 512 and S * block * max(k, 1) * 4 > (96 << 20):
            block //= 2

    def live_block(qb, *eb):
        gi, d2k, valid, r2n, r2f, n_found, invf = _topk_phase(
            pm, qb, k, max_dist2, cap)
        wsel = jnp.take(pm.wixyz, gi, axis=0)         # [B, K, 4]
        w = weight_fn(wsel[..., 0], wsel[..., 1], wsel[..., 2],
                      d2k, valid, r2n, *eb)
        A = jnp.take(pm.alpha_t, gi, axis=1)          # [S, B, K]
        if w.ndim == 3:
            w = jnp.where(valid[..., None], w * invf[..., None], 0.0)
            flux = jnp.einsum("sbk,bkw->bws", A, w)
        else:
            w = jnp.where(valid, w * invf, 0.0)
            flux = jnp.einsum("sbk,bk->bs", A, w)
        return FluxResult(flux=flux, n_found=n_found, r2_norm=r2n,
                          r2_found=r2f)

    def one_block(qb, *eb):
        # skip the gather+top-k entirely when every query's 27-cell
        # neighborhood is empty — in a marched workload most steps lie
        # outside the photon cloud, and the probe is 54 cheap gathers
        # vs a [S, B, K] gather + top-k per block
        B = qb.shape[0]
        any_cand = jnp.any(_candidate_count(pm, qb) > 0)
        flux_sd = jax.eval_shape(lambda: live_block(qb, *eb)).flux

        def dead(_):
            return FluxResult(
                flux=jnp.zeros(flux_sd.shape, flux_sd.dtype),
                n_found=jnp.zeros((B,), jnp.int32),
                r2_norm=jnp.full((B,), max(max_dist2, 1e-12), jnp.float32),
                r2_found=jnp.full((B,), max(max_dist2, 1e-12), jnp.float32),
            )

        return jax.lax.cond(any_cand, lambda _: live_block(qb, *eb),
                            dead, None)

    if compact and q.shape[0] > block:
        live = _candidate_count(pm, q) > 0
        order = jnp.argsort(jnp.where(live, 0, 1), stable=True)
        inv = jnp.argsort(order)
        q_s = jnp.take(q, order, axis=0)
        ex_s = tuple(jnp.take(e, order, axis=0) for e in extras)
        res = _block_map(one_block, q_s, ex_s, block)
        return jax.tree_util.tree_map(
            lambda x: jnp.take(x, inv, axis=0), res)

    return _block_map(one_block, q, tuple(extras), block)


def knn_dirs(pm: Optional[PhotonMap], q: jnp.ndarray, k: int,
             max_dist2: float, per_cell_cap: int = 0,
             block: int = DEFAULT_BLOCK):
    """Directions-only kNN (final-gather photon-cone importance
    sampling needs the found photons' wi vectors, not their spectra).

    Returns (wix, wiy, wiz, valid) each [Q, K]."""
    if pm is None:
        Q = q.shape[0]
        z = jnp.zeros((Q, k), jnp.float32)
        return z, z, z, jnp.zeros((Q, k), bool)
    cap = per_cell_cap if per_cell_cap > 0 else _default_cap(k)

    def one_block(qb):
        gi, _d2k, valid, _r2n, _r2f, _nf, _invf = _topk_phase(
            pm, qb, k, max_dist2, cap)
        wsel = jnp.take(pm.wixyz, gi, axis=0)
        return wsel[..., 0], wsel[..., 1], wsel[..., 2], valid

    return _block_map(one_block, q, (), block)


class KnnResult(NamedTuple):
    alpha: jnp.ndarray   # [Q, K, S]
    wi: jnp.ndarray      # [Q, K, 3]
    dist2: jnp.ndarray   # [Q, K]
    valid: jnp.ndarray   # [Q, K]
    r2_max: jnp.ndarray  # [Q] kth dist2 when the heap filled, else maxdist2


def knn_lookup(pm: PhotonMap, q: jnp.ndarray, k: int, max_dist2: float,
               per_cell_cap: int = 0) -> KnnResult:
    """Materialized k-nearest lookup (tests / small query sets ONLY —
    renders use the fused knn_weighted_flux / knn_dirs, which never
    build the [Q, K, S] tensors this returns)."""
    cap = per_cell_cap if per_cell_cap > 0 else _default_cap(k)
    gi, d2k, valid, r2, _r2f, _nf, invf = _topk_phase(pm, q, k, max_dist2, cap)
    alpha = jnp.moveaxis(jnp.take(pm.alpha_t, gi, axis=1), 0, -1)  # [Q,K,S]
    alpha = alpha * invf[..., None]  # dense-cell truncation correction
    wi = jnp.take(pm.wixyz, gi, axis=0)[..., :3]
    return KnnResult(
        alpha=jnp.where(valid[..., None], alpha, 0.0),
        wi=wi,
        dist2=jnp.where(valid, d2k, 0.0),
        valid=valid,
        r2_max=r2,
    )


def ephoton(pm: Optional[PhotonMap], q, n, k: int, max_dist2: float,
            block: int = DEFAULT_BLOCK):
    """Irradiance estimate at (q, n) from a photon map (reference
    core/photonshooter.cpp EPhoton :17-35): sum of alpha over the k
    nearest photons with dot(n, wi) > 0, divided by (md2 * pi) where
    md2 is the post-shrink lookup radius — the map's alphas are
    already 1/nshot-normalized at build. [Q, S]."""
    if pm is None:
        return jnp.zeros(q.shape[:-1] + (S,), jnp.float32)

    def weight(wix, wiy, wiz, d2, valid, r2, nb):
        front = wix * nb[:, 0:1] + wiy * nb[:, 1:2] + wiz * nb[:, 2:3] > 0.0
        return front.astype(jnp.float32)

    res = knn_weighted_flux(pm, q, k, max_dist2, weight,
                            extras=(n,), block=block)
    return res.flux / (res.r2_norm[..., None] * jnp.pi)


class RadianceMap(NamedTuple):
    """Radiance photons (reference photonshooter.h:30-37 RadiancePhoton
    {p, n, Lo}) on the same sorted-grid layout; queried by
    nearest-with-matching-hemisphere (RadiancePhotonProcess,
    photonshooter.h:63-77)."""

    pxyz: jnp.ndarray        # [P, 4] packed, sorted by cell id
    lo_t: jnp.ndarray        # [S, P] precomputed outgoing radiance Lo
    nxyz: jnp.ndarray        # [P, 4] packed surface normals
    cell_start: jnp.ndarray  # [C + 1]
    grid_lo: jnp.ndarray
    inv_cell: jnp.ndarray
    dims: Tuple[int, int, int]
    count: int


def build_radiance_map(pos: np.ndarray, lo_rad: np.ndarray, n: np.ndarray,
                       cell_size: float) -> Optional[RadianceMap]:
    base = build_photon_map(pos, lo_rad, n, cell_size)
    if base is None:
        return None
    return RadianceMap(pxyz=base.pxyz,
                       lo_t=base.alpha_t,
                       nxyz=base.wixyz,
                       cell_start=base.cell_start, grid_lo=base.grid_lo,
                       inv_cell=base.inv_cell, dims=base.dims,
                       count=base.count)


def radiance_lookup(rm: Optional[RadianceMap], q, n,
                    per_cell_cap: int = 16, block: int = DEFAULT_BLOCK):
    """Nearest radiance photon whose normal faces the query hemisphere
    (reference RadiancePhotonProcess, photonshooter.h:63-77: nearest
    candidate with dot(rp.n, n) > 0 — the hemisphere test is applied
    BEFORE choosing the nearest). The reference searches an unbounded
    radius through the kd-tree; the grid form searches the 27-cell
    neighborhood. Returns (Lo [Q, S], found [Q])."""
    if rm is None:
        Q = q.shape[0]
        return jnp.zeros((Q, S), jnp.float32), jnp.zeros((Q,), bool)

    def one_block(qb, nb):
        idx, ok = _gather_candidates(rm, qb, per_cell_cap)   # [B, M]
        cand = jnp.take(rm.pxyz, idx, axis=0)                # [B, M, 4]
        d2 = ((cand[..., 0] - qb[:, 0:1]) ** 2
              + (cand[..., 1] - qb[:, 1:2]) ** 2
              + (cand[..., 2] - qb[:, 2:3]) ** 2)
        nc = jnp.take(rm.nxyz, idx, axis=0)
        front = (nc[..., 0] * nb[:, 0:1] + nc[..., 1] * nb[:, 1:2]
                 + nc[..., 2] * nb[:, 2:3]) > 0.0
        d2 = jnp.where(ok & front, d2, jnp.inf)
        best = jnp.argmin(d2, axis=1)                        # [B]
        found = jnp.isfinite(jnp.take_along_axis(d2, best[:, None], 1)[:, 0])
        sel = jnp.take_along_axis(idx, best[:, None], 1)[:, 0]
        lo_sel = jnp.take(rm.lo_t, sel, axis=1).T            # [B, S]
        return jnp.where(found[:, None], lo_sel, 0.0), found

    return _block_map(one_block, q, (n,), block)
