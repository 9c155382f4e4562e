"""Fixed-capacity neighbor lists built on the device.

The reference delegates neighbor search to the external jax-md library
(reference: README.md:27-33, examples/water_1024/run_admp.py:109-112) and then
filters pairs on host per step (admp/pme.py:671), which forces recompilation
whenever the pair count changes. Here neighbor lists are first-class and
fixed-shape: a fixed capacity is chosen once (with headroom), pairs are stored as
an (C, 2) int32 array padded with the sentinel index N (identical to jax-md's
OrderedSparse convention so the two are drop-in interchangeable), and the
*update* path is a single jit-compiled function with static shapes.

Two strategies:
  * dense O(N^2) mask + nonzero — simple, exact, fine to ~20k atoms;
  * cell list (linked via sorted cell ids + fixed neighbor stencil) for large N.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from admp_tpu.utils.linalg3 import inv3x3


@dataclasses.dataclass
class NeighborList:
    """Result container. ``pairs[k] = (i, j)`` with i < j for real entries and
    ``(n, n)`` for padding. ``did_overflow`` signals that capacity was exceeded
    and the list must be reallocated.

    ``i_sorted``: the pairs are non-decreasing in their i column (padding
    sorts last as (n, n)). Both strategies emit sorted lists by default; the
    flag feeds ``EngineConfig.pairs_i_sorted`` so the engines' backward pair
    gathers can use sorted segment-sums instead of random scatter-adds."""

    pairs: jnp.ndarray
    did_overflow: jnp.ndarray
    capacity: int
    cutoff: float
    i_sorted: bool = False

    @property
    def idx(self):
        """jax-md OrderedSparse-style (2, C) index array."""
        return self.pairs.T


@partial(jax.jit, static_argnames=("capacity",))
def _dense_pairs(positions, box, cutoff, capacity):
    n = positions.shape[0]
    box_inv = inv3x3(box)
    frac = positions @ box_inv
    # minimum-image pair distances via fractional wrap
    ds = frac[:, None, :] - frac[None, :, :]
    ds = ds - jnp.floor(ds + 0.5)
    dr = ds @ box
    r2 = jnp.sum(dr * dr, axis=-1)
    iu = jnp.triu_indices(n, k=1)
    within = r2[iu] < cutoff * cutoff
    n_found = jnp.sum(within)
    # compact indices of hits, padded with n
    order = jnp.nonzero(within, size=capacity, fill_value=within.shape[0])[0]
    ii = jnp.concatenate([iu[0], jnp.array([n])])[
        jnp.minimum(order, iu[0].shape[0])
    ]
    jj = jnp.concatenate([iu[1], jnp.array([n])])[
        jnp.minimum(order, iu[1].shape[0])
    ]
    valid = order < within.shape[0]
    pairs = jnp.stack(
        [jnp.where(valid, ii, n), jnp.where(valid, jj, n)], axis=-1
    ).astype(jnp.int32)
    return pairs, n_found > capacity


def _check_minimum_image(box, cutoff):
    half_min = float(np.min(np.abs(np.diag(np.asarray(box))))) / 2.0
    if cutoff > half_min:
        import warnings

        warnings.warn(
            f"cutoff {cutoff} exceeds half the box ({half_min}): the minimum-"
            "image convention is ambiguous and multipolar energies become "
            "discontinuous as pairs cross images; enlarge the box or shrink rc."
        )


def neighbor_list_dense(positions, box, cutoff, capacity=None, padding=1.25):
    """Allocate a dense-strategy neighbor list (host entry point).

    If ``capacity`` is None it is sized from the current configuration with
    ``padding`` headroom and rounded up to a multiple of 1024 (shape bucketing
    keeps recompiles rare).
    """
    positions = jnp.asarray(positions)
    box = jnp.asarray(box)
    _check_minimum_image(box, cutoff)
    if capacity is None:
        pairs, _ = _dense_pairs(positions, box, cutoff, positions.shape[0] * 64)
        n_real = int(jnp.sum(pairs[:, 0] < positions.shape[0]))
        capacity = int(-(-int(n_real * padding) // 1024) * 1024)
    pairs, overflow = _dense_pairs(positions, box, cutoff, capacity)
    # triu_indices are i-major and nonzero-compaction preserves order, so
    # dense lists are i-sorted by construction
    return NeighborList(pairs, overflow, capacity, float(cutoff),
                        i_sorted=True)


def update_neighbor_list(nlist: NeighborList, positions, box):
    """Jit-friendly refresh at fixed capacity."""
    pairs, overflow = _dense_pairs(positions, box, nlist.cutoff, nlist.capacity)
    return NeighborList(pairs, overflow, nlist.capacity, nlist.cutoff,
                        i_sorted=True)


def refresh_neighbor_list(nlist: NeighborList, positions, box):
    """Host-side refresh of any NeighborList (dense- or cell-strategy) that
    never hands back a silently-truncated list.

    Fast path: rebuild pairs at the stored fixed capacity (compiled once per
    shape). Falls back to a full re-allocation when the capacity overflows or
    — for cell lists — when the box changed enough that the stored cell grid
    no longer satisfies the cutoff (NPT volume moves). Intended cadence: once
    per MD segment / after each accepted barostat move; inside a jitted scan
    use update_neighbor_list / _cell_pairs directly and check did_overflow.
    """
    positions = jnp.asarray(positions)
    box = jnp.asarray(box)
    n_cells = getattr(nlist, "n_cells", None)
    if n_cells is not None:
        if tuple(_cell_grid(box, nlist.cutoff)) != tuple(n_cells):
            return neighbor_list_cell(positions, box, nlist.cutoff)
        sort_i = bool(getattr(nlist, "i_sorted", False))
        pairs, overflow = _cell_pairs(
            positions, box, nlist.cutoff, n_cells, nlist.cell_capacity,
            nlist.capacity, sort_i=sort_i,
        )
        if bool(overflow):
            return neighbor_list_cell(positions, box, nlist.cutoff)
        nl = NeighborList(pairs, overflow, nlist.capacity, nlist.cutoff,
                          i_sorted=sort_i)
        nl.n_cells = n_cells  # type: ignore[attr-defined]
        nl.cell_capacity = nlist.cell_capacity  # type: ignore[attr-defined]
        return nl
    nl = update_neighbor_list(nlist, positions, box)
    if bool(nl.did_overflow):
        return neighbor_list_dense(positions, box, nlist.cutoff)
    return nl


# ---------------------------------------------------------------------------
# Cell-list strategy for large systems
# ---------------------------------------------------------------------------


def _cell_grid(box, cutoff):
    lengths = np.abs(np.diag(np.asarray(box)))
    n_cells = np.maximum((lengths // cutoff).astype(int), 1)
    return tuple(int(c) for c in n_cells)


# Half stencil: the self cell (index 0, i<j dedupe) + the 13 displacements
# with (dx, dy, dz) lexicographically positive. Each unordered cell pair is
# visited exactly once (under PBC wrap with >= 3 cells per axis), so all
# (i, j) combinations across distinct cells count — no i<j filter — and the
# candidate array is 14/27 the size of the full-stencil version (the
# dominant allocation/compile cost at 100k atoms, ROADMAP round-1).
_HALF_STENCIL = np.array(
    [[0, 0, 0]]
    + [
        [dx, dy, dz]
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)
    ],
    dtype=np.int32,
)  # (14, 3)


def _cell_candidates(positions, box, cutoff, n_cells, cell_capacity):
    """Shared binning + half-stencil candidate generation.

    Returns (good, cand, i_ids, bucket_overflow) where ``good`` marks
    candidate slots that are real in-cutoff pairs, counted exactly once.

    Layout strategy: atoms are sorted into cell order with one packed-key
    sort, per-cell windows come from CONTIGUOUS takes of the sorted arrays,
    and candidate ids + coordinates ride ONE (n, 14)-row gather of a packed
    per-cell table instead of three (n, 14*cap) per-candidate ELEMENT
    gathers. Ids travel in the float table as VALUES (exact below 2^24; a
    bitcast would make them denormals, which a device that flushes
    denormals to zero would turn into phantom pairs — ROADMAP design
    item 3).
    """
    n = positions.shape[0]
    ncx, ncy, ncz = n_cells
    n_cell_total = ncx * ncy * ncz
    box_inv = inv3x3(box)
    frac = positions @ box_inv
    frac = frac - jnp.floor(frac)
    cx = jnp.minimum((frac[:, 0] * ncx).astype(jnp.int32), ncx - 1)
    cy = jnp.minimum((frac[:, 1] * ncy).astype(jnp.int32), ncy - 1)
    cz = jnp.minimum((frac[:, 2] * ncz).astype(jnp.int32), ncz - 1)
    cell_id = (cx * ncy + cy) * ncz + cz

    # cell-sorted atom order: single packed-key sort when the key fits int32
    bits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    if (n_cell_total << bits) < 2 ** 31:
        key = jnp.sort(
            cell_id * jnp.int32(1 << bits) + jnp.arange(n, dtype=jnp.int32)
        )
        order = jnp.bitwise_and(key, np.int32((1 << bits) - 1))
        sorted_cells = jnp.right_shift(key, np.int32(bits))
    else:  # pragma: no cover - >2^31 key space
        order = jnp.argsort(cell_id).astype(jnp.int32)
        sorted_cells = cell_id[order]
    c_iota = jnp.arange(n_cell_total, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_cells, c_iota).astype(jnp.int32)
    counts = (
        jnp.searchsorted(sorted_cells, c_iota + 1).astype(jnp.int32) - starts
    )
    bucket_overflow = jnp.any(counts > cell_capacity)
    take = starts[:, None] + jnp.arange(cell_capacity, dtype=jnp.int32)[None]
    take = jnp.minimum(take, n - 1)
    # slots past a cell's count alias the next cells' atoms: mask ids to the
    # n sentinel (the `cand < n` filter below drops them)
    slot_ok = (
        jnp.arange(cell_capacity, dtype=jnp.int32)[None] < counts[:, None]
    )

    assert n < 2 ** 24 or positions.dtype == jnp.float64, (
        "candidate ids ride a float32 table as exact values; >2^24 atoms "
        "need a wider id channel"
    )
    pos_s = positions[order]
    ids_w = jnp.where(slot_ok, order[take], n)  # (ncell, cap)
    table = jnp.concatenate(
        [
            ids_w.astype(positions.dtype),
            pos_s[:, 0][take],
            pos_s[:, 1][take],
            pos_s[:, 2][take],
        ],
        axis=1,
    )  # (ncell, 4*cap)

    stencil = jnp.asarray(_HALF_STENCIL)
    if CAND_METHOD == "cell":
        # per-CELL neighborhood table: every atom of a cell shares the same
        # 14 stencil rows, so gather them once per cell (14 * ncell rows)
        # and hand each atom ONE wide row — ~14x fewer row-gather ops than
        # the per-atom form
        cc = jnp.arange(ncx * ncy * ncz, dtype=jnp.int32)
        ccx = cc // (ncy * ncz)
        rem = cc % (ncy * ncz)
        cell_xyz = jnp.stack([ccx, rem // ncz, rem % ncz], axis=-1)
        neigh_c = cell_xyz[:, None, :] + stencil[None, :, :]
        neigh_cid = (
            jnp.mod(neigh_c[..., 0], ncx) * ncy
            + jnp.mod(neigh_c[..., 1], ncy)
        ) * ncz + jnp.mod(neigh_c[..., 2], ncz)  # (ncell, 14)
        cell_rows = table[neigh_cid.reshape(-1)].reshape(
            n_cell_total, -1
        )  # (ncell, 14 * 4 * cap)
        rows = cell_rows[cell_id]  # (n,) single wide rows
        rows = rows.reshape(n, -1, 4, cell_capacity)
    else:
        my_cell = jnp.stack([cx, cy, cz], axis=-1)  # (n, 3)
        neigh = my_cell[:, None, :] + stencil[None, :, :]
        neigh_id = (
            jnp.mod(neigh[..., 0], ncx) * ncy + jnp.mod(neigh[..., 1], ncy)
        ) * ncz + jnp.mod(neigh[..., 2], ncz)  # (n, 14)

        rows = table[neigh_id]  # (n, 14, 4*cap): the heavy row gather
        rows = rows.reshape(n, -1, 4, cell_capacity)
    cand = rows[:, :, 0].astype(jnp.int32).reshape(n, -1)
    # component planes throughout: (n, S) planes, no trailing dim of 3
    dx = rows[:, :, 1].reshape(n, -1) - positions[:, 0][:, None]
    dy = rows[:, :, 2].reshape(n, -1) - positions[:, 1][:, None]
    dz = rows[:, :, 3].reshape(n, -1) - positions[:, 2][:, None]
    # fractional wrap: s_i = sum_c dr_c * box_inv[c, i]
    s1 = dx * box_inv[0, 0] + dy * box_inv[1, 0] + dz * box_inv[2, 0]
    s2 = dx * box_inv[0, 1] + dy * box_inv[1, 1] + dz * box_inv[2, 1]
    s3 = dx * box_inv[0, 2] + dy * box_inv[1, 2] + dz * box_inv[2, 2]
    s1 = s1 - jnp.floor(s1 + 0.5)
    s2 = s2 - jnp.floor(s2 + 0.5)
    s3 = s3 - jnp.floor(s3 + 0.5)
    wx = s1 * box[0, 0] + s2 * box[1, 0] + s3 * box[2, 0]
    wy = s1 * box[0, 1] + s2 * box[1, 1] + s3 * box[2, 1]
    wz = s1 * box[0, 2] + s2 * box[1, 2] + s3 * box[2, 2]
    r2 = wx * wx + wy * wy + wz * wz
    i_ids = jnp.broadcast_to(jnp.arange(n)[:, None], cand.shape)
    # self cell (stencil slot 0): dedupe with i < j; other cells: every
    # combination is a distinct unordered pair already
    in_self = jnp.zeros((1, stencil.shape[0]), bool).at[0, 0].set(True)
    in_self = jnp.broadcast_to(
        in_self[:, :, None], (1, stencil.shape[0], cell_capacity)
    ).reshape(1, -1)
    dedupe = jnp.where(in_self, cand > i_ids, cand != i_ids)
    good = dedupe & (cand < n) & (r2 < cutoff * cutoff)
    return good, cand, i_ids, bucket_overflow


def _host_pair_count(positions, box, cutoff, n_cells) -> int:
    """Exact unordered within-cutoff pair count, pure numpy on the host.

    Used only to SIZE the fixed capacity during allocation — no device kernel,
    no compile. Mirrors the device _cell_candidates half-stencil semantics.
    """
    n = positions.shape[0]
    box_inv = np.linalg.inv(box)
    frac = positions @ box_inv
    frac -= np.floor(frac)
    ncx, ncy, ncz = (int(c) for c in n_cells)
    cx = np.minimum((frac[:, 0] * ncx).astype(np.int64), ncx - 1)
    cy = np.minimum((frac[:, 1] * ncy).astype(np.int64), ncy - 1)
    cz = np.minimum((frac[:, 2] * ncz).astype(np.int64), ncz - 1)
    cid = (cx * ncy + cy) * ncz + cz
    n_cell_total = ncx * ncy * ncz
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    counts = np.bincount(cid, minlength=n_cell_total)
    cap = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    buckets = np.full((n_cell_total, cap), n, dtype=np.int64)
    ranks = np.arange(n) - starts[sorted_cid]
    buckets[sorted_cid, ranks] = order
    pos_pad = np.vstack([positions, np.zeros((1, 3), positions.dtype)])
    my_cell = np.stack([cx, cy, cz], axis=-1)
    i_ids = np.arange(n)[:, None]
    total = 0
    for si, off in enumerate(np.asarray(_HALF_STENCIL)):
        nb = my_cell + off[None, :]
        nid = ((nb[:, 0] % ncx) * ncy + nb[:, 1] % ncy) * ncz + nb[:, 2] % ncz
        cand = buckets[nid]  # (n, cap)
        d = pos_pad[cand] - positions[:, None, :]
        s = d @ box_inv
        s -= np.floor(s + 0.5)
        w = s @ box
        r2 = np.einsum("nkc,nkc->nk", w, w)
        good = (cand > i_ids) if si == 0 else (cand != i_ids)
        good = good & (cand < n) & (r2 < cutoff * cutoff)
        total += int(good.sum())
    return total


@partial(jax.jit, static_argnames=("n_cells", "cell_capacity"))
def _cell_count(positions, box, cutoff, n_cells, cell_capacity):
    """Pair count only — a cheap compile (no capacity-wide compaction), used
    by the allocation path so the expensive nonzero kernel is compiled exactly
    once at the final bucketed capacity (instead of a probe compile of the
    full pipeline at a 16x over-sized capacity)."""
    good, _, _, bucket_overflow = _cell_candidates(
        positions, box, cutoff, n_cells, cell_capacity
    )
    return jnp.sum(good), bucket_overflow


# static per-row partner capacity for the two-stage compaction (water at
# rc=4 has ~13 half-neighbors/atom mean, ~40 max; overflow is flagged)
_ROW_K = 64

# stage-1 row-compaction strategy: 'sort' (full row value sort) or 'topk'
# (lax.top_k of the k_row smallest ids). Module-level for A/B probes; the
# jitted _cell_pairs reads it at trace time.
COMPACT_METHOD = "sort"

# candidate-gather strategy: 'atom' (per-atom (n, 14)-row gather) or 'cell'
# (per-cell neighborhood table + one wide row per atom — 14x fewer
# row-gather ops). Read at trace time. Both give identical pair lists (CPU
# equality test); which is faster on the GPU is ROADMAP design item 5.
CAND_METHOD = "cell"


@partial(jax.jit, static_argnames=("n_cells", "cell_capacity", "capacity",
                                   "sort_i"))
def _cell_pairs(positions, box, cutoff, n_cells, cell_capacity, capacity,
                sort_i=True):
    """Cell-list neighbor search with static shapes.

    Atoms are binned into cells of edge >= cutoff; candidate pairs come from
    the half stencil (self + 13 cells). All shapes static; overflow of the
    per-cell bucket, the per-row partner cap, or the pair capacity is
    reported.

    Compaction is TWO-STAGE (instead of one flat jnp.nonzero over the
    30M-slot candidate table):
    1. per-row: sort partner IDS (invalid slots -> n sentinel) along the
       (14*cell_capacity)-slot axis and keep the first _ROW_K — a vectorized
       row sort, no take_along_axis;
    2. rows -> flat (capacity,) list: row offsets by cumsum, output-slot ->
       row mapping by a tiny n-element scatter + cummax (instead of a
       searchsorted over capacity queries), then ONE flat element gather of
       the partner ids.
    """
    n = positions.shape[0]
    good, cand, i_ids, bucket_overflow = _cell_candidates(
        positions, box, cutoff, n_cells, cell_capacity
    )
    S = cand.shape[1]
    k_row = min(_ROW_K, S)
    n_found = jnp.sum(good)
    rowcnt = jnp.sum(good, axis=1).astype(jnp.int32)
    # stage 1: partner ids, row-compacted by value order (order within a row
    # is irrelevant — pair lists are consumed as sets). 'topk' keeps only
    # the k_row smallest ids via lax.top_k on the negated slots (O(S*k) vs
    # the full O(S log^2 S) row sort)
    if COMPACT_METHOD == "topk":
        neg, _ = jax.lax.top_k(-jnp.where(good, cand, n), k_row)
        cj = -neg
    else:
        cj = jnp.sort(jnp.where(good, cand, n), axis=1)[:, :k_row]
    # stage 2: offsets + segment-id expansion
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(rowcnt).astype(jnp.int32)]
    )
    mark = jnp.zeros(capacity, jnp.int32).at[
        jnp.minimum(offs[:-1], capacity - 1)
    ].max(jnp.arange(n, dtype=jnp.int32), mode="drop")
    r = jax.lax.cummax(mark)
    p_iota = jnp.arange(capacity, dtype=jnp.int32)
    k = p_iota - offs[r]
    valid = p_iota < offs[-1]
    flat_ix = jnp.minimum(r, n - 1) * k_row + jnp.minimum(k, k_row - 1)
    jj_raw = cj.ravel()[flat_ix]
    ii = jnp.where(valid, jnp.minimum(r, jj_raw), n).astype(jnp.int32)
    jj = jnp.where(valid, jnp.maximum(r, jj_raw), n).astype(jnp.int32)
    pairs = jnp.stack([ii, jj], axis=-1)
    if sort_i:
        # stage 2 emits rows in r order, but the canonical (min, max) swap
        # breaks global i-monotonicity; one stable argsort restores it
        # (padding ii == n sorts last). Costs one (capacity,) sort per
        # refresh; buys sorted-segment backward pair gathers every MD step
        # (EngineConfig.pairs_i_sorted).
        pairs = pairs[jnp.argsort(ii)]
    overflow = (
        (n_found > capacity) | bucket_overflow | jnp.any(rowcnt > k_row)
    )
    return pairs, overflow


def neighbor_list_cell(positions, box, cutoff, capacity=None, cell_capacity=None,
                       padding=1.25, sort_i=True):
    """Allocate a cell-list neighbor list for large systems.

    ``sort_i`` (default): emit the pair list non-decreasing in its i column
    (see NeighborList.i_sorted / EngineConfig.pairs_i_sorted)."""
    positions = jnp.asarray(positions)
    box = jnp.asarray(box)
    n = positions.shape[0]
    n_cells = _cell_grid(box, cutoff)
    if min(n_cells) < 3:
        # a 27-stencil over fewer than 3 cells per axis would visit the same cell
        # twice and duplicate pairs; the dense path is correct (and cheap) there
        return neighbor_list_dense(positions, box, cutoff, capacity, padding)
    n_cell_total = int(np.prod(n_cells))
    if cell_capacity is None:
        # size from the actual max cell occupancy (molecules cluster several
        # atoms per cell; a mean-based guess under-sizes water-like systems)
        box_inv = np.linalg.inv(np.asarray(box))
        frac = np.asarray(positions) @ box_inv
        frac -= np.floor(frac)
        cid = tuple(
            np.minimum((frac[:, d] * n_cells[d]).astype(int), n_cells[d] - 1)
            for d in range(3)
        )
        flat = (cid[0] * n_cells[1] + cid[1]) * n_cells[2] + cid[2]
        max_occ = int(np.bincount(flat).max())
        cell_capacity = max(int(np.ceil(max_occ * padding)) + 2, 8)
    if capacity is None:
        # host-side numpy pair count: sizing the capacity needs no device
        # kernel at all, so allocation pays ZERO probe compiles (~0.5 s in
        # numpy at 98k atoms)
        n_real = _host_pair_count(
            np.asarray(positions, np.float64), np.asarray(box, np.float64),
            float(cutoff), n_cells,
        )
        want = int(int(n_real) * padding)
        # coarse shape buckets: multiples of max(1024, 2^(log2(want)-3)) — at
        # most ~8 distinct capacities per octave, so refreshed allocations at
        # similar sizes reuse the compiled kernel instead of recompiling
        bucket = max(1024, 1 << max(int(want).bit_length() - 4, 10))
        capacity = -(-want // bucket) * bucket
    for _ in range(8):  # auto-retry: never hand back a silently-truncated list
        pairs, overflow = _cell_pairs(
            positions, box, cutoff, n_cells, cell_capacity, capacity,
            sort_i=sort_i,
        )
        if not bool(overflow):
            break
        cell_capacity *= 2
        capacity *= 2
    nl = NeighborList(pairs, overflow, capacity, float(cutoff),
                      i_sorted=bool(sort_i))
    nl.n_cells = n_cells  # type: ignore[attr-defined]
    nl.cell_capacity = cell_capacity  # type: ignore[attr-defined]
    return nl


# ---------------------------------------------------------------------------
# Sharded (slab-decomposed) pair search for device meshes
# ---------------------------------------------------------------------------


def sharded_cell_pairs(positions, box, cutoff, n_cells, cell_capacity,
                       capacity_per_device, axis_name):
    """Cell-list pair search decomposed over a mesh axis, for use INSIDE
    ``jax.shard_map``.

    Each device owns a contiguous slab of cells along the leading cell axis
    and emits only the pairs whose i-atom lives in its slab — a
    (capacity_per_device, 2) local block, which concatenated over the axis is
    exactly the P(axis_name, None)-sharded padded pair list the sharded
    energies consume (parallel/sharded.py). Positions are replicated (12 MB
    at 1M atoms — redistribution/halo exchange only pays once positions
    themselves are sharded, far beyond current scales); the per-device work
    scales as N/P because candidate generation runs only over the slab's
    atoms, which are CONTIGUOUS in cell-sorted order (cell ids sort by the
    leading axis first).

    ``n_cells[0]`` must be divisible by the axis size. Returns
    (pairs_local, overflow) where overflow is the psum'd global flag.
    """
    n = positions.shape[0]
    ncx, ncy, ncz = n_cells
    n_dev = jax.lax.axis_size(axis_name)
    dev = jax.lax.axis_index(axis_name)
    assert ncx % n_dev == 0, "leading cell axis must divide the mesh axis"
    slab_cx = ncx // n_dev
    # generous fixed slab capacity: 2x the mean + slack
    slab_cap = -(-2 * n // n_dev // 8) * 8 + 64

    box_inv = inv3x3(box)
    frac = positions @ box_inv
    frac = frac - jnp.floor(frac)
    cx = jnp.minimum((frac[:, 0] * ncx).astype(jnp.int32), ncx - 1)
    cy = jnp.minimum((frac[:, 1] * ncy).astype(jnp.int32), ncy - 1)
    cz = jnp.minimum((frac[:, 2] * ncz).astype(jnp.int32), ncz - 1)
    cell_id = (cx * ncy + cy) * ncz + cz

    order = jnp.argsort(cell_id)
    sorted_cells = cell_id[order]
    rank = jnp.arange(n) - jnp.searchsorted(sorted_cells, sorted_cells, side="left")
    n_cell_total = ncx * ncy * ncz
    buckets = jnp.full((n_cell_total, cell_capacity), n, dtype=jnp.int32)
    in_range = rank < cell_capacity
    buckets = buckets.at[
        sorted_cells, jnp.minimum(rank, cell_capacity - 1)
    ].set(jnp.where(in_range, order.astype(jnp.int32), n))
    cell_counts = jnp.zeros(n_cell_total, jnp.int32).at[cell_id].add(1)
    bucket_overflow = jnp.any(cell_counts > cell_capacity)

    # this device's i-atoms: contiguous block of the cell-sorted order
    slab_start = jnp.searchsorted(
        sorted_cells, dev * slab_cx * ncy * ncz, side="left"
    )
    slab_ids_raw = jax.lax.dynamic_slice_in_dim(
        jnp.concatenate([order.astype(jnp.int32),
                         jnp.full((slab_cap,), n, jnp.int32)]),
        slab_start, slab_cap,
    )
    in_slab = (cx[jnp.minimum(slab_ids_raw, n - 1)] // slab_cx) == dev
    i_atoms = jnp.where((slab_ids_raw < n) & in_slab, slab_ids_raw, n)
    slab_overflow = (
        jnp.sum((cx // slab_cx) == dev) > slab_cap
    )

    # half-stencil candidates for the slab atoms only
    stencil = jnp.asarray(_HALF_STENCIL)
    i_safe = jnp.minimum(i_atoms, n - 1)
    my_cell = jnp.stack([cx[i_safe], cy[i_safe], cz[i_safe]], axis=-1)
    neigh = my_cell[:, None, :] + stencil[None, :, :]
    neigh_id = (
        jnp.mod(neigh[..., 0], ncx) * ncy + jnp.mod(neigh[..., 1], ncy)
    ) * ncz + jnp.mod(neigh[..., 2], ncz)
    cand = buckets[neigh_id].reshape(slab_cap, -1)

    pos_pad = jnp.concatenate([positions, jnp.zeros((1, 3), positions.dtype)])
    px, py, pz = pos_pad[:, 0], pos_pad[:, 1], pos_pad[:, 2]
    ix = jnp.where(i_atoms < n, px[i_safe], jnp.inf)
    dx = px[cand] - ix[:, None]
    dy = py[cand] - py[i_safe][:, None]
    dz = pz[cand] - pz[i_safe][:, None]
    s1 = dx * box_inv[0, 0] + dy * box_inv[1, 0] + dz * box_inv[2, 0]
    s2 = dx * box_inv[0, 1] + dy * box_inv[1, 1] + dz * box_inv[2, 1]
    s3 = dx * box_inv[0, 2] + dy * box_inv[1, 2] + dz * box_inv[2, 2]
    s1 = s1 - jnp.floor(s1 + 0.5)
    s2 = s2 - jnp.floor(s2 + 0.5)
    s3 = s3 - jnp.floor(s3 + 0.5)
    wx = s1 * box[0, 0] + s2 * box[1, 0] + s3 * box[2, 0]
    wy = s1 * box[0, 1] + s2 * box[1, 1] + s3 * box[2, 1]
    wz = s1 * box[0, 2] + s2 * box[1, 2] + s3 * box[2, 2]
    r2 = jnp.where(jnp.isfinite(wx), wx * wx + wy * wy + wz * wz, jnp.inf)
    i_ids = jnp.broadcast_to(i_atoms[:, None], cand.shape)
    in_self = jnp.zeros((1, stencil.shape[0]), bool).at[0, 0].set(True)
    in_self = jnp.broadcast_to(
        in_self[:, :, None], (1, stencil.shape[0], cell_capacity)
    ).reshape(1, -1)
    dedupe = jnp.where(in_self, cand > i_ids, cand != i_ids)
    good = dedupe & (cand < n) & (i_ids < n) & (r2 < cutoff * cutoff)

    flat_good = good.ravel()
    n_found = jnp.sum(flat_good)
    sel = jnp.nonzero(
        flat_good, size=capacity_per_device, fill_value=flat_good.shape[0]
    )[0]
    valid = sel < flat_good.shape[0]
    sel_c = jnp.minimum(sel, flat_good.shape[0] - 1)
    ii_raw = i_ids.ravel()[sel_c]
    jj_raw = cand.ravel()[sel_c]
    ii = jnp.where(valid, jnp.minimum(ii_raw, jj_raw), n).astype(jnp.int32)
    jj = jnp.where(valid, jnp.maximum(ii_raw, jj_raw), n).astype(jnp.int32)
    pairs = jnp.stack([ii, jj], axis=-1)
    overflow = jax.lax.psum(
        ((n_found > capacity_per_device) | bucket_overflow | slab_overflow)
        .astype(jnp.int32),
        axis_name,
    ) > 0
    return pairs, overflow
