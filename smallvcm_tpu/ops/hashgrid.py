"""Fixed-radius neighbor search: cell-sorted photon index + pair expansion.

The reference HashGrid (hashgrid.hxx:32-214) counting-sorts particle indices
into per-cell CSR ranges and probes the 2x2x2 cell neighborhood nearest each
query (hashgrid.hxx:124-138). This re-design keeps those exact semantics
but maps each step to whole-array operations:

* build: ONE stable multi-operand lax.sort keyed by cell hash (iota
  tiebreak) sorts AND compacts in a single pass. CSR offsets come from a
  scatter-add histogram + cumsum (no searchsorted).

* query: instead of padding every probed cell to the max occupancy (gathers
  scale with 8*k_max), exact (query, photon) candidate pairs are expanded
  from the CSR ranges — work scales with the *actual* number of candidates.

The production merge pipeline lives in algorithms/vcm.py::merge_stage and
uses :func:`sort_compact_planes` + :func:`_hash_cell` with planar payload
gathers. :func:`build` / :func:`query_cell_ranges` / :func:`expand_pairs`
below are the simple reference implementation of the same semantics, kept as
the test oracle (tests/test_hashgrid.py checks both against brute force).

More cells than the reference's pixel-count choice (vertexcm.hxx:405-407)
are used by default: the cell count only affects hash-collision rate, never
results (candidates are always distance-filtered), and collisions directly
cost gather traffic here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def stable_radix_argsort(keys, total_bits: int):
    """Argsort of uint32 ``keys`` (values < 2**total_bits) via keys-only
    sorts. Returns the permutation (uint32 [M]); stable."""
    m = keys.shape[0]
    idx_bits = _ceil_log2(m)
    bpp = 32 - idx_bits
    assert bpp >= 1, "batch too large for packed radix"
    iota = jnp.arange(m, dtype=jnp.uint32)
    idx_mask = jnp.uint32((1 << idx_bits) - 1)

    order = iota
    shift = 0
    while shift < total_bits:
        k = keys[order] if shift else keys
        digit = (k >> jnp.uint32(shift)) & jnp.uint32((1 << bpp) - 1)
        packed = (digit << jnp.uint32(idx_bits)) | iota
        pos = jnp.sort(packed) & idx_mask
        order = order[pos]
        shift += bpp
    return order


def sort_compact_planes(keys, planes, cap: int, fused: bool = False):
    """Stable key-sort + compaction of a planar payload table in one shot.

    ``keys``: uint32 [M]; dead slots must carry a sentinel key strictly
    above every live key so they sort last (slicing the first ``cap``
    sorted slots IS the compaction). ``planes``: [P, M] f32 payload.
    Returns ``(planes_sorted [P, cap], src [cap] int32)`` where ``src`` is
    the flat source index of each compacted slot (callers derive path ids
    / vertex depths from it). Ties broken by source index (iota is the
    second sort key), so the result is the stable counting sort the
    reference builds imperatively (hashgrid.hxx:67-88).

    One multi-operand ``lax.sort`` replaces ``stable_radix_argsort`` +
    permute-gathers and subsumes the compaction gather.

    ``fused=True`` carries the payload planes through the sort itself
    ((2+P)-operand sort); ``fused=False`` (default, measured faster at
    production widths and the only differentiable form) argsorts
    ``(key, iota)`` and applies one [P, cap] payload gather.
    """
    m = keys.shape[0]
    iota = jnp.arange(m, dtype=jnp.int32)
    if fused:
        out = jax.lax.sort(
            (keys, iota) + tuple(planes[i] for i in range(planes.shape[0])),
            num_keys=2,
        )
        src = out[1]
        sorted_planes = jnp.stack(out[2:], axis=0)
        if cap <= m:
            return sorted_planes[:, :cap], src[:cap]
        pad = cap - m
        return (
            jnp.pad(sorted_planes, ((0, 0), (0, pad)), mode="edge"),
            jnp.concatenate([src, jnp.broadcast_to(src[m - 1:], (pad,))]),
        )
    _, src = jax.lax.sort((keys, iota), num_keys=2)
    # cap > m tail: repeat the LAST sorted column (a sentinel-key dead
    # slot whenever any slot is dead, since the sort is ascending) so
    # padding never aliases the first live column. Same padding in both
    # variants.
    if cap > m:
        src = jnp.concatenate(
            [src, jnp.broadcast_to(src[m - 1:], (cap - m,))]
        )
    else:
        src = src[:cap]
    return planes[:, src], src


class HashGrid(NamedTuple):
    bbox_min_x: jnp.ndarray
    bbox_min_y: jnp.ndarray
    bbox_min_z: jnp.ndarray
    bbox_max_x: jnp.ndarray
    bbox_max_y: jnp.ndarray
    bbox_max_z: jnp.ndarray
    inv_cell_size: jnp.ndarray
    sorted_idx: jnp.ndarray    # [M] particle index ordered by cell hash
    cell_start: jnp.ndarray    # [C]
    cell_count: jnp.ndarray    # [C]
    max_occupancy: jnp.ndarray  # scalar int32 (diagnostic)


def _hash_cell(cx, cy, cz, num_cells: int):
    """Spatial hash, same constants as hashgrid.hxx:179-187."""
    ux = cx.astype(jnp.uint32) * jnp.uint32(73856093)
    uy = cy.astype(jnp.uint32) * jnp.uint32(19349663)
    uz = cz.astype(jnp.uint32) * jnp.uint32(83492791)
    return ((ux ^ uy ^ uz) % jnp.uint32(num_cells)).astype(jnp.int32)


def build(pos, valid, radius, num_cells: int) -> HashGrid:
    """Build over V3-of-[M] positions with validity mask. Cell = 2*radius
    (hashgrid.hxx:64); invalid particles land in a sentinel cell."""
    big = jnp.float32(1e36)
    vmin = lambda a: jnp.min(jnp.where(valid, a, big))
    vmax = lambda a: jnp.max(jnp.where(valid, a, -big))
    mnx, mny, mnz = vmin(pos.x), vmin(pos.y), vmin(pos.z)
    mxx, mxy, mxz = vmax(pos.x), vmax(pos.y), vmax(pos.z)

    inv_cell = 1.0 / (radius * 2.0)
    cx = jnp.floor((pos.x - mnx) * inv_cell).astype(jnp.int32)
    cy = jnp.floor((pos.y - mny) * inv_cell).astype(jnp.int32)
    cz = jnp.floor((pos.z - mnz) * inv_cell).astype(jnp.int32)
    h = _hash_cell(cx, cy, cz, num_cells)
    h = jnp.where(valid, h, jnp.int32(num_cells))  # sentinel

    total_bits = _ceil_log2(num_cells + 1)
    order = stable_radix_argsort(h.astype(jnp.uint32), total_bits)

    counts = jnp.zeros((num_cells,), jnp.int32).at[h].add(
        1, mode="drop"
    )
    start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )

    return HashGrid(
        bbox_min_x=mnx, bbox_min_y=mny, bbox_min_z=mnz,
        bbox_max_x=mxx, bbox_max_y=mxy, bbox_max_z=mxz,
        inv_cell_size=jnp.asarray(inv_cell, jnp.float32),
        sorted_idx=order.astype(jnp.int32),
        cell_start=start,
        cell_count=counts,
        max_occupancy=jnp.max(counts).astype(jnp.int32),
    )


# 22 bits for the sorted-array start (supports 4.1M photons) + 10 bits for
# the per-cell count (max observed ~20; overflow is reported by callers via
# max_occupancy).
_COUNT_BITS = 10


def packed_ranges(grid: HashGrid):
    """(start << COUNT_BITS | count) per cell: halves the per-query gather
    traffic in query_cell_ranges (one gather instead of two)."""
    count = jnp.minimum(grid.cell_count, (1 << _COUNT_BITS) - 1)
    return (grid.cell_start << _COUNT_BITS) | count


def query_cell_ranges(grid: HashGrid, num_cells: int, qpos, packed=None):
    """Per-query (start, count) of the 8 probed cells.

    qpos: V3 of [Q]. Returns (starts [Q,8] int32, counts [Q,8] int32).
    Queries outside the particle bbox probe nothing (hashgrid.hxx:116-122).
    Pass ``packed_ranges(grid)`` to fetch both values with one gather per
    cell.
    """
    # Bbox rejection padded by the search radius (= half cell size): a
    # query within r of a particle can sit ULPs outside the tight particle
    # bbox (same-plane f32 hit points), and the 2x2x2 probe covers any
    # query within r regardless (see merge_stage's note in vcm.py).
    pad = 0.5 / grid.inv_cell_size
    in_bbox = (
        (qpos.x >= grid.bbox_min_x - pad) & (qpos.x <= grid.bbox_max_x + pad)
        & (qpos.y >= grid.bbox_min_y - pad) & (qpos.y <= grid.bbox_max_y + pad)
        & (qpos.z >= grid.bbox_min_z - pad) & (qpos.z <= grid.bbox_max_z + pad)
    )
    rel = lambda a, mn: (a - mn) * grid.inv_cell_size
    rx, ry, rz = (
        rel(qpos.x, grid.bbox_min_x),
        rel(qpos.y, grid.bbox_min_y),
        rel(qpos.z, grid.bbox_min_z),
    )
    bx, by, bz = (
        jnp.floor(rx).astype(jnp.int32),
        jnp.floor(ry).astype(jnp.int32),
        jnp.floor(rz).astype(jnp.int32),
    )
    sx = jnp.where(rx - jnp.floor(rx) < 0.5, -1, 1).astype(jnp.int32)
    sy = jnp.where(ry - jnp.floor(ry) < 0.5, -1, 1).astype(jnp.int32)
    sz = jnp.where(rz - jnp.floor(rz) < 0.5, -1, 1).astype(jnp.int32)

    starts = []
    counts = []
    for bit in range(8):
        cx = bx + (sx if bit & 1 else 0)
        cy = by + (sy if bit & 2 else 0)
        cz = bz + (sz if bit & 4 else 0)
        hc = _hash_cell(cx, cy, cz, num_cells)
        if packed is not None:
            p = packed[hc]
            s = p >> _COUNT_BITS
            c = p & ((1 << _COUNT_BITS) - 1)
        else:
            s = grid.cell_start[hc]
            c = grid.cell_count[hc]
        starts.append(s)
        counts.append(jnp.where(in_bbox, c, 0))
    return jnp.stack(starts, axis=1), jnp.stack(counts, axis=1)


def compact_indices(valid, cap: int):
    """Stream-compact a validity mask into source indices.

    Returns (idx [cap] int32 — flat source index per compacted slot, zero
    beyond the live range; count scalar; overflow scalar). Cost: one cumsum
    + one narrow scatter over [M] — the wide payload then moves with a
    single per-row gather (see merge_stage's design notes in
    algorithms/vcm.py).
    """
    m = valid.shape[0]
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    count = jnp.sum(valid.astype(jnp.int32))
    dst = jnp.where(valid, pos, cap)  # dropped -> OOB
    idx = jnp.zeros((cap,), jnp.int32).at[dst].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop"
    )
    return idx, count, jnp.maximum(count - cap, 0)


def expand_pairs(starts, counts, pair_cap: int):
    """Expand per-(query, cell) CSR ranges into an explicit pair list.

    starts/counts: [Q, 8]. Returns (qc_idx [P_cap], photon_pos [P_cap],
    pair_valid [P_cap], total_pairs scalar, overflow scalar) where qc_idx
    indexes the flattened [Q*8] (query, cell) axis and photon_pos indexes
    the grid's sorted order. Uses the scatter-boundary + cumsum segment
    trick — cost scales with actual candidates, not max cell occupancy.
    """
    q_n = counts.shape[0]
    qc = counts.reshape(-1)            # [Q*8]
    st = starts.reshape(-1)
    # Hierarchical exclusive prefix: one [Q] cumsum + an 8-wide axis-1
    # prefix instead of a [Q*8] cumsum (the long cumsum measured ~0.5 s at
    # 21M elements).
    per_q = jnp.sum(counts, axis=1)    # [Q]
    base = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(per_q)[:-1].astype(jnp.int32)]
    )
    prefix8 = jnp.concatenate(
        [jnp.zeros((q_n, 1), jnp.int32),
         jnp.cumsum(counts, axis=1)[:, :-1].astype(jnp.int32)],
        axis=1,
    )
    offs = (base[:, None] + prefix8).reshape(-1)
    total = base[-1] + per_q[-1]
    overflow = jnp.maximum(total - pair_cap, 0)

    # Segment id per pair: scatter each non-empty segment's id at its start
    # offset, then cummax carries it across the segment (empty segments
    # never scatter; overlapping starts keep the max, whose preceding
    # segments are empty there anyway).
    seg_first = jnp.zeros((pair_cap,), jnp.int32).at[offs].max(
        jnp.where(
            qc > 0,
            jnp.arange(qc.shape[0], dtype=jnp.int32),
            0,
        ),
        mode="drop",
    )
    qc_idx = jax.lax.cummax(seg_first)

    p = jnp.arange(pair_cap, dtype=jnp.int32)
    rank = p - offs[qc_idx]
    photon_pos = st[qc_idx] + rank
    pair_valid = (p < total) & (rank < qc[qc_idx]) & (rank >= 0)
    return qc_idx, photon_pos, pair_valid, total, overflow
