"""Dense device layout for the static quadtree: neighbor tables + jit guard
exchange with on-the-fly prolong/restrict.

This replaces the reference's recursive per-leaf guard fetch
(mara::get_cell_block, mesh_tree_operators.hpp:223-252: same-level leaf, or
prolong from parent, or combine+coarsen children) with precomputed static
tables and masked gathers over one [num_blocks, bs, bs, ncomp] array — the
whole exchange jit-compiles to a handful of gathers, shape-static, no
recursion (SURVEY.md §7 'hard parts').

A 2:1-balanced tree guarantees each face sees exactly one of three cases:
  0 = same-level neighbor        (copy its edge strip)
  1 = coarser neighbor           (prolong the matching half of its edge)
  2 = two finer neighbors        (restrict their edges 2x2)
Faces are numbered 0: x-lower, 1: x-upper, 2: y-lower, 3: y-upper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np

from mara3_tpu.mesh import tree as treemod
from mara3_tpu.mesh.tree import TreeIndex


@dataclass(frozen=True)
class NeighborTable:
    """Static per-block, per-face neighbor relations (int32 arrays)."""
    case: np.ndarray       # [B, 4] in {0 same, 1 coarse, 2 fine}
    same_id: np.ndarray    # [B, 4]
    coarse_id: np.ndarray  # [B, 4]
    coarse_half: np.ndarray  # [B, 4] which half of the coarse edge (0 lower)
    fine_id: np.ndarray    # [B, 4, 2] ordered by the perpendicular coordinate


def _face_neighbors(leaves: List[TreeIndex]):
    index_of = {leaf: b for b, leaf in enumerate(leaves)}
    leaf_set = set(leaves)
    B = len(leaves)
    case = np.zeros((B, 4), np.int32)
    same_id = np.zeros((B, 4), np.int32)
    coarse_id = np.zeros((B, 4), np.int32)
    coarse_half = np.zeros((B, 4), np.int32)
    fine_id = np.zeros((B, 4, 2), np.int32)

    for b, leaf in enumerate(leaves):
        level, i, j = leaf
        for axis in (0, 1):
            for side in (0, 1):
                f = 2 * axis + side
                n = treemod.neighbor(leaf, axis, side)
                if n in leaf_set:
                    case[b, f] = 0
                    same_id[b, f] = index_of[n]
                elif level > 0 and treemod.parent(n) in leaf_set:
                    case[b, f] = 1
                    coarse_id[b, f] = index_of[treemod.parent(n)]
                    coarse_half[b, f] = (j & 1) if axis == 0 else (i & 1)
                else:
                    kids = treemod.children(n)
                    # children of n adjacent to my face, ordered by the
                    # perpendicular coordinate (child k at x-half k&1,
                    # y-half k>>1)
                    if axis == 0:
                        ks = (1, 3) if side == 0 else (0, 2)
                    else:
                        ks = (2, 3) if side == 0 else (0, 1)
                    try:
                        case[b, f] = 2
                        fine_id[b, f, 0] = index_of[kids[ks[0]]]
                        fine_id[b, f, 1] = index_of[kids[ks[1]]]
                    except KeyError as e:
                        raise ValueError(
                            f"tree is not 2:1 balanced at {leaf} face {f}"
                        ) from e
    return NeighborTable(case, same_id, coarse_id, coarse_half, fine_id)


def build_neighbor_table(leaves: Sequence[TreeIndex]) -> NeighborTable:
    """Neighbor tables via the native C++ graph builder when built
    (mara3_tpu/native/tree_builder.cpp; cross-checked in test_native.py),
    else the pure-Python path."""
    from mara3_tpu import native
    if native.available():
        case, same, coarse, half, fine = native.neighbor_table(list(leaves))
        return NeighborTable(case, same, coarse, half, fine)
    return _face_neighbors(list(leaves))


def block_vertices(leaves: Sequence[TreeIndex], bs: int,
                   dtype=np.float64) -> np.ndarray:
    """[B, bs+1, bs+1, 2] vertex coordinates on the [-1,1]^2 root domain."""
    out = np.zeros((len(leaves), bs + 1, bs + 1, 2), dtype)
    for b, leaf in enumerate(leaves):
        x0, y0, w = treemod.block_extent(leaf)
        xv = x0 + w * np.arange(bs + 1) / bs
        yv = y0 + w * np.arange(bs + 1) / bs
        out[b, :, :, 0] = xv[:, None]
        out[b, :, :, 1] = yv[None, :]
    return out


def block_cell_centers(leaves: Sequence[TreeIndex], bs: int,
                       dtype=np.float64) -> np.ndarray:
    v = block_vertices(leaves, bs, dtype)
    return 0.25 * (v[:, :-1, :-1] + v[:, 1:, :-1] + v[:, :-1, 1:]
                   + v[:, 1:, 1:])


def block_dx(leaves: Sequence[TreeIndex], bs: int,
             dtype=np.float64) -> np.ndarray:
    """[B] cell size per block (square cells)."""
    return np.array([treemod.block_extent(leaf)[2] / bs for leaf in leaves],
                    dtype)


# -----------------------------------------------------------------------------
# jit guard exchange
# -----------------------------------------------------------------------------

def _edge(Ug, axis: int, edge_side: int, w: int):
    """Edge strip of width w on `axis` of gathered blocks Ug [B, n, n, C]."""
    n = Ug.shape[1 + axis]
    sl = slice(0, w) if edge_side == 0 else slice(n - w, n)
    index = [slice(None)] * Ug.ndim
    index[1 + axis] = sl
    return Ug[tuple(index)]


def _restrict2(a, axis: int):
    index0 = [slice(None)] * a.ndim
    index1 = [slice(None)] * a.ndim
    index0[axis] = slice(0, None, 2)
    index1[axis] = slice(1, None, 2)
    return 0.5 * (a[tuple(index0)] + a[tuple(index1)])


def guard_strip(U, nt: NeighborTable, axis: int, side: int, g: int):
    """The [B, g, n, C]-shaped (axis-0 convention; transposed for axis 1)
    guard strip outside face (axis, side) of every block, with level
    transitions handled by piecewise-constant prolongation / 2x2 averaging
    (reference restrict_cells/prolong_cells, mesh_prolong_restrict.hpp)."""
    f = 2 * axis + side
    n = U.shape[1]
    perp = 1 - axis
    neighbor_edge_side = 1 - side

    case = jnp.asarray(nt.case[:, f])
    shape_bcast = (slice(None), None, None, None)

    # case 0: same level
    same = _edge(U[jnp.asarray(nt.same_id[:, f])], axis,
                 neighbor_edge_side, g)

    # case 1: coarser neighbor — width ceil(g/2) edge, half along perp,
    # prolonged 2x in both directions, trimmed to g nearest the interface
    cw = (g + 1) // 2
    ce = _edge(U[jnp.asarray(nt.coarse_id[:, f])], axis,
               neighbor_edge_side, cw)
    half = jnp.asarray(nt.coarse_half[:, f])
    lo = _edge(ce, perp, 0, n // 2)
    hi = _edge(ce, perp, 1, n // 2)
    chalf = jnp.where(half[(slice(None),) + (None,) * (U.ndim - 1)] == 0,
                      lo, hi)
    cp = jnp.repeat(jnp.repeat(chalf, 2, axis=1 + axis), 2, axis=1 + perp)
    coarse = _edge(cp, axis, neighbor_edge_side, g)

    # case 2: two finer neighbors — width 2g edges, 2x2-averaged, stacked
    # along perp in perpendicular-coordinate order
    fa = _edge(U[jnp.asarray(nt.fine_id[:, f, 0])], axis,
               neighbor_edge_side, 2 * g)
    fb = _edge(U[jnp.asarray(nt.fine_id[:, f, 1])], axis,
               neighbor_edge_side, 2 * g)
    fa = _restrict2(_restrict2(fa, 1 + axis), 1 + perp)
    fb = _restrict2(_restrict2(fb, 1 + axis), 1 + perp)
    fine = jnp.concatenate([fa, fb], axis=1 + perp)

    c = case[(slice(None),) + (None,) * (U.ndim - 1)]
    return jnp.where(c == 0, same, jnp.where(c == 1, coarse, fine))


def extend_blocks(U, nt: NeighborTable, axis: int, g: int = 1):
    """All blocks extended by g guard cells on both sides of `axis`
    (the reference's per-leaf extend, subprog_amrsand.cpp:253-261 /
    subprog_binary_scheme.cpp:132-142, as one fused gather program)."""
    lo = guard_strip(U, nt, axis, 0, g)
    hi = guard_strip(U, nt, axis, 1, g)
    return jnp.concatenate([lo, U, hi], axis=1 + axis)


# -----------------------------------------------------------------------------
# host-side single-block fetch (API parity with mara::get_cell_block /
# get_vertex_block, mesh_tree_operators.hpp:223-292) — used by analysis and
# plotting code that wants one neighbor block at a caller's resolution; the
# hot path uses the vectorized guard_strip/extend_blocks instead.
# -----------------------------------------------------------------------------

def get_cell_block(leaves, blocks, index):
    """Cell data of the tree node `index` at its own resolution: the leaf
    itself, a prolonged quadrant of a coarser leaf, or the combined+
    coarsened four children. `blocks` is the dense [B, bs, bs, ...] array
    aligned with `leaves`."""
    from mara3_tpu.mesh import prolong_restrict as pr
    from mara3_tpu.mesh import tree as treemod

    order = {leaf: b for b, leaf in enumerate(leaves)}
    if index in order:
        return blocks[order[index]]
    parent = treemod.parent(index)
    if index[0] > 0 and parent in order:
        kids = pr.refine_cells_2d(blocks[order[parent]])
        level, i, j = index
        k = (i & 1) + 2 * (j & 1)
        return kids[k]
    children_blocks = [get_cell_block(leaves, blocks, c)
                       for c in treemod.children(index)]
    return pr.coarsen_cells_2d(pr.combine_cells_2d(children_blocks))


def get_vertex_block(leaves, vertex_blocks, index):
    """Vertex-flavored analog of get_cell_block."""
    from mara3_tpu.mesh import prolong_restrict as pr
    from mara3_tpu.mesh import tree as treemod

    order = {leaf: b for b, leaf in enumerate(leaves)}
    if index in order:
        return vertex_blocks[order[index]]
    parent = treemod.parent(index)
    if index[0] > 0 and parent in order:
        kids = pr.refine_verts_2d(vertex_blocks[order[parent]])
        level, i, j = index
        k = (i & 1) + 2 * (j & 1)
        return kids[k]
    children_blocks = [get_vertex_block(leaves, vertex_blocks, c)
                       for c in treemod.children(index)]
    return pr.coarsen_verts_2d(pr.combine_verts_2d(children_blocks))


# -----------------------------------------------------------------------------
# fast guard exchange: one gather + weighted sum
#
# extend_blocks above evaluates three candidate strips (same/coarse/fine)
# and mask-selects — ~20 XLA ops per axis. Every guard cell is a linear
# combination of at most 4 source cells, so the whole exchange collapses
# to one precomputed gather plus a 4-tap weighted sum. The sum is written
# elementwise (never as a dot) so it is exact in f32 on every backend: a
# matrix unit may round f32 operands (TF32 on NVIDIA GPUs), which would
# break the exact guard copies and conservation to round-off.
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class GuardGather:
    """indices [B, 4, bs, 4] flat into U.reshape(B*bs*bs, C);
    weights [B, 4, bs, 4]. Guard width 1 (the workloads' width)."""
    indices: np.ndarray
    weights: np.ndarray
    bs: int


def build_guard_gather(nt: NeighborTable, bs: int) -> GuardGather:
    B = nt.case.shape[0]
    idx = np.zeros((B, 4, bs, 4), np.int32)
    wts = np.zeros((B, 4, bs, 4), np.float64)

    def flat(b, i, j):
        return (b * bs + i) * bs + j

    for b in range(B):
        for axis in (0, 1):
            for side in (0, 1):
                f = 2 * axis + side
                edge = bs - 1 if side == 0 else 0   # neighbor's facing edge
                for p in range(bs):                  # position along face
                    if nt.case[b, f] == 0:
                        nb = nt.same_id[b, f]
                        src = ((nb, edge, p) if axis == 0
                               else (nb, p, edge))
                        idx[b, f, p, 0] = flat(*src)
                        wts[b, f, p, 0] = 1.0
                    elif nt.case[b, f] == 1:
                        nb = nt.coarse_id[b, f]
                        q = nt.coarse_half[b, f] * (bs // 2) + p // 2
                        src = ((nb, edge, q) if axis == 0
                               else (nb, q, edge))
                        idx[b, f, p, 0] = flat(*src)
                        wts[b, f, p, 0] = 1.0
                    else:
                        nb = nt.fine_id[b, f, 0 if p < bs // 2 else 1]
                        q = (2 * p) % bs
                        e2 = (bs - 2, bs - 1) if side == 0 else (1, 0)
                        # 2x2 average of the fine neighbor's edge cells;
                        # taps (0, 2) and (1, 3) are the two cells normal
                        # to the face at q and q + 1
                        cells = ([(nb, e2[0], q), (nb, e2[0], q + 1),
                                  (nb, e2[1], q), (nb, e2[1], q + 1)]
                                 if axis == 0 else
                                 [(nb, q, e2[0]), (nb, q + 1, e2[0]),
                                  (nb, q, e2[1]), (nb, q + 1, e2[1])])
                        for m, src in enumerate(cells):
                            idx[b, f, p, m] = flat(*src)
                            wts[b, f, p, m] = 0.25
    return GuardGather(idx, wts, bs)


def extend_blocks_fast(U, gg: GuardGather, axis: int):
    """extend_blocks with g=1 as one gather + weighted sum, bitwise equal
    to extend_blocks(U, nt, axis, 1): copies carry weight 1 on one tap,
    and the fine-case average sums the taps pairwise in extend_blocks'
    order (normal direction first), with power-of-two weights that scale
    exactly."""
    B, bs = U.shape[0], gg.bs
    C = U.shape[-1]
    flat = U.reshape(B * bs * bs, C)
    f_lo, f_hi = 2 * axis, 2 * axis + 1
    ii = jnp.asarray(gg.indices[:, (f_lo, f_hi)])        # [B, 2, bs, 4]
    ww = jnp.asarray(gg.weights[:, (f_lo, f_hi)], U.dtype)[..., None]
    t = ww * flat[ii]                                    # [B, 2, bs, 4, C]
    guards = ((t[:, :, :, 0] + t[:, :, :, 2])
              + (t[:, :, :, 1] + t[:, :, :, 3]))        # [B, 2, bs, C]
    if axis == 0:
        lo = guards[:, 0].reshape(B, 1, bs, C)
        hi = guards[:, 1].reshape(B, 1, bs, C)
        return jnp.concatenate([lo, U, hi], axis=1)
    lo = guards[:, 0].reshape(B, bs, 1, C)
    hi = guards[:, 1].reshape(B, bs, 1, C)
    return jnp.concatenate([lo, U, hi], axis=2)


def guard_strips_from_edges(E, nt, axis: int):
    """(lo, hi) one-cell guard strips [B, C, bs] from a prebuilt edge
    tensor E [Bg, C, 4, bs] holding rows/columns (0, 1, bs-2, bs-1) of
    every block along `axis` (Bg may be the global block count while `nt`
    holds one shard's rows with global ids). Index gathers only, so the
    strips are exact on every backend."""
    bs = E.shape[-1]
    half = bs // 2
    p = np.arange(bs)
    q = (2 * p) % bs

    def guard(side):
        f = 2 * axis + side
        # neighbor's facing edge: its high rows for my low side & vice versa
        e_last = 3 if side == 0 else 0    # single edge row slot in E
        e_pair = (2, 3) if side == 0 else (1, 0)  # (inner, edge) for fine

        same = E[jnp.asarray(nt.same_id[:, f])][:, :, e_last]
        crow = E[jnp.asarray(nt.coarse_id[:, f])][:, :, e_last]
        # coarse: guard[p] = row[h * half + p // 2], h the facing half
        cidx = jnp.asarray(nt.coarse_half[:, f])[:, None] * half + p // 2
        coarse = jnp.take_along_axis(crow, cidx[:, None, :], axis=2)
        # fine: the first (second) neighbor covers p < half (p >= half)
        g0 = E[jnp.asarray(nt.fine_id[:, f, 0])]
        g1 = E[jnp.asarray(nt.fine_id[:, f, 1])]
        a0 = 0.5 * (g0[:, :, e_pair[0]] + g0[:, :, e_pair[1]])
        a1 = 0.5 * (g1[:, :, e_pair[0]] + g1[:, :, e_pair[1]])
        fine = jnp.where(jnp.asarray(p < half),
                         0.5 * (a0[:, :, q] + a0[:, :, q + 1]),
                         0.5 * (a1[:, :, q] + a1[:, :, q + 1]))

        case = jnp.asarray(nt.case[:, f])[:, None, None]
        return jnp.where(case == 0, same,
                         jnp.where(case == 1, coarse, fine))

    return guard(0), guard(1)
