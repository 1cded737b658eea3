"""AMR layer tests: prolong/restrict exactness, tree build/balance, and the
dense-layout guard exchange against the reference semantics (model:
reference mesh_test.cpp:43-159 plus the multi-level exchange the reference
only exercises implicitly through get_cell_block)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mara3_tpu.mesh import block_layout, prolong_restrict as pr, tree


# -----------------------------------------------------------------------------
# prolong/restrict (reference mesh_test.cpp:43-111)
# -----------------------------------------------------------------------------

def test_prolong_verts_exact_on_linear():
    # midpoint interpolation is exact for linear data
    x = jnp.linspace(0.0, 1.0, 9)
    fine = pr.prolong_verts(x, 0)
    np.testing.assert_allclose(fine, jnp.linspace(0.0, 1.0, 17), atol=1e-15)


def test_restrict_verts_inverts_prolong():
    x = jnp.sin(jnp.linspace(0.0, 3.0, 9))
    np.testing.assert_array_equal(pr.restrict_verts(pr.prolong_verts(x, 0), 0), x)


def test_restrict_cells_inverts_prolong_cells():
    x = jnp.sin(jnp.linspace(0.0, 3.0, 8))
    np.testing.assert_allclose(pr.restrict_cells(pr.prolong_cells(x, 0), 0),
                               x, rtol=1e-15)


def test_refine_coarsen_cells_2d_round_trip():
    a = jnp.arange(16.0).reshape(4, 4)
    kids = pr.refine_cells_2d(a)
    assert all(k.shape == (4, 4) for k in kids)
    back = pr.coarsen_cells_2d(pr.combine_cells_2d(kids))
    np.testing.assert_allclose(back, a, rtol=1e-15)


def test_combine_verts_2d_round_trip():
    a = jnp.arange(25.0).reshape(5, 5)
    kids = pr.refine_verts_2d(a)
    assert all(k.shape == (5, 5) for k in kids)
    back = pr.coarsen_verts_2d(pr.combine_verts_2d(kids))
    np.testing.assert_allclose(back, a, rtol=1e-15)


def test_restrict_extrinsic_sums():
    a = jnp.array([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(pr.restrict_extrinsic(a, 0), [3.0, 7.0])


# -----------------------------------------------------------------------------
# tree build / balance / hilbert
# -----------------------------------------------------------------------------

def test_uniform_tree():
    leaves = tree.create_quadtree(lambda lvl, r: True, 2)
    assert len(leaves) == 16
    assert all(l == 2 for l, _, _ in leaves)


def test_focused_tree_is_balanced():
    leaves = tree.create_quadtree(lambda lvl, r: r < 1.5 / (lvl + 1), 4)
    assert not tree.over_refined_neighbors(set(leaves))
    # levels present should span more than one
    assert len({l for l, _, _ in leaves}) > 1


def test_hilbert_order_is_local():
    # consecutive blocks along the curve are spatially adjacent at the
    # uniform level
    leaves = tree.create_quadtree(lambda lvl, r: True, 3)
    centers = [(i + 0.5, j + 0.5) for _, i, j in leaves]
    dists = [abs(a[0] - b[0]) + abs(a[1] - b[1])
             for a, b in zip(centers, centers[1:])]
    assert max(dists) == 1.0  # Hilbert curve: unit steps only


def test_block_geometry():
    leaves = [(1, 0, 0), (1, 1, 0), (1, 0, 1), (1, 1, 1)]
    v = block_layout.block_vertices(leaves, 4)
    assert v.shape == (4, 5, 5, 2)
    np.testing.assert_allclose(v[0, 0, 0], [-1.0, -1.0])
    np.testing.assert_allclose(v[3, -1, -1], [1.0, 1.0])
    np.testing.assert_allclose(block_layout.block_dx(leaves, 4), 0.25)


# -----------------------------------------------------------------------------
# guard exchange on the dense layout
# -----------------------------------------------------------------------------

def field(x, y):
    return jnp.sin(2.1 * x) + jnp.cos(1.3 * y) + 0.2 * x * y


def make_blocks(leaves, bs):
    xc = jnp.asarray(block_layout.block_cell_centers(leaves, bs))
    return field(xc[..., 0], xc[..., 1])[..., None]


def test_same_level_exchange_exact():
    leaves = tree.create_quadtree(lambda lvl, r: True, 2)
    bs = 8
    nt = block_layout.build_neighbor_table(leaves)
    U = make_blocks(leaves, bs)
    for axis in (0, 1):
        ue = block_layout.extend_blocks(U, nt, axis=axis, g=1)
        for b, leaf in enumerate(leaves):
            nb_lo = leaves.index(tree.neighbor(leaf, axis, 0))
            got = ue[b, 0, :, 0] if axis == 0 else ue[b, :, 0, 0]
            want = (U[nb_lo, -1, :, 0] if axis == 0 else U[nb_lo, :, -1, 0])
            np.testing.assert_array_equal(got, want)


def test_coarse_fine_exchange_values():
    """One refined quadrant next to coarse blocks: guards at level jumps
    must equal the reference's prolong/restrict of the neighbor data."""
    # root split once; child (1,0,0) split again -> 3 coarse + 4 fine leaves
    leaves = sorted(
        {(1, 1, 0), (1, 0, 1), (1, 1, 1)} | set(tree.children((1, 0, 0))),
        key=tree.hilbert_key)
    bs = 8
    nt = block_layout.build_neighbor_table(leaves)
    U = make_blocks(leaves, bs)

    # coarse block (1,1,0) has fine neighbors on its x-lower face
    b = leaves.index((1, 1, 0))
    ue = block_layout.extend_blocks(U, nt, axis=0, g=1)
    got = ue[b, 0, :, 0]
    # expected: 2x2 average of the two fine blocks' x-upper edges (width 2)
    fa = leaves.index((2, 1, 0))   # x-half 1, y-lower of (1,0,0)
    fb = leaves.index((2, 1, 1))
    stripe = jnp.concatenate([U[fa, -2:, :, 0], U[fb, -2:, :, 0]], axis=1)
    want = 0.25 * (stripe[0, 0::2] + stripe[0, 1::2]
                   + stripe[1, 0::2] + stripe[1, 1::2])
    np.testing.assert_allclose(got, want, rtol=1e-14)

    # fine block (2,1,0) has the coarse neighbor (1,1,0) on its x-upper face
    bf = leaves.index((2, 1, 0))
    got = ue[bf, -1, :, 0]
    # expected: piecewise-constant prolongation of the coarse neighbor's
    # x-lower edge, lower-y half (fine block sits at y-lower of the face)
    coarse_edge = U[b, 0, : bs // 2, 0]
    want = jnp.repeat(coarse_edge, 2)
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_guard_width_2():
    leaves = sorted(
        {(1, 1, 0), (1, 0, 1), (1, 1, 1)} | set(tree.children((1, 0, 0))),
        key=tree.hilbert_key)
    bs = 8
    nt = block_layout.build_neighbor_table(leaves)
    U = make_blocks(leaves, bs)
    ue = block_layout.extend_blocks(U, nt, axis=0, g=2)
    assert ue.shape == (len(leaves), bs + 4, bs, 1)
    # same-level: two guard cells equal neighbor's last two rows
    b = leaves.index((1, 0, 1))
    nb = leaves.index((1, 1, 1))  # wraparound x-lower neighbor
    np.testing.assert_array_equal(ue[b, 0:2, :, 0], U[nb, -2:, :, 0])


def test_amrsand_uniform_matches_single_grid():
    """With a uniform quadtree the AMR update must equal a plain periodic
    upwind update on the assembled global grid."""
    from mara3_tpu.subprograms import amrsand
    from mara3_tpu.app.config import ConfigTemplate

    cfg = (amrsand.config_template().create()
           .update({"depth": 2, "block_size": 8}))
    leaves = tuple(tree.create_quadtree(lambda lvl, r: True, 2))
    bs = 8
    xc = block_layout.block_cell_centers(leaves, bs)
    u = np.exp(-(xc[..., 0] ** 2 + xc[..., 1] ** 2) / 0.025)[..., None]
    state = amrsand.Solution(0, 0.0, leaves, jnp.asarray(u))
    nt = block_layout.build_neighbor_table(leaves)
    dxb = jnp.asarray(block_layout.block_dx(leaves, bs))
    s1 = amrsand.next_solution(state, nt, dxb)

    # assemble global grid (4x4 blocks of 8x8 -> 32x32)
    n_per = 4
    def assemble(blocks):
        G = np.zeros((n_per * bs, n_per * bs))
        for b, (l, i, j) in enumerate(leaves):
            G[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = \
                np.asarray(blocks[b, :, :, 0])
        return G

    G0 = assemble(np.asarray(state.conserved))
    dx = 2.0 / (n_per * bs)
    dt = 2.0 / bs / (1 << tree.tree_depth(leaves))
    fx = 0.5 * np.roll(G0, 1, axis=0)      # upwind: left cell value
    fy = 0.5 * np.roll(G0, 1, axis=1)
    G1 = G0 - dt / dx * ((np.roll(fx, -1, 0) - fx) + (np.roll(fy, -1, 1) - fy))
    np.testing.assert_allclose(assemble(np.asarray(s1.conserved)), G1,
                               rtol=1e-13, atol=1e-15)


def test_amrsand_blob_advects():
    from mara3_tpu.subprograms import amrsand

    cfg = (amrsand.config_template().create()
           .update({"depth": 3, "block_size": 8}))
    state = amrsand.new_solution(cfg)
    nt = block_layout.build_neighbor_table(state.leaves)
    dxb = jnp.asarray(block_layout.block_dx(state.leaves, 8))
    xc = jnp.asarray(block_layout.block_cell_centers(state.leaves, 8))
    dA = (dxb ** 2)[:, None, None]

    def center_of_mass(u):
        w = u[..., 0] * dA
        return (float((w * xc[..., 0]).sum() / w.sum()),
                float((w * xc[..., 1]).sum() / w.sum()))

    m0 = float((state.conserved[..., 0] * dA).sum())
    c0 = center_of_mass(state.conserved)
    for _ in range(40):
        state = amrsand.next_solution(state, nt, dxb)
    m1 = float((state.conserved[..., 0] * dA).sum())
    c1 = center_of_mass(state.conserved)

    # mass approximately conserved: amrsand has no coarse-fine flux
    # correction (in the reference either), so O(dx) flux mismatch at level
    # jumps leaks a few percent while the blob crosses them
    assert abs(m1 - m0) / m0 < 5e-2
    np.testing.assert_allclose(c1[0] - c0[0], 0.5 * state.time, rtol=0.1)
    np.testing.assert_allclose(c1[1] - c0[1], 0.5 * state.time, rtol=0.1)


def test_get_cell_block_three_cases():
    """API parity with mara::get_cell_block (mesh_tree_operators.hpp:
    223-252): same-level leaf, prolonged parent quadrant, coarsened
    children."""
    import jax.numpy as jnp

    leaves = sorted(
        {(1, 1, 0), (1, 0, 1), (1, 1, 1)} | set(tree.children((1, 0, 0))),
        key=tree.hilbert_key)
    bs = 4
    U = make_blocks(leaves, bs)

    # case 1: leaf present
    got = block_layout.get_cell_block(leaves, U, (1, 1, 0))
    np.testing.assert_array_equal(got, U[leaves.index((1, 1, 0))])

    # case 2: finer index under a coarse leaf -> prolonged quadrant
    got = block_layout.get_cell_block(leaves, U, (2, 2, 0))
    parent_block = U[leaves.index((1, 1, 0))]
    expected = pr.refine_cells_2d(parent_block)[0]
    np.testing.assert_array_equal(got, expected)

    # case 3: coarser index over fine leaves -> combined + coarsened
    got = block_layout.get_cell_block(leaves, U, (1, 0, 0))
    kids = [U[leaves.index(c)] for c in tree.children((1, 0, 0))]
    expected = pr.coarsen_cells_2d(pr.combine_cells_2d(kids))
    np.testing.assert_allclose(got, expected, rtol=1e-14)


def test_adaptive_regrid_tracks_blob_and_conserves():
    """Adaptive regridding (mesh/regrid.py, beyond the reference's static
    trees): refined region follows the advected blob; remap conserves total
    mass exactly (averaging restriction / copy prolongation)."""
    from mara3_tpu.mesh import regrid as rg
    from mara3_tpu.subprograms import amrsand

    cfg = (amrsand.config_template().create()
           .update({"depth": 3, "block_size": 8}))
    state = amrsand.new_solution(cfg)
    bs = 8

    def mass(leaves, blocks):
        dxb = block_layout.block_dx(leaves, bs)
        return float((np.asarray(blocks)[..., 0]
                      * (dxb ** 2)[:, None, None]).sum())

    m0 = mass(state.leaves, state.conserved)
    nt = block_layout.build_neighbor_table(state.leaves)
    dxb = jnp.asarray(block_layout.block_dx(state.leaves, bs))

    # advect for a while, then regrid
    for _ in range(30):
        state = amrsand.next_solution(state, nt, dxb)
    new_leaves, new_blocks, changed = rg.regrid(
        state.leaves, np.asarray(state.conserved),
        block_layout.block_dx(state.leaves, bs),
        refine_threshold=0.2, coarsen_threshold=0.02, max_level=3)
    m1 = mass(new_leaves, new_blocks)
    np.testing.assert_allclose(m1, m0, rtol=2e-2)  # scheme diffuses a bit
    assert changed

    # the finest blocks should cluster where the blob is (center of mass)
    xc = block_layout.block_cell_centers(new_leaves, bs)
    dxb2 = block_layout.block_dx(new_leaves, bs)
    w = np.asarray(new_blocks)[..., 0] * (dxb2 ** 2)[:, None, None]
    bx = (w * xc[..., 0]).sum() / w.sum()
    by = (w * xc[..., 1]).sum() / w.sum()
    max_level = max(l for l, _, _ in new_leaves)
    fine_centers = [tree.block_extent(leaf) for leaf in new_leaves
                    if leaf[0] == max_level]
    dists = [abs(x0 + wd / 2 - bx) + abs(y0 + wd / 2 - by)
             for x0, y0, wd in fine_centers]
    assert min(dists) < 0.5  # some finest block is near the blob


def test_regrid_remap_exact_mass():
    """The remap itself (no evolution) conserves mass to round-off."""
    from mara3_tpu.mesh import regrid as rg

    leaves = list(tree.create_quadtree(lambda lvl, r: True, 2))
    bs = 8
    U = np.asarray(make_blocks(leaves, bs)) + 2.0  # positive field
    dxb = block_layout.block_dx(leaves, bs)
    m0 = (U[..., 0] * (dxb ** 2)[:, None, None]).sum()

    indicator = np.zeros(len(leaves))
    indicator[0] = 1.0   # refine exactly one block
    new_leaves = rg.propose_leaves(leaves, indicator, 0.5, -1.0, 4)
    new_U = rg.remap_blocks(leaves, U, new_leaves)
    dxb2 = block_layout.block_dx(new_leaves, bs)
    m1 = (new_U[..., 0] * (dxb2 ** 2)[:, None, None]).sum()
    np.testing.assert_allclose(m1, m0, rtol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("depth", [3, 4, 5])
def test_extend_blocks_fast_matches_reference_path(depth, dtype):
    """The one-gather guard exchange (and the edge-strip form the sharded
    advance uses) must be BITWISE equal to the masked-select path on the
    flagship's focused trees, both axes, all three face cases: the copies
    are exact and the fine average sums in the same order, so no backend
    may round them differently."""
    from mara3_tpu.subprograms import binary as B

    cfg = B.create_config_template().create().update({"depth": depth})
    leaves = list(B.create_leaves(cfg))
    bs = 8
    nt = block_layout.build_neighbor_table(leaves)
    assert set(np.unique(nt.case)) == {0, 1, 2}
    gg = block_layout.build_guard_gather(nt, bs)
    rng = np.random.default_rng(depth)
    U = jnp.asarray(rng.uniform(0.5, 2.0, (len(leaves), bs, bs, 3)), dtype)
    for axis in (0, 1):
        ref = np.asarray(block_layout.extend_blocks(U, nt, axis=axis, g=1))
        fast = np.asarray(block_layout.extend_blocks_fast(U, gg, axis=axis))
        assert fast.dtype == dtype
        assert np.array_equal(fast, ref)

        rows = (0, 1, bs - 2, bs - 1)
        E = jnp.stack([U[:, r] if axis == 0 else U[:, :, r] for r in rows],
                      axis=1).transpose(0, 3, 1, 2)       # [B, C, 4, bs]
        lo, hi = block_layout.guard_strips_from_edges(E, nt, axis)
        guard = np.moveaxis(ref, 1 + axis, 1)             # guards at 0, -1
        assert np.array_equal(np.asarray(lo), guard[:, 0].transpose(0, 2, 1))
        assert np.array_equal(np.asarray(hi),
                              guard[:, -1].transpose(0, 2, 1))


def test_get_vertex_block_three_cases():
    """API parity with mara::get_vertex_block (mesh_tree_operators.hpp:
    254-292; reference test 'can manufacture vertex blocks',
    mesh_test.cpp:113): same-level leaf, prolonged parent quadrant,
    combined + coarsened children. Vertex blocks are (bs+1, bs+1);
    pointwise linear prolongation reproduces a LINEAR vertex field
    exactly, so all three cases check against the analytic field."""
    leaves = sorted(
        {(1, 1, 0), (1, 0, 1), (1, 1, 1)} | set(tree.children((1, 0, 0))),
        key=tree.hilbert_key)
    bs = 4

    def verts_of(leaf):
        level, i, j = leaf
        n = 1 << level
        xs = (i + np.arange(bs + 1) / bs) / n
        ys = (j + np.arange(bs + 1) / bs) / n
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        return 2.0 * X - 3.0 * Y + 0.25        # linear field

    V = np.stack([verts_of(l) for l in leaves])[..., None]

    # case 1: leaf present
    got = block_layout.get_vertex_block(leaves, V, (1, 1, 0))
    np.testing.assert_array_equal(got, V[leaves.index((1, 1, 0))])

    # case 2: finer index under a coarse leaf -> prolonged quadrant
    got = block_layout.get_vertex_block(leaves, V, (2, 2, 0))
    np.testing.assert_allclose(np.asarray(got)[..., 0],
                               verts_of((2, 2, 0)), rtol=1e-13)

    # case 3: coarser index over fine leaves -> combined + coarsened
    got = block_layout.get_vertex_block(leaves, V, (1, 0, 0))
    np.testing.assert_allclose(np.asarray(got)[..., 0],
                               verts_of((1, 0, 0)), rtol=1e-13)


def test_tree_index_methods_match_reference_semantics():
    """Reference core_test.cpp:187 'binary tree indexes methods':
    prev_on/next_on with wrap-around at the level's extent, validity,
    parent/children coordinate arithmetic (our 2d quadtree terms)."""
    # prev_on/next_on incl. wrap (tree.neighbor is the 2d analog)
    assert tree.neighbor((3, 3, 4), 0, 0) == (3, 2, 4)
    assert tree.neighbor((3, 3, 4), 0, 1) == (3, 4, 4)
    assert tree.neighbor((3, 0, 4), 0, 0) == (3, 7, 4)     # wrap low
    assert tree.neighbor((3, 7, 4), 0, 1) == (3, 0, 4)     # wrap high
    assert tree.neighbor((3, 3, 0), 1, 0) == (3, 3, 7)
    assert tree.neighbor((3, 4, 7), 1, 1) == (3, 4, 0)
    # parent/children arithmetic (child k covers x-half k&1, y-half k>>1)
    assert tree.parent((3, 3, 4)) == (2, 1, 2)
    kids = tree.children((1, 0, 0))
    assert kids == [(2, 0, 0), (2, 1, 0), (2, 0, 1), (2, 1, 1)]
    for k in kids:
        assert tree.parent(k) == (1, 0, 0)
        assert tree.is_inside(k, (1, 0, 0))
    assert not tree.is_inside((2, 2, 0), (1, 0, 0))


def test_amrsand_fast_driver_matches_host_driver(tmp_path):
    """fast_step=1 (one advance_n dispatch per planned chunk) must match
    the per-step amrsand driver: same diagnostics numbering and the same
    final state in the last diagnostics file."""
    import os

    import h5py

    from mara3_tpu.subprograms import amrsand

    def run(sub, flag):
        d = tmp_path / sub
        d.mkdir()
        old = os.getcwd()
        os.chdir(d)
        try:
            assert amrsand.main(["amrsand", "depth=3", "block_size=16",
                                 "tfinal=0.25", "dfi=0.1", flag]) == 0
        finally:
            os.chdir(old)

    run("host", "fast_step=0")
    run("fast", "fast_step=1")

    def last(d):
        names = sorted(f for f in os.listdir(d / "data")
                       if f.startswith("diagnostics"))
        with h5py.File(d / "data" / names[-1]) as f:
            keys = sorted(f["conserved"].keys())
            u = np.stack([f["conserved"][k][()] for k in keys])
            return names, keys, u, f["time"][()]

    nh, kh, uh, th = last(tmp_path / "host")
    nf, kf, uf, tf = last(tmp_path / "fast")
    assert nh == nf and kh == kf
    np.testing.assert_allclose(tf, th, rtol=1e-12)
    np.testing.assert_allclose(uf, uh, rtol=1e-12, atol=1e-15)
