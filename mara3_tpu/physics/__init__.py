"""Hyperbolic systems (maps reference layer 6, src/physics_*.hpp).

Each system is a module of pure, jit-traceable functions over arrays whose
*trailing axis* is the component axis (the JAX analog of the
reference's arithmetic_sequence_t state vectors). All functions broadcast
over arbitrary leading shapes, so the same code path serves a single cell in
a unit test and a [num_blocks, bs, bs] AMR grid in the flagship run.

Interface normals (`nhat`) are static length-3 tuples — axis unit vectors in
practice — so XLA constant-folds the projection arithmetic away.
"""

UNIT_VECTOR_X = (1.0, 0.0, 0.0)
UNIT_VECTOR_Y = (0.0, 1.0, 0.0)
UNIT_VECTOR_Z = (0.0, 0.0, 1.0)


def on_axis(axis: int):
    """Axis unit vector (reference unit_vector_t::on_axis_{1,2,3},
    core_geometric.hpp)."""
    return (UNIT_VECTOR_X, UNIT_VECTOR_Y, UNIT_VECTOR_Z)[axis]
