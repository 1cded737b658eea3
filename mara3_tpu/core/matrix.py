"""Fixed-size matrices for eigensystems.

Re-design of src/core_matrix.hpp:72-345. jnp arrays *are* matrices, so this
module is a thin, named layer: the factories the reference declares, plus
the batched constructor the euler eigensystem uses to assemble [.., 5, 5]
matrices from broadcastable entries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def zero_matrix(rows: int, cols: int, dtype=float):
    """(core_matrix.hpp:187)."""
    return jnp.zeros((rows, cols), dtype)


def identity_matrix(n: int, dtype=float):
    """(core_matrix.hpp:210)."""
    return jnp.eye(n, dtype=dtype)


def diagonal_matrix(*entries):
    """(core_matrix.hpp:235). Accepts scalars or broadcastable arrays;
    returns [.., n, n] with the entries on the diagonal."""
    b = jnp.broadcast_arrays(*[jnp.asarray(e) for e in entries])
    stacked = jnp.stack(b, axis=-1)                 # [.., n]
    n = len(entries)
    eye = jnp.eye(n, dtype=stacked.dtype)
    return stacked[..., :, None] * eye


def row_vector(*entries):
    """(core_matrix.hpp:263): [.., 1, n]."""
    return jnp.stack(jnp.broadcast_arrays(*[jnp.asarray(e) for e in entries]),
                     axis=-1)[..., None, :]


def column_vector(*entries):
    """(core_matrix.hpp:281): [.., n, 1]."""
    return jnp.stack(jnp.broadcast_arrays(*[jnp.asarray(e) for e in entries]),
                     axis=-1)[..., :, None]


def matrix_product(a, b):
    """(core_matrix.hpp:326): batched matmul over leading axes, at full
    precision (a default-precision f32 contraction may run in TF32)."""
    return jnp.einsum("...ij,...jk->...ik", a, b,
                      precision=jax.lax.Precision.HIGHEST)


def from_rows(rows):
    """Assemble [.., m, n] from an m-list of n-lists of broadcastable
    entries — the batched form of the reference's braced initializers."""
    m = len(rows)
    n = len(rows[0])
    b = jnp.broadcast_arrays(*[jnp.asarray(e) for row in rows for e in row])
    shape = b[0].shape
    return jnp.stack(b, axis=-1).reshape(shape + (m, n))
