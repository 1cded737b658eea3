"""Stencil and boundary-condition building blocks for finite-volume schemes.

JAX re-design of the reference's lazy one-liner array operators
(reference: src/core_ndarray_ops.hpp:39-190 and the nd:: transformer suite in
src/core_ndarray.hpp). The reference builds lazy provider graphs composed with
``operator|``; under ``jax.jit`` every function here is traced into a single
XLA computation and fused, which supplies the same deferred-evaluation
semantics with compiler-grade fusion for free.

All functions are pure, operate on ``jax.Array`` (or numpy) inputs, treat the
*component* axis as trailing, and take an explicit ``axis`` argument for the
spatial direction, mirroring the reference's ``*_on_axis`` operators.
"""

from __future__ import annotations

import jax.numpy as jnp


def _axslice(ndim: int, axis: int, sl: slice):
    """Build an index tuple applying slice `sl` on `axis`."""
    index = [slice(None)] * ndim
    index[axis] = sl
    return tuple(index)


# -----------------------------------------------------------------------------
# selection helpers (reference: core_ndarray_ops.hpp:73-119)
# -----------------------------------------------------------------------------

def select_first(a, count: int, axis: int = 0):
    """First `count` entries along `axis` (reference select_first, :73-85)."""
    return a[_axslice(a.ndim, axis, slice(0, count))]


def select_final(a, count: int, axis: int = 0):
    """Last `count` entries along `axis` (reference select_final, :87-99)."""
    n = a.shape[axis]
    return a[_axslice(a.ndim, axis, slice(n - count, n))]


def take_first_on_axis(a, axis: int = 0):
    """Drop the last entry along `axis` (reference take_first, :101-109)."""
    return a[_axslice(a.ndim, axis, slice(0, a.shape[axis] - 1))]


def take_final_on_axis(a, axis: int = 0):
    """Drop the first entry along `axis` (reference take_final, :101-109)."""
    return a[_axslice(a.ndim, axis, slice(1, a.shape[axis]))]


def drop_first_on_axis(a, count: int, axis: int = 0):
    """Remove the first `count` entries along `axis`."""
    return a[_axslice(a.ndim, axis, slice(count, a.shape[axis]))]


def drop_final_on_axis(a, count: int, axis: int = 0):
    """Remove the last `count` entries along `axis`."""
    return a[_axslice(a.ndim, axis, slice(0, a.shape[axis] - count))]


# -----------------------------------------------------------------------------
# stencil combinators (reference: core_ndarray_ops.hpp:121-160)
# -----------------------------------------------------------------------------

def midpoint_on_axis(a, axis: int = 0):
    """Averages of adjacent pairs: 0.5*(a[i] + a[i+1]) (reference :121-129)."""
    return 0.5 * (take_first_on_axis(a, axis) + take_final_on_axis(a, axis))


def difference_on_axis(a, axis: int = 0):
    """Differences of adjacent pairs: a[i+1] - a[i] (reference :131-139)."""
    return take_final_on_axis(a, axis) - take_first_on_axis(a, axis)


def zip_adjacent2_on_axis(a, axis: int = 0):
    """Pairs (a[i], a[i+1]) along `axis` (reference :141-150)."""
    n = a.shape[axis]
    return (a[_axslice(a.ndim, axis, slice(0, n - 1))],
            a[_axslice(a.ndim, axis, slice(1, n))])


def zip_adjacent3_on_axis(a, axis: int = 0):
    """Triples (a[i], a[i+1], a[i+2]) along `axis` (reference :152-160)."""
    n = a.shape[axis]
    return (a[_axslice(a.ndim, axis, slice(0, n - 2))],
            a[_axslice(a.ndim, axis, slice(1, n - 1))],
            a[_axslice(a.ndim, axis, slice(2, n))])


# -----------------------------------------------------------------------------
# boundary extensions (reference: core_ndarray_ops.hpp:162-190)
# -----------------------------------------------------------------------------

def extend_periodic_on_axis(a, count: int = 1, axis: int = 0):
    """Wrap-around guard zones on both ends (reference :162-170)."""
    lo = select_final(a, count, axis)
    hi = select_first(a, count, axis)
    return jnp.concatenate([lo, a, hi], axis=axis)


def extend_zero_gradient(a, count: int = 1, axis: int = 0):
    """Replicate edge values into guard zones (reference :172-180)."""
    lo = select_first(a, 1, axis)
    hi = select_final(a, 1, axis)
    reps = [1] * a.ndim
    reps[axis] = count
    return jnp.concatenate([jnp.tile(lo, reps), a, jnp.tile(hi, reps)],
                           axis=axis)


def extend_zeros(a, count: int = 1, axis: int = 0):
    """Zero-fill guard zones on both ends (reference :182-190)."""
    shape = list(a.shape)
    shape[axis] = count
    z = jnp.zeros(shape, a.dtype)
    return jnp.concatenate([z, a, z], axis=axis)


def extend_reflecting(a, count: int = 1, axis: int = 0,
                      negate_components=(), lower: bool = True,
                      upper: bool = True):
    """Mirror guard zones, optionally flipping sign of velocity components.

    The reference builds this per-subprogram (e.g. the reflecting inner BC in
    subprog_sedov.cpp:231-239); provided here as a reusable op. The component
    axis is assumed trailing; `negate_components` lists trailing-axis indices
    whose mirrored values are negated (normal velocities).
    """
    parts = []
    if lower:
        mirror = jnp.flip(select_first(a, count, axis), axis=axis)
        if negate_components:
            sign = jnp.ones(a.shape[-1], a.dtype)
            sign = sign.at[jnp.array(negate_components)].set(-1.0)
            mirror = mirror * sign
        parts.append(mirror)
    parts.append(a)
    if upper:
        mirror = jnp.flip(select_final(a, count, axis), axis=axis)
        if negate_components:
            sign = jnp.ones(a.shape[-1], a.dtype)
            sign = sign.at[jnp.array(negate_components)].set(-1.0)
            mirror = mirror * sign
        parts.append(mirror)
    return jnp.concatenate(parts, axis=axis)


def shift_by(a, count: int, axis: int = 0):
    """Shift and truncate along `axis` (reference nd::shift_by,
    core_ndarray.hpp:2065-2079): positive count drops from the start.
    """
    if count >= 0:
        return drop_first_on_axis(a, count, axis)
    return drop_final_on_axis(a, -count, axis)


# -----------------------------------------------------------------------------
# factories (reference: core_ndarray.hpp arange/linspace/index_array)
# -----------------------------------------------------------------------------

def linspace_verts(x0: float, x1: float, num_cells: int, dtype=None):
    """Vertex coordinates of a uniform grid with `num_cells` cells."""
    return jnp.linspace(x0, x1, num_cells + 1, dtype=dtype)


def logspace_verts(x0: float, x1: float, num_cells: int, dtype=None):
    """Log-spaced vertex coordinates (reference subprog_sedov.cpp:367-371
    builds log-radial grids spanning decades)."""
    return jnp.logspace(jnp.log10(x0), jnp.log10(x1), num_cells + 1,
                        dtype=dtype)
