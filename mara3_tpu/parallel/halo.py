"""Guard-zone (halo) exchange over a sharded grid axis.

The JAX replacement for the reference's isend/irecv neighbor exchange
(the `extend` guard-zone pattern, subprog_binary_scheme.cpp:132-142, and the
MPI point-to-point API it would ride on, core_mpi.hpp:533-637): inside
``shard_map`` each shard sends its edge strips to its neighbors with
``lax.ppermute`` — a device-to-device transfer XLA can overlap with compute — and
fills physical-boundary guards by mask.

All functions here are meant to be called *inside* ``shard_map`` with the
relevant mesh axis name.
"""

from __future__ import annotations



import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from mara3_tpu.core import ops


def halo_exchange(u, *, axis: int, axis_name: str, num_shards: int,
                  width: int = 1, periodic: bool = True,
                  boundary: str = "zero_gradient"):
    """Return the local shard extended by `width` guard cells on both ends
    of `axis`, filled from neighbor shards (ppermute) or, at non-periodic
    physical boundaries, by the named BC:

    - 'zero_gradient': copy own edge cells (reference extend_zero_gradient)
    - 'zeros': zero-fill (reference extend_zeros)
    """
    if num_shards == 1:
        if periodic:
            return ops.extend_periodic_on_axis(u, width, axis)
        if boundary == "zero_gradient":
            return ops.extend_zero_gradient(u, width, axis)
        return ops.extend_zeros(u, width, axis)

    my_right = ops.select_final(u, width, axis)   # goes to right neighbor
    my_left = ops.select_first(u, width, axis)    # goes to left neighbor

    send_right = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    send_left = [(i, (i - 1) % num_shards) for i in range(num_shards)]

    from_left = lax.ppermute(my_right, axis_name, send_right)
    from_right = lax.ppermute(my_left, axis_name, send_left)

    if not periodic:
        idx = lax.axis_index(axis_name)
        if boundary == "zero_gradient":
            lo_bc = ops.select_first(u, 1, axis)
            hi_bc = ops.select_final(u, 1, axis)
            if width > 1:
                reps = [1] * u.ndim
                reps[axis] = width
                lo_bc = jnp.tile(lo_bc, reps)
                hi_bc = jnp.tile(hi_bc, reps)
        elif boundary == "zeros":
            lo_bc = jnp.zeros_like(my_left)
            hi_bc = jnp.zeros_like(my_right)
        else:
            raise ValueError(f"unknown boundary '{boundary}'")
        from_left = jnp.where(idx == 0, lo_bc, from_left)
        from_right = jnp.where(idx == num_shards - 1, hi_bc, from_right)

    return jnp.concatenate([from_left, u, from_right], axis=axis)


def sharded_map(fn, mesh, in_specs, out_specs):
    """Thin shard_map wrapper (import point kept in one place)."""
    from jax import shard_map
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def make_sharded_step_2d(step_local, mesh, axis_names=("x", "y"),
                         width: int = 1, periodic=(True, True),
                         boundaries=("zero_gradient", "zero_gradient"),
                         extra_specs=()):
    """Wrap a local stencil update into a distributed one.

    `step_local(u_ext, *extras)` must accept the shard extended by `width`
    guard cells on both grid axes (axes 0 and 1; components trailing) and
    return the updated interior shard. Returns a function over the global
    (sharded) array that performs halo exchange + local update under
    shard_map — the whole thing jit-compiles to compute with device-to-device
    transfers.
    """
    ax_x, ax_y = axis_names
    nx = mesh.shape[ax_x]
    ny = mesh.shape[ax_y]

    def local(u, *extras):
        u = halo_exchange(u, axis=0, axis_name=ax_x, num_shards=nx,
                          width=width, periodic=periodic[0],
                          boundary=boundaries[0])
        u = halo_exchange(u, axis=1, axis_name=ax_y, num_shards=ny,
                          width=width, periodic=periodic[1],
                          boundary=boundaries[1])
        return step_local(u, *extras)

    from jax import shard_map
    spec = P(ax_x, ax_y)
    return shard_map(local, mesh=mesh,
                     in_specs=(spec,) + tuple(extra_specs),
                     out_specs=spec)
