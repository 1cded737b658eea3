"""The uniform-grid step under shard_map, x-sharded over a device mesh.

The big x axis is sharded over a 1-D ("x",) mesh axis; each device runs the
jnp PLM step (schemes/iso2d_grid.step_local_extended) on its rows after a
width-2 ppermute halo exchange with its x neighbors (parallel/halo.py) —
the collective analog of the reference's isend/irecv guard exchange
driving its distributed uniform-grid scheme
(subprog_binary_scheme.cpp:132-142; MPI plane core_mpi.hpp:533-637). The
y axis stays whole on each device and wraps locally. SSP-RK2 exchanges
halos before each of its two stages.

Each shard's update reads only its extended window, which holds the same
cells the single-device periodic step reads, so the distributed result
matches the single-device kh advance (tests/test_iso2d_sharded.py on
virtual CPU devices).
"""

from __future__ import annotations

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from mara3_tpu.parallel.halo import halo_exchange
from mara3_tpu.schemes import iso2d_grid


def make_advance_sharded(mesh: Mesh, *, axis_name: str = "x", cs2: float,
                         dx: float, dy: float, dt: float,
                         theta: float = 1.8, rk_order: int = 1,
                         riemann: str = "hlle"):
    """Distributed n-step advance over a global periodic [nx, ny, 3]
    state x-sharded over ``mesh[axis_name]``. Returns ``advance(u, n)``
    (jitted) where u carries NamedSharding P(axis_name, None, None)."""
    num_shards = mesh.shape[axis_name]

    def euler(u):
        u_ext = halo_exchange(u, axis=0, axis_name=axis_name,
                              num_shards=num_shards, width=iso2d_grid.GUARD)
        u_ext = halo_exchange(u_ext, axis=1, axis_name=axis_name,
                              num_shards=1, width=iso2d_grid.GUARD)
        return iso2d_grid.step_local_extended(u_ext, cs2, dx, dy, dt, theta,
                                              riemann)

    def local_step(u):
        if rk_order == 1:
            return euler(u)
        return 0.5 * (u + euler(euler(u)))

    spec = P(axis_name, None, None)
    step = jax.shard_map(local_step, mesh=mesh, in_specs=spec,
                         out_specs=spec)

    @jax.jit
    def advance(u, n):
        return lax.fori_loop(0, n, lambda _, v: step(v), u)

    return advance


def shard_state(u, mesh: Mesh, axis_name: str = "x"):
    """Place a global [nx, ny, 3] state with x sharded over the mesh."""
    return jax.device_put(u, NamedSharding(mesh, P(axis_name, None, None)))
