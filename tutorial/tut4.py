#!/usr/bin/env python3
"""Tutorial 4: how a run spreads across devices (beyond the reference —
there is no tut4.cpp upstream; the analog surface is core_mpi.hpp +
app_parallel.hpp, SURVEY.md §2.2).

The reference distributes by MPI rank grid + isend/irecv guard
exchange. The JAX translation, used by every distributed path in this
framework:

  MPI rank grid          -> jax.sharding.Mesh over the device array
  block decomposition    -> NamedSharding / PartitionSpec on the big axis
  isend/irecv halos      -> lax.ppermute of edge strips inside shard_map
  allreduce (CFL, sums)  -> lax.pmax / lax.psum inside shard_map
  rank-local update      -> the same jnp step, unchanged, per shard

The single-device step (schemes/iso2d_grid.py) reads its neighbours from
a guard-extended array; under shard_map the guards along the sharded axis
come from the neighbour devices by one ppermute per side, and the result
matches the single-device run.

Runs anywhere: this script forces 8 virtual CPU devices.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax                                                    # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402
from jax.sharding import Mesh                                 # noqa: E402

from mara3_tpu.parallel import iso2d_sharded                  # noqa: E402
from mara3_tpu.subprograms import kh                          # noqa: E402

# --- a mesh is the rank grid ---------------------------------------------------
devices = np.array(jax.devices()[:8])
mesh = Mesh(devices, ("x",))
print(f"mesh: {mesh.shape} over {devices[0].platform} devices")

# --- a periodic 2D isothermal state, x-sharded --------------------------------
N = 128
x = (jnp.arange(N, dtype=jnp.float32) + 0.5)[:, None] / N
y = (jnp.arange(N, dtype=jnp.float32) + 0.5)[None, :] / N
sg = 1.0 + 0.5 * jnp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01)
u = jnp.stack([sg, 0.2 * sg, -0.1 * sg], axis=-1)  # [N, N, 3]
us = iso2d_sharded.shard_state(u, mesh)            # P("x", None, None)
print(f"state {us.shape} sharded: each device holds [{N // 8}, {N}, 3]")

# --- the distributed advance ---------------------------------------------------
# per step, each device (1) ppermutes 2 edge rows to/from its x
# neighbours, (2) runs the unchanged jnp step on its extended rows
kw = dict(cs2=0.3, dx=1.0 / N, dy=1.0 / N, dt=0.1 / N, theta=1.8)
adv = iso2d_sharded.make_advance_sharded(mesh, **kw)
out = adv(us, 8)

# --- parity with the single-device advance -------------------------------------
ref = kh.advance_n(u, 8, **kw)
err = float(jnp.max(jnp.abs(out - ref)))
print(f"8 devices vs 1 device: max|diff| = {err:.3e}")
assert err <= 1e-5, err

# The same recipe distributes the flagship AMR advance (arbitrary
# neighbor tables want all_gather'd edges instead of pairwise ppermute —
# parallel/block_sharded.py) and backs the kh subprogram's shards=N
# mode. __graft_entry__.dryrun_multichip() runs all of it end-to-end.
print("ok")
