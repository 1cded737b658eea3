"""Process/session bootstrap and host-level helpers.

Re-design of the reference's mpi:: session surface (src/core_mpi.hpp:47-98):
`Session` maps to jax.distributed initialization; rank/size map to
jax.process_index/process_count; printf_master/cout_master gate output to
process 0. The *data-plane* communicator API (send/recv/bcast/all_gather/
all_to_all, core_mpi.hpp:353-833) has no analog as host calls here —
collectives are compiled into programs; see parallel/collectives.py for the
in-graph equivalents and parallel/halo.py for the isend/irecv halo pattern.
"""

from __future__ import annotations

import jax


class Session:
    """RAII MPI_Init/Finalize analog (reference core_mpi.hpp:87-98).

    Must run before any backend use: jax.distributed.initialize has to
    happen before the first jax.devices()/process_count() call, so this
    decides from its arguments and the environment alone (coordinator
    settings may come from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, the jax.distributed auto-detection envs). On a plain
    single-process run it is a no-op, like MPI_Init under one rank."""

    def __init__(self, **kwargs):
        import os

        self._initialized_here = False
        want = bool(kwargs) or (
            "JAX_COORDINATOR_ADDRESS" in os.environ
            and "JAX_NUM_PROCESSES" in os.environ)
        if want:
            jax.distributed.initialize(**kwargs)
            self._initialized_here = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._initialized_here:
            jax.distributed.shutdown()
        return False


def rank() -> int:
    """(reference Communicator::rank, core_mpi.hpp:477)."""
    return jax.process_index()


def size() -> int:
    """(reference Communicator::size, core_mpi.hpp:459)."""
    return jax.process_count()


def is_master() -> bool:
    """(reference core_mpi.hpp:51)."""
    return jax.process_index() == 0


def printf_master(fmt: str, *args):
    """(reference core_mpi.hpp:58-65)."""
    if is_master():
        print(fmt % args if args else fmt)


def barrier():
    """Host-level barrier (reference Communicator::barrier,
    core_mpi.hpp:493). Multi-process: a true cross-host sync over all
    global devices; single-process: a tiny blocked psum across the local
    devices."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("mara3_tpu.comm.barrier")
        return
    import jax.numpy as jnp
    jax.block_until_ready(
        jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")(
            jnp.ones(jax.local_device_count())))
