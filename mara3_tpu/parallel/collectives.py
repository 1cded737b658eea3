"""In-graph collectives: the data-plane of the reference's MPI communicator.

Re-design of mpi::Communicator (src/core_mpi.hpp:353-833). Here these are
not host calls but operations compiled into programs and executed
between devices, so the API is a set of functions usable *inside* ``shard_map``
(each takes the mesh axis name). The correspondence:

  MPI (reference)             here
  -------------------------   -------------------------------------------
  send/isend + recv/irecv     send_recv (lax.ppermute with a perm list —
                              nonblocking by construction: XLA overlaps)
  bcast(value, root)          broadcast_from
  scatter(values, root)       scatter_from
  all_gather                  all_gather
  all_to_all                  all_to_all
  barrier                     psum of a unit scalar (or comm.barrier on
                              the host side)
  probe/iprobe                not in-graph (messages cannot arrive
                              unexpectedly in a compiled SPMD program);
                              the dynamic host-messaging surface lives in
                              parallel/messages.py (tagged Mailbox with
                              Status/probe/iprobe + dynamic-size recv)

Reductions (the tree ``.sum()`` / global CFL of the reference) are
jax.lax.psum/pmax/pmin directly.
"""

from __future__ import annotations

from jax import lax


def send_recv(x, axis_name: str, perm):
    """Point-to-point transfers: perm is [(src, dst), ...]. Shards not
    named as a dst receive zeros (the reference's untagged recv has no
    analog; static schedules replace probing)."""
    return lax.ppermute(x, axis_name, perm)


def shift(x, axis_name: str, num_shards: int, offset: int = 1,
          periodic: bool = True):
    """The halo-exchange primitive: every shard sends to rank+offset."""
    if periodic:
        perm = [(i, (i + offset) % num_shards) for i in range(num_shards)]
    else:
        perm = [(i, i + offset) for i in range(num_shards)
                if 0 <= i + offset < num_shards]
    return lax.ppermute(x, axis_name, perm)


def broadcast_from(x, axis_name: str, num_shards: int, root: int = 0):
    """bcast (core_mpi.hpp:658-659): every shard ends with root's value.
    ppermute requires unique sources, so the hardware-shaped form is an
    all_gather followed by selecting the root's contribution."""
    gathered = lax.all_gather(x, axis_name)       # [num_shards, ...]
    return gathered[root]


def scatter_from(chunks, axis_name: str, num_shards: int, root: int = 0):
    """scatter (core_mpi.hpp:696-697): root holds [num_shards, ...]; each
    shard receives its row."""
    all_chunks = broadcast_from(chunks, axis_name, num_shards, root)
    idx = lax.axis_index(axis_name)
    return lax.dynamic_index_in_dim(all_chunks, idx, axis=0,
                                    keepdims=False)


def all_gather(x, axis_name: str):
    """all_gather (core_mpi.hpp:772-791)."""
    return lax.all_gather(x, axis_name)


def all_to_all(x, axis_name: str, split_axis: int = 0,
               concat_axis: int = 0):
    """all_to_all (core_mpi.hpp:747-748): shard i sends chunk j of its
    split axis to shard j."""
    return lax.all_to_all(x, axis_name, split_axis, concat_axis)


def barrier(axis_name: str):
    """A compiled barrier: a unit psum every shard must reach."""
    import jax.numpy as jnp
    return lax.psum(jnp.ones(()), axis_name)
