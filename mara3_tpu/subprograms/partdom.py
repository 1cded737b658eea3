"""Domain-decomposition and parallel-write demo.

Re-design of src/subprog_partdom.cpp:56-151: factor `procs` into a
near-cubic block grid, print every block's global index range, build
per-block vertex and cell-center arrays, and write one block-sharded global
dataset to test.h5 through hyperslab selections.

Design: the decomposition feeds a jax.sharding.Mesh; the "blocks" are
device shards of one global array; the hyperslab write is the per-shard
HDF5 path in parallel/io.py. With procs=0 (default) the actual device count
is used, demonstrating the real mesh this host would run with.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mara3_tpu.app.config import ConfigTemplate, argv_to_string_map
from mara3_tpu.app.subprogram import register
from mara3_tpu.parallel import io as pio
from mara3_tpu.parallel.decomposition import (create_access_pattern_array,
                                              propose_block_decomposition)
from mara3_tpu.parallel.mesh import grid_sharding, make_mesh


def config_template():
    return (ConfigTemplate()
            .item("N", 24)        # cells per axis of the global domain
            .item("procs", 0)     # subdomains (0 -> use all local devices)
            .item("rank", 3))     # dimensionality of the demo domain


@register("partdom")
def main(argv) -> int:
    import h5py
    cfg = config_template().create().update(argv_to_string_map(argv))
    n = cfg.get_int("N")
    rank = cfg.get_int("rank")
    procs = cfg.get_int("procs") or jax.device_count()

    blocks_shape = propose_block_decomposition(rank, procs)
    domain_shape = (n,) * rank
    patterns = create_access_pattern_array(domain_shape, blocks_shape)

    print(f"decomposing a {domain_shape} domain into {blocks_shape} blocks")
    for index, pattern in patterns.items():
        print(f"{index} ... [{pattern.start} -> {pattern.final}) "
              f"shape {pattern.shape}")

    # global cell-center coordinate field, sharded over the device mesh when
    # the block count matches the device count (the real run configuration)
    coords = jnp.stack(
        jnp.meshgrid(*[jnp.arange(n) + 0.5 for _ in range(rank)],
                     indexing="ij"), axis=-1)
    field = coords[..., 0]

    if procs == jax.device_count() and rank >= 2:
        mesh = make_mesh([f"ax{i}" for i in range(rank)],
                         shape=blocks_shape)
        field = jax.device_put(field, grid_sharding(
            mesh, *[f"ax{i}" for i in range(rank)]))
        print(f"device mesh: {dict(mesh.shape)}")

    with h5py.File("test.h5", "w") as f:
        pio.write_sharded(f, "data", field)
    print(f"wrote test.h5: data{domain_shape} via "
          f"{len(patterns)} hyperslab writes")
    return 0
