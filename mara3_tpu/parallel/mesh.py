"""Device-mesh construction and sharding helpers.

The JAX replacement for the reference's rank grid: a
jax.sharding.Mesh whose axis sizes come from the same near-cubic prime-factor
decomposition the reference uses for MPI ranks (app_parallel.hpp:119-131),
so the domain-decomposition geometry is identical — but collectives run
between devices instead of over MPI.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from mara3_tpu.parallel.decomposition import propose_block_decomposition


def make_mesh(axis_names: Sequence[str],
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> Mesh:
    """Mesh over the given (or all) devices. Without an explicit shape, the
    devices are factored into a near-cubic grid of rank len(axis_names)."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = propose_block_decomposition(len(axis_names), len(devices))
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} does not cover "
                         f"{len(devices)} devices")
    return Mesh(np.array(devices).reshape(shape), tuple(axis_names))


def grid_sharding(mesh: Mesh, *axis_names) -> NamedSharding:
    """NamedSharding placing array dim i on mesh axis axis_names[i]
    (None entries replicate)."""
    return NamedSharding(mesh, PartitionSpec(*axis_names))


def shard_grid_array(array, mesh: Mesh, *axis_names):
    return jax.device_put(array, grid_sharding(mesh, *axis_names))
