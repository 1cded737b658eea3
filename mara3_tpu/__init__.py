"""mara3_tpu — a JAX Godunov (finite-volume) gas-dynamics framework.

A JAX/XLA re-design with the capabilities of jzrake/Mara3. The reference
is a C++17 header library built around lazy functional n-dim arrays,
compile-time dimensional analysis, an immutable quadtree AMR container,
MPI domain decomposition, and HDF5 I/O (see SURVEY.md). Here the same
capability surface is mapped onto an accelerator through XLA:

- lazy provider-graph arrays        -> jax.jit traced computation graphs
- value semantics / immutability    -> native JAX functional style
- arithmetic_sequence state vectors -> trailing component axis on arrays
- compile-time dimensional analysis -> pytree Quantity wrapper (core.dimensional)
- thread pool / evaluate_on<N>      -> XLA intra-device parallelism (free)
- MPI communicator / halo exchange  -> jax.sharding Mesh + shard_map + ppermute
- quadtree of blocks                -> dense [num_blocks, ...] padded block
                                       arrays + static neighbor tables
- HDF5 wrapper                      -> h5py with reference-compatible layouts

Subprograms (sedov, cloud, binary, amrsand, boilerplate, partdom) run from a
single CLI: ``python -m mara3_tpu <name> key=val ...``.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# without it the cache sits at a fixed path in the checkout, so a cache
# entry made by one run is found by the next.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from mara3_tpu.core import ops  # noqa: E402,F401
