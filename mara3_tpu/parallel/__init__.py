"""Distribution layer (maps reference layer 2: core_mpi.hpp, app_parallel.hpp,
core_thread_pool.hpp).

The reference's parallelism is domain decomposition over MPI ranks plus a
shared-memory thread pool. JAX mapping (SURVEY.md §2.2):

- thread pool / evaluate_on<N>  -> XLA intra-chip parallelism (nothing to do)
- MPI Session                   -> jax.distributed.initialize (comm.Session)
- Communicator collectives      -> psum / all_gather / ppermute inside
                                   shard_map over a jax.sharding.Mesh
- isend/irecv halo exchange     -> lax.ppermute guard-strip exchange (halo.py)
- block decomposition           -> decomposition.py (same prime-factor
                                   algorithm) feeding Mesh axis sizes
- hyperslab parallel HDF5 write -> io.py per-shard hyperslab writes
"""
