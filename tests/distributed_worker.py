"""Worker for the 2-process distributed session test (run via subprocess).

Exercises the multi-process surface end to end on CPU, the analog of the
reference's only MPI-touching program (subprog_boilerplate.cpp:268-276:
mpi::Session + printf_master + comm size) plus the partdom-style per-host
sharded checkpoint write (subprog_partdom.cpp:128-135):

  jax.distributed.initialize (via parallel.comm.Session) -> printf_master
  -> cross-host barrier -> a global psum over the 2-device process mesh ->
  each process writes its own shard file -> a boilerplate advection step on
  a globally-sharded array.
"""

import os
import sys

# run as a bare script by subprocess.Popen: sys.path[0] is tests/, so the
# package root must be added explicitly (the parent test strips the env)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from mara3_tpu.parallel import comm

    with comm.Session(coordinator_address=f"127.0.0.1:{port}",
                      num_processes=2, process_id=rank):
        import h5py
        import jax
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P

        assert comm.size() == 2, comm.size()
        assert comm.rank() == rank
        comm.printf_master("session: %d processes", comm.size())
        comm.barrier()

        # a globally-sharded array across both processes' devices
        mesh = jax.make_mesh((2,), ("x",))
        sharding = NamedSharding(mesh, P("x"))
        nx = 64
        xs = jnp.arange(nx, dtype=jnp.float64)
        u = jax.device_put(xs, sharding)

        # cross-process collective: a global psum inside shard_map
        total = jax.jit(jax.shard_map(
            lambda a: jax.lax.psum(jnp.sum(a), "x"),
            mesh=mesh, in_specs=P("x"), out_specs=P()))(u)
        expect = float(nx * (nx - 1) / 2)
        assert float(total) == expect, (float(total), expect)

        # one periodic upwind advection step on the sharded array
        # (boilerplate's next_solution over a ppermute halo)
        def local_step(a):
            left = jax.lax.ppermute(a[-1:], "x", [(i, (i + 1) % 2)
                                                  for i in range(2)])
            ae = jnp.concatenate([left, a])
            return a - (ae[1:] - ae[:-1]) * 0.25

        u1 = jax.jit(jax.shard_map(local_step, mesh=mesh,
                                   in_specs=P("x"), out_specs=P("x")))(u)

        # per-host sharded checkpoint: each process writes only its own
        # addressable shard into its own file
        from mara3_tpu.parallel import io as pio
        path = os.path.join(outdir, f"shard.{rank}.h5")
        with h5py.File(path, "w") as f:
            f.attrs["global_shape"] = u1.shape
            for shard in u1.addressable_shards:
                sl = shard.index[0]
                g = f.create_group(f"shard_{sl.start}_{sl.stop}")
                g["start"] = sl.start
                g["data"] = np.asarray(shard.data)

        comm.barrier()
        comm.printf_master("distributed worker OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
