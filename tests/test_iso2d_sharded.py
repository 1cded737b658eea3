"""The uniform-grid step under shard_map (parallel/iso2d_sharded.py).

Each shard's update is a pure function of its halo-extended window, which
holds the same cells the single-device periodic step reads, so
distributing rows over devices with ppermute'd halos must reproduce the
single-device kh advance. This is the distributed analog of the
reference's guard-exchange invariance (subprog_binary_scheme.cpp:132-142).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mara3_tpu.parallel import iso2d_sharded
from mara3_tpu.physics import iso2d
from mara3_tpu.subprograms import kh


def random_state(nx, ny, seed=7):
    rng = np.random.default_rng(seed)
    sigma = 1.0 + 0.2 * rng.random((nx, ny))
    vx = 0.1 * (rng.random((nx, ny)) - 0.5)
    vy = 0.1 * (rng.random((nx, ny)) - 0.5)
    Pr = jnp.asarray(np.stack([sigma, vx, vy], axis=-1), jnp.float64)
    return iso2d.to_conserved_per_area(Pr)


@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk_order", [1, 2])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_matches_single_device(n_shards, rk_order, riemann):
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("x",))
    nx, ny = 32, 16
    u = random_state(nx, ny, seed=n_shards)
    kw = dict(cs2=0.1, dx=1.0 / nx, dy=1.0 / ny, dt=2e-3, theta=1.8,
              rk_order=rk_order, riemann=riemann)

    advance = iso2d_sharded.make_advance_sharded(mesh, **kw)
    got = advance(iso2d_sharded.shard_state(u, mesh), 3)
    want = kh.advance_n(u, 3, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-14, atol=0)
