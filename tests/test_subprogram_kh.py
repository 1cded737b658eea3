"""End-to-end tests of the kh subprogram (uniform periodic iso2d):
conservation to round-off, restart bit-exactness across arbitrary chunk
boundaries, the sharded path against the single-device one, and the full
CLI file surface."""

import pytest
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.subprograms import kh


def run_cli(argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return kh.main(argv)
    finally:
        os.chdir(old)


def _mini_cfg(**over):
    cfg = kh.config_template().create()
    base = dict(N=32, tfinal=0.05, cpi=0.02, dfi=0.02, tsi=0.01,
                outdir=".")
    base.update(over)
    return cfg.update({k: str(v) for k, v in base.items()})


def test_kh_conserves_mass_and_momentum():
    cfg = _mini_cfg(N=32)
    u0 = kh.initial_conserved(cfg)
    dt = kh.fixed_timestep(cfg, u0)
    u1 = kh.advance_n(u0, 25, cs2=1.0, dx=1.0 / 32, dy=1.0 / 32, dt=dt,
                      theta=1.8)
    s0 = np.asarray(jnp.sum(u0, axis=(0, 1)))
    s1 = np.asarray(jnp.sum(u1, axis=(0, 1)))
    # periodic box: mass and both momentum components exact to round-off
    assert np.allclose(s1, s0, rtol=1e-12, atol=1e-12 * abs(s0[0]))
    assert not np.isnan(np.asarray(u1)).any()


def test_kh_cli_file_surface_and_restart_bitexact(tmp_path):
    args = ["kh", "N=32", "tfinal=0.04", "cpi=0.02", "dfi=0.04",
            "tsi=0.01", "outdir=."]
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()

    # uninterrupted run
    assert run_cli(args, a) == 0
    files = set(os.listdir(a))
    assert {"chkpt.0000.h5", "chkpt.0001.h5", "chkpt.0002.h5",
            "diagnostics.0000.h5", "time_series.h5"} <= files

    # interrupted + restarted run must be bit-identical
    assert run_cli(args[:2] + ["tfinal=0.02"] + args[3:], b) == 0
    assert run_cli(["kh", "restart=chkpt.0001.h5", "tfinal=0.04"], b) == 0
    with h5py.File(a / "chkpt.0002.h5") as fa, \
            h5py.File(b / "chkpt.0002.h5") as fb:
        np.testing.assert_array_equal(fa["solution/conserved"][()],
                                      fb["solution/conserved"][()])
        assert fa["solution/time"][()] == fb["solution/time"][()]
        assert fa["solution/dt"][()] == fb["solution/dt"][()]

    # time series rows are monotone in time and conserve mass
    with h5py.File(a / "time_series.h5") as f:
        t = f["time"][()]
        m = f["total_mass"][()]
    assert len(t) >= 4 and (np.diff(t) > 0).all()
    np.testing.assert_allclose(m, m[0], rtol=1e-12)


def test_kh_diagnostics_fields(tmp_path):
    assert run_cli(["kh", "N=32", "tfinal=0.01", "cpi=1.0", "dfi=1.0",
                    "tsi=1.0", "outdir=."], tmp_path) == 0
    with h5py.File(tmp_path / "diagnostics.0000.h5") as f:
        sigma = f["sigma"][()]
        vort = f["vorticity"][()]
    assert sigma.shape == (32, 32) and vort.shape == (32, 32)
    assert (sigma > 0).all()
    # the shear layer carries vorticity; the quiet corners don't
    assert np.abs(vort).max() > 1.0


def test_kh_sharded_multichip_matches_jnp(tmp_path):
    """shards=4 on the virtual CPU mesh (the jnp step under shard_map
    with ppermute halos) reproduces the single-device evolution."""
    assert run_cli(["kh", "N=128", "tfinal=0.01", "cpi=0.01", "dfi=1.0",
                    "tsi=1.0", "outdir=.", "shards=4"], tmp_path) == 0
    with h5py.File(tmp_path / "chkpt.0001.h5") as f:
        got = f["solution/conserved"][()]
        iters = int(f["solution/iteration"][()])
        dt = float(f["solution/dt"][()])
    cfg = _mini_cfg(N=128)
    u0 = kh.initial_conserved(cfg)
    want = kh.advance_n(u0, iters, cs2=1.0, dx=1.0 / 128, dy=1.0 / 128,
                        dt=dt, theta=1.8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.heavy
def test_kh_rk2_paths_agree_and_conserve(tmp_path):
    """rk_order=2: the sharded CLI path and the single-device Heun scheme
    agree; conservation holds."""
    cfg = _mini_cfg(N=128)
    u0 = kh.initial_conserved(cfg)
    dt = kh.fixed_timestep(cfg, u0)
    a = kh.advance_n(u0, 8, cs2=1.0, dx=1.0 / 128, dy=1.0 / 128, dt=dt,
                     theta=1.8, rk_order=2)
    s0 = np.asarray(jnp.sum(u0, axis=(0, 1)))
    s1 = np.asarray(jnp.sum(a, axis=(0, 1)))
    assert np.allclose(s1, s0, rtol=1e-12, atol=1e-12 * abs(s0[0]))

    # CLI with shards + rk2 (v4 rk2 stripes under shard_map)
    assert run_cli(["kh", "N=128", "tfinal=0.005", "cpi=0.005", "dfi=1.0",
                    "tsi=1.0", "outdir=.", "shards=2", "rk_order=2"],
                   tmp_path) == 0
    with h5py.File(tmp_path / "chkpt.0001.h5") as f:
        got = f["solution/conserved"][()]
        iters = int(f["solution/iteration"][()])
        dtc = float(f["solution/dt"][()])
    want = kh.advance_n(u0, iters, cs2=1.0, dx=1.0 / 128, dy=1.0 / 128,
                        dt=dtc, theta=1.8, rk_order=2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_kh_rk2_is_second_order_in_time():
    """Temporal self-convergence on a smooth acoustic field at fixed N
    (spatial error cancels against the same-N fine-dt reference): rk1
    converges at ~1st order, rk2 at ~2nd, and rk2's error is orders of
    magnitude smaller at equal dt."""
    N = 64
    x = (jnp.arange(N, dtype=jnp.float64) + 0.5)[:, None] / N
    y = (jnp.arange(N, dtype=jnp.float64) + 0.5)[None, :] / N
    sg = 1.0 + 0.1 * jnp.sin(2 * jnp.pi * x) * jnp.ones_like(y)
    u0 = jnp.stack([sg,
                    0.02 * sg * jnp.sin(2 * jnp.pi * y) * jnp.ones_like(x),
                    jnp.zeros((N, N))], axis=-1)
    T = 0.04

    def run(nsteps, rk):
        return kh.advance_n(u0, nsteps, cs2=1.0, dx=1 / N, dy=1 / N,
                            dt=T / nsteps, theta=1.8, rk_order=rk)

    orders, errs = {}, {}
    for rk in (1, 2):
        ref = run(256, rk)
        e = [float(jnp.abs(run(n, rk) - ref).max()) for n in (16, 32)]
        orders[rk] = np.log2(e[0] / e[1])
        errs[rk] = e[0]
    assert 0.8 < orders[1] < 1.5, orders
    assert 1.8 < orders[2] < 2.4, orders
    assert errs[2] < errs[1] / 30, errs


def test_kh_bf16_precision_mode(tmp_path):
    """precision=bf16 runs end-to-end (the mixed-precision ceiling
    trial), writes f32 checkpoints (exact for bf16 values), restarts in
    bf16, and tracks the f32 evolution at bf16 resolution."""
    args = ["kh", "N=32", "tfinal=0.02", "cpi=0.01", "dfi=1.0", "tsi=1.0",
            "outdir=."]
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    assert run_cli(args + ["precision=bf16"], a) == 0
    assert run_cli(args + ["precision=f32"], b) == 0
    with h5py.File(a / "chkpt.0001.h5") as f:
        u16 = f["solution/conserved"][()]
        assert u16.dtype == np.float32      # stored as f32
    with h5py.File(b / "chkpt.0001.h5") as f:
        u32 = f["solution/conserved"][()]
    rel = np.sum(np.abs(u16.astype(np.float64) - u32.astype(np.float64)))
    rel /= np.sum(np.abs(u32.astype(np.float64)))
    assert np.isfinite(rel) and rel < 2e-2, rel

    # restart continues in bf16 and stays bit-exact vs uninterrupted
    assert run_cli(["kh", "restart=chkpt.0001.h5", "tfinal=0.03",
                    "precision=bf16"], a) == 0
    with h5py.File(a / "chkpt.0002.h5") as f:
        assert f["solution/time"][()] > 0.02
