"""Binary (flagship) tests: conservation across AMR level jumps, symmetry,
both conservation formulations, fault/safe-mode path, end-to-end runs."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from mara3_tpu.subprograms import binary as B


def small_cfg(**over):
    cfg = B.create_config_template().create().update(
        {"depth": 3, "block_size": 8})
    return cfg.update({k: v for k, v in over.items()})


def test_mass_conserved_to_roundoff_across_level_jumps():
    """With sinks/buffer/viscosity off, the coarse-fine flux correction must
    conserve total mass exactly (the restrict_extrinsic pattern,
    subprog_binary_scheme.cpp:614-720)."""
    cfg = small_cfg(sink_rate=0.0, buffer_damping_rate=0.0, alpha=0.0,
                    rk_order=1)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    assert len({l for l, _, _ in sd.leaves}) > 1  # real level jumps
    dA = jnp.asarray(sd.geometry[1])
    m0 = float(jnp.sum(sol.conserved[..., 0] * dA))
    for _ in range(6):
        sol = B.next_solution(sol, sd)
    m1 = float(jnp.sum(sol.conserved[..., 0] * dA))
    np.testing.assert_allclose(m1, m0, rtol=1e-13)


def test_equal_mass_symmetry():
    cfg = small_cfg()
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    for _ in range(4):
        sol = B.next_solution(sol, sd)
    a1, a2 = sol.mass_accreted_on
    t1, t2 = sol.integrated_torque_on
    assert a1 > 0 and a2 > 0
    np.testing.assert_allclose(a1, a2, rtol=1e-8)
    np.testing.assert_allclose(t1, t2, rtol=1e-6)


def test_q_formulation_steps():
    cfg = small_cfg(conserve_linear_p=0)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    for _ in range(3):
        sol = B.next_solution(sol, sd)
    assert not bool(jnp.any(jnp.isnan(sol.conserved)))
    assert bool(jnp.all(sol.conserved[..., 0] > 0))


def test_negative_density_raises_and_safe_mode_retries():
    cfg = small_cfg(rk_order=1)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    bad = sol.conserved.at[0, 0, 0, 0].set(-1.0)
    bad_sol = B.Solution(sol.time, sol.iteration, bad,
                         orbital_elements=sol.orbital_elements)
    with pytest.raises(B.NegativeDensityError):
        B.advance(bad_sol, sd, 1e-4)


def test_pcm_and_rk1_branch():
    cfg = small_cfg(reconstruct_method="pcm", rk_order=1, fixed_dt=1)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    sol = B.next_solution(sol, sd)
    assert sol.iteration == 1
    assert not bool(jnp.any(jnp.isnan(sol.conserved)))


def test_binary_end_to_end_with_restart(tmp_path):
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert B.main(["binary", "depth=2", "block_size=8", "tfinal=0.02",
                       "cpi=0.01", "dfi=0.02", "tsi=0.005"]) == 0
        assert (tmp_path / "data" / "chkpt.0001.h5").exists()
        with h5py.File(tmp_path / "data" / "chkpt.0001.h5") as f:
            assert "conserved_u" in f["solution"]
            ts = f["time_series"][()]
            assert len(ts) >= 2
            assert (ts["disk_mass"] > 0).all()
        B.main(["binary", "restart=data/chkpt.0001.h5", "tfinal=0.03"])
        files = os.listdir(tmp_path / "data")
        assert any(f.startswith("chkpt.0002") for f in files)
    finally:
        os.chdir(old)


def test_fast_path_time_series_matches_host(tmp_path):
    """The fast (scan-chunked) driver samples its time series by replaying
    the state to each due step (subprograms/binary._main_fast); the host
    path samples the live solution every step. Same cadence, same values
    (both f64 on CPU): the rows must agree to round-off. tsi spans a few
    dt at this size (dt ~ 0.28 rad at depth 2) so dues land mid-chunk and
    the replay path actually executes."""
    args = ["binary", "depth=2", "block_size=8", "tfinal=0.5",
            "cpi=0.25", "dfi=1.0", "tsi=0.1"]
    old = os.getcwd()
    try:
        for sub, fast in (("host", "fast_step=0"), ("fast", "fast_step=1")):
            d = tmp_path / sub
            d.mkdir()
            os.chdir(d)
            assert B.main(args + [fast]) == 0
    finally:
        os.chdir(old)

    def last_ts(d):
        name = sorted(f for f in os.listdir(d / "data")
                      if f.startswith("chkpt"))[-1]
        with h5py.File(d / "data" / name) as f:
            return f["time_series"][()]

    th, tf = last_ts(tmp_path / "host"), last_ts(tmp_path / "fast")
    assert len(th) == len(tf) >= 3
    for name in TIME_SERIES_COMPARE_FIELDS:
        a, b = th[name], tf[name]
        if a.dtype.names:            # nested orbital-element compounds
            for sub in a.dtype.names:
                if sub in ("pomega", "tau"):
                    # ill-conditioned for near-circular orbits (see
                    # test_binary_fast_step.compare): the accumulated
                    # per-step diffs are deterministic but solver-noise
                    # scaled, so only the well-conditioned members bind
                    continue
                # both Kepler solvers stop at |f|<=1e-10; diffs of
                # near-circular elements amplify that to ~1e-8 absolute
                np.testing.assert_allclose(
                    _flat(a[sub]), _flat(b[sub]), rtol=1e-4, atol=1e-6,
                    err_msg=f"{name}.{sub}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       err_msg=name)


TIME_SERIES_COMPARE_FIELDS = (
    "time", "disk_mass", "disk_angular_momentum", "mass_accreted_on",
    "angular_momentum_accreted_on", "integrated_torque_on", "work_done_on",
    "mass_ejected", "angular_momentum_ejected", "orbital_elements_acc",
    "orbital_elements_grav", "orbital_elements", "position_of_mass1",
    "position_of_mass2")


def _flat(x):
    # structured scalars/arrays -> plain float arrays for allclose
    return np.asarray(x.tolist(), dtype=np.float64)


def test_diagnostics_layout(tmp_path):
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        B.main(["binary", "depth=2", "block_size=8", "tfinal=0.005",
                "cpi=1.0", "dfi=0.002", "tsi=1.0"])
        with h5py.File(tmp_path / "data" / "diagnostics.0001.h5") as f:
            for key in ("sigma", "radial_velocity", "phi_velocity",
                        "vertices"):
                assert key in f
                # flat tree keys like '2:0-1'
                assert all(":" in k for k in f[key])
            assert "position_of_mass1" in f
    finally:
        os.chdir(old)


def test_live_binary_orbital_evolution():
    """With begin_live_binary=0, accretion/torque must perturb the orbital
    elements (subprog_binary_scheme.cpp:882-902 -> live update)."""
    cfg = small_cfg(begin_live_binary=0.0)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    a0 = sol.orbital_elements.elements.separation
    M0 = sol.orbital_elements.elements.total_mass
    for _ in range(5):
        sol = B.next_solution(sol, sd)
    assert sol.orbital_elements.elements.total_mass > M0  # accreted mass
    assert sol.orbital_elements.elements.separation != a0
    # perturbations should be small over 5 steps
    assert abs(sol.orbital_elements.elements.separation - a0) < 1e-3


@pytest.mark.heavy
def test_binary_dynamic_regrid_conserves_and_tracks(tmp_path):
    """Dynamic regridding for the flagship (beyond the reference, whose
    trees are static): the leaf set adapts to the density-gradient
    indicator, the remap preserves the conserved totals exactly, and the
    run continues finite on the new layout (host and fast drivers share
    apply_regrid)."""
    import os

    from mara3_tpu.subprograms import binary as B

    cfg = B.create_config_template().create().update(
        {"depth": 4, "block_size": 8, "regrid": 1, "rgi": 0.01,
         "tfinal": 0.03, "cpi": 0.015, "outdir": str(tmp_path),
         "fast_step": 0})
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)

    # direct remap conservation check
    sol2, sd2 = B.apply_regrid(sol, sd, cfg)
    assert len(sd2.leaves) != len(sd.leaves), "indicator should refine"
    dA1 = np.asarray(sd.geometry[1])[..., None]
    dA2 = np.asarray(sd2.geometry[1])[..., None]
    tot1 = (np.asarray(sol.conserved) * dA1).sum(axis=(0, 1, 2))
    tot2 = (np.asarray(sol2.conserved) * dA2).sum(axis=(0, 1, 2))
    np.testing.assert_allclose(tot2, tot1, rtol=1e-12, atol=1e-18)

    # end-to-end: the run regrids and completes
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert B.main(["binary", "depth=4", "block_size=8", "regrid=1",
                       "rgi=0.01", "tfinal=0.03", "cpi=0.015",
                       "outdir=."]) == 0
    finally:
        os.chdir(old)
    import glob

    import h5py
    last = sorted(glob.glob(str(tmp_path / "chkpt.*.h5")))[-1]
    with h5py.File(last) as f:
        for k in f["solution/conserved_u"]:
            assert np.isfinite(f[f"solution/conserved_u/{k}"][()]).all()
