"""End-to-end tests of the cloud subprogram (2D spherical SRHD + jet)."""

import os

import h5py
import numpy as np
import pytest

from mara3_tpu.subprograms import cloud


def run_cloud(tmp_path, *args):
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        return cloud.main(["cloud", "nr=32", "tfinal=0.1", "cpi=0.05",
                           "dfi=0.05", "tsi=0.05", *args])
    finally:
        os.chdir(old)


@pytest.mark.heavy
def test_cloud_runs_and_outputs(tmp_path):
    assert run_cloud(tmp_path) == 0
    data = tmp_path / "data"
    assert (data / "chkpt.0000.h5").exists()
    assert (data / "diagnostics.0001.h5").exists()
    assert (data / "time_series.h5").exists()
    with h5py.File(data / "diagnostics.0001.h5") as f:
        rho = f["mass_density"][()]
        gb = f["radial_gamma_beta"][()]
        assert np.all(rho > 0)
        assert not np.isnan(gb).any()
        # jet drives faster flow on-axis than at the equator
        assert gb[0, 0] > 1.1 * gb[0, gb.shape[1] // 2]
        for key in ("shock_midpoint_radius", "postshock_flow_power_max",
                    "total_energy_at_theta", "solid_angle_at_theta"):
            assert f[key].shape[0] == 32


def test_cloud_axisymmetry_about_equator(tmp_path):
    """With a symmetric initial state and mirrored jet, the solution must
    stay mirror-symmetric about the equator."""
    run_cloud(tmp_path)
    with h5py.File(tmp_path / "data" / "chkpt.0001.h5") as f:
        u = f["solution/conserved"][()]
    # mirror in theta: density and radial momentum even, polar momentum odd
    np.testing.assert_allclose(u[:, :, 0], u[:, ::-1, 0], rtol=1e-10)
    np.testing.assert_allclose(u[:, :, 2], -u[:, ::-1, 2], rtol=1e-10,
                               atol=1e-18)


def test_cloud_rk2_pcm_branches(tmp_path):
    assert run_cloud(tmp_path, "rk_order=2", "reconstruct_method=1") == 0
    with h5py.File(tmp_path / "data" / "chkpt.0001.h5") as f:
        u = f["solution/conserved"][()]
    assert not np.isnan(u).any()


def test_cloud_restart(tmp_path):
    run_cloud(tmp_path)
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        cloud.main(["cloud", "restart=data/chkpt.0002.h5", "tfinal=0.15"])
    finally:
        os.chdir(old)
    assert (tmp_path / "data" / "chkpt.0003.h5").exists()


def test_cloud_solid_angle_sums_to_4pi(tmp_path):
    run_cloud(tmp_path)
    with h5py.File(tmp_path / "data" / "diagnostics.0000.h5") as f:
        omega = f["solid_angle_at_theta"][()]
    np.testing.assert_allclose(omega.sum(), 4 * np.pi, rtol=1e-10)


def test_new_solution_finite_in_float32():
    """The envelope model's CGS intermediates (r^3 ~ 1e39) overflow f32;
    new_solution must evaluate the model in x64 and hand back finite
    code-unit values in the run dtype (f32 runs)."""
    import jax
    import numpy as np
    from mara3_tpu.subprograms import cloud

    with jax.enable_x64(False):
        cfg = cloud.config_template().create().update({"nr": 64})
        sol = cloud.new_solution(cfg)
        u = np.asarray(sol.conserved)
    assert u.dtype == np.float32
    assert np.isfinite(u).all()
    assert (u[..., 0] > 0).any()


@pytest.mark.heavy
def test_tuple_advance_matches_stacked():
    """The tuple-form hot path (_advance_once) must reproduce the stacked
    reference-semantics advance (_advance_once_stacked) exactly."""
    import jax.numpy as jnp
    import numpy as np
    from mara3_tpu.core import ops
    from mara3_tpu.subprograms import cloud

    cfg = cloud.config_template().create().update({"nr": 48})
    state = cloud.new_solution(cfg)
    rv, qv = state.radial_vertices, state.polar_vertices
    rc, qc = ops.midpoint_on_axis(rv), ops.midpoint_on_axis(qv)
    geometry = (rv, qv, rc, qc, cloud.cell_volumes(rv, qv),
                cloud.radial_face_areas(rv, qv),
                cloud.polar_face_areas(rv, qv))
    jet = cloud.make_jet_nozzle_model(cfg)
    units = cloud.make_reference_units(cfg)
    jet_static = (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
                  units.mass_density, units.time)
    dt = float(rv[1] - rv[0]) * cfg.get_double("cfl_number")

    for method in (1, 2):
        a = cloud._advance_once_stacked(state.conserved, 0.0, geometry,
                                        jet_static, dt, 1.5, method, 1e-6)
        b = cloud._advance_once(state.conserved, 0.0, geometry,
                                jet_static, dt, 1.5, method, 1e-6)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-14, atol=0.0)


def test_advance_rk_carry_matches_advance_rk():
    """From a zero pressure carry, _advance_rk_carry's first step is
    identical to _advance_rk (cold stage 1 + stage-warmed stage 2)."""
    import jax.numpy as jnp
    import numpy as np
    from mara3_tpu.subprograms import cloud

    cfg = cloud.config_template().create().update({"nr": 48})
    state = cloud.new_solution(cfg)
    rv, qv = state.radial_vertices, state.polar_vertices
    jet = cloud.make_jet_nozzle_model(cfg)
    units = cloud.make_reference_units(cfg)
    jet_static = (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
                  units.mass_density, units.time)
    dt = float(rv[1] - rv[0]) * cfg.get_double("cfl_number")

    a = cloud._advance_rk(state.conserved, 0.0, rv, qv, jet_static,
                          dt, 1.5, 2, 1e-6, 2)
    p0 = jnp.zeros(state.conserved.shape[:-1], state.conserved.dtype)
    b, p1 = cloud._advance_rk_carry(state.conserved, p0, 0.0, rv, qv,
                                    jet_static, dt, 1.5, 2, 1e-6, 2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=0)
    assert np.isfinite(np.asarray(p1)).all()


@pytest.mark.parametrize("method", [1, 2])
@pytest.mark.parametrize("rk_order", [1, 2])
def test_cloud_fast_driver_matches_host_driver(tmp_path, rk_order, method):
    """fast_step=1 (chunked lax.scan driver, one dispatch per planned-
    to-the-due chunk) must produce the same checkpoints as the per-step
    host loop: same numbering, same final time, same conserved state at
    round-off (dt is static, so the step sequences are identical)."""
    for sub, flag in (("host", "fast_step=0"), ("fast", "fast_step=1")):
        d = tmp_path / sub
        d.mkdir()
        assert run_cloud(d, flag, f"rk_order={rk_order}",
                         f"reconstruct_method={method}") == 0

    def last(d):
        names = sorted(f for f in os.listdir(d / "data")
                       if f.startswith("chkpt"))
        with h5py.File(d / "data" / names[-1]) as f:
            return (names, f["solution"]["conserved"][()],
                    f["solution"]["time"][()])

    names_h, u_h, t_h = last(tmp_path / "host")
    names_f, u_f, t_f = last(tmp_path / "fast")
    assert names_h == names_f
    np.testing.assert_allclose(t_f, t_h, rtol=1e-12)
    np.testing.assert_allclose(u_f, u_h, rtol=1e-6, atol=1e-12)
