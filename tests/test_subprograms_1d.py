"""End-to-end tests of the 1d subprograms (boilerplate, sedov): conservation,
convergence, checkpoint/restart round trips — the behavioral checks the
reference leaves to eyeballing (SURVEY.md §4 'Implication for the rebuild')."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from mara3_tpu.app.config import Config
from mara3_tpu.subprograms import boilerplate, sedov


def run_cli(module, argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return module.main(argv)
    finally:
        os.chdir(old)


# -----------------------------------------------------------------------------
# boilerplate
# -----------------------------------------------------------------------------

def test_boilerplate_advection_accuracy(tmp_path):
    assert run_cli(boilerplate, ["boilerplate", "N=128", "tfinal=0.1",
                                 "cpi=0.1"], tmp_path) == 0
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("chkpt"))
    with h5py.File(tmp_path / files[-1]) as f:
        t = f["solution/time"][()]
        u = f["solution/solution"][()]
        xv = f["solution/vertices"][()]
    xc = 0.5 * (xv[:-1] + xv[1:])
    err = np.abs(u - np.sin(2 * np.pi * (xc - t))).max()
    assert err < 0.05


def test_boilerplate_restart_continues_numbering(tmp_path):
    run_cli(boilerplate, ["boilerplate", "N=32", "tfinal=0.06", "cpi=0.02"],
            tmp_path)
    before = set(os.listdir(tmp_path))
    assert "chkpt.0002.h5" in before
    run_cli(boilerplate, ["boilerplate", "restart=chkpt.0002.h5",
                          "tfinal=0.1"], tmp_path)
    after = set(os.listdir(tmp_path))
    assert "chkpt.0004.h5" in after
    # the restart file itself must not have been overwritten mid-run
    with h5py.File(tmp_path / "chkpt.0003.h5") as f:
        assert f["solution/time"][()] > 0.06


# -----------------------------------------------------------------------------
# sedov
# -----------------------------------------------------------------------------

def _run_sedov(tmp_path, *args):
    return run_cli(sedov, ["sedov", "nr=32", "tfinal=0.3", "cpi=0.15",
                           "tsi=0.1", "dfi=0.3", *args], tmp_path)


def test_sedov_euler_conserves_mass_and_energy(tmp_path):
    assert _run_sedov(tmp_path, "newtonian=1") == 0
    totals = []
    for n in (0, 1, 2):
        with h5py.File(tmp_path / "data" / f"chkpt.000{n}.h5") as f:
            u = f["solution/conserved"][()]
            totals.append((u[:, 0].sum(), u[:, 4].sum()))
    m0, e0 = totals[0]
    for m, e in totals[1:]:
        np.testing.assert_allclose(m, m0, rtol=1e-12)
        np.testing.assert_allclose(e, e0, rtol=1e-12)


def test_sedov_srhd_runs_and_shock_moves_out(tmp_path):
    assert _run_sedov(tmp_path) == 0
    with h5py.File(tmp_path / "data" / "time_series.h5") as f:
        r = f["shock_radius"][()]
        t = f["time"][()]
    assert len(r) >= 3
    assert r[-1] > r[0]          # blast expands
    assert np.all(np.diff(t) > 0)


def test_sedov_checkpoint_layout_and_restart(tmp_path):
    _run_sedov(tmp_path, "newtonian=1")
    with h5py.File(tmp_path / "data" / "chkpt.0001.h5") as f:
        assert set(f.keys()) >= {"solution", "schedule", "run_config",
                                 "config"}
        assert {"time", "iteration", "vertices", "conserved"} <= \
            set(f["solution"].keys())
    run_cli(sedov, ["sedov", "restart=data/chkpt.0002.h5", "tfinal=0.45"],
            tmp_path)
    assert (tmp_path / "data" / "chkpt.0003.h5").exists()


def test_sedov_diagnostics_fields(tmp_path):
    _run_sedov(tmp_path)
    with h5py.File(tmp_path / "data" / "diagnostics.0000.h5") as f:
        for k in ("mass_density", "gas_pressure", "specific_entropy",
                  "radial_gamma_beta", "radial_coordinates", "shock_radius",
                  "shock_velocity"):
            assert k in f
        rho = f["mass_density"][()]
    assert np.all(rho > 0)


def test_sedov_advance_n_matches_stepwise(tmp_path):
    cfg = sedov.config_template().create().update(
        {"nr": 32, "outer_radius": 10.0, "newtonian": 1})
    s = sedov.new_solution(cfg)
    dt = sedov.grid_dt(s.vertices)
    u_multi = sedov.advance_n(s.conserved, s.vertices, dt, True, 5)
    u_step = s.conserved
    for _ in range(5):
        u_step = sedov.advance_n(u_step, s.vertices, dt, True, 1)
    np.testing.assert_allclose(u_multi, u_step, rtol=1e-12)


def test_sedov_taylor_similarity_law():
    """Physics validation: the Newtonian blast's shock radius must follow
    the Sedov-Taylor self-similar scaling R(t) ~ t^(2/5) once the swept-up
    mass dominates (uniform ambient, density_index=0)."""
    import jax.numpy as jnp
    from mara3_tpu.core import ops
    from mara3_tpu.mathx.shock import find_shock_index
    from mara3_tpu.physics import euler

    cfg = sedov.config_template().create().update(
        {"nr": 96, "newtonian": 1, "outer_radius": 100.0})
    state = sedov.new_solution(cfg)
    dt = sedov.grid_dt(state.vertices)
    dv = sedov.cell_volumes(state.vertices)

    u = state.conserved
    t = 0.0
    times, radii = [], []
    targets = np.linspace(1.0, 4.0, 12)
    next_i = 0
    while t < 4.0 and next_i < len(targets):
        u = sedov.advance_n(u, state.vertices, dt, True, 50)
        t += 50 * dt
        if t >= targets[next_i]:
            P = euler.recover_primitive(u / dv[:, None], 4 / 3, 0.0)
            s = euler.specific_entropy(P, 4 / 3)
            radii.append(float(state.vertices[int(find_shock_index(s))]))
            times.append(t)
            next_i += 1

    exponent = np.polyfit(np.log(times), np.log(radii), 1)[0]
    np.testing.assert_allclose(exponent, 0.4, atol=0.03)


@pytest.mark.parametrize("reconstruct", ["plm", "weno5"])
def test_sedov_higher_order_reconstruction_runs(tmp_path, reconstruct):
    """reconstruct_method=plm|weno5 selectable from the CLI: the run
    completes, conserves mass/energy (Euler), and produces a state that
    differs from the first-order pcm scheme."""
    d1 = tmp_path / "hi"
    d2 = tmp_path / "pcm"
    d1.mkdir(); d2.mkdir()
    assert _run_sedov(d1, "newtonian=1",
                      f"reconstruct_method={reconstruct}") == 0
    assert _run_sedov(d2, "newtonian=1") == 0
    with h5py.File(d1 / "data" / "chkpt.0002.h5") as f:
        u_hi = f["solution/conserved"][()]
    with h5py.File(d2 / "data" / "chkpt.0002.h5") as f:
        u_lo = f["solution/conserved"][()]
    assert np.isfinite(u_hi).all()
    # same conservation
    np.testing.assert_allclose(u_hi[:, 0].sum(), u_lo[:, 0].sum(),
                               rtol=1e-10)
    np.testing.assert_allclose(u_hi[:, 4].sum(), u_lo[:, 4].sum(),
                               rtol=1e-10)
    # but a genuinely different (sharper) solution near the blast
    assert np.abs(u_hi - u_lo).max() > 1e-3


def test_sedov_tuple_step_matches_stacked():
    """The tuple-form sedov step must reproduce the stacked step exactly
    for pcm and plm, euler and srhd."""
    import jax.numpy as jnp
    import numpy as np
    from mara3_tpu.physics import euler, srhd
    from mara3_tpu.subprograms import sedov

    cfg = sedov.config_template().create().update({"nr": 128})
    state = sedov.new_solution(cfg)
    dt = sedov.grid_dt(state.vertices)
    for system in (euler, srhd):
        for rec in ("pcm", "plm"):
            a = sedov._step_stacked(system, state.conserved, state.vertices,
                                    dt, rec, 1.5)
            b = sedov._step(system, state.conserved, state.vertices,
                            dt, rec, 1.5)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-14, atol=0.0)


@pytest.mark.parametrize("system_name,nr", [
    ("euler", 64), ("euler", 128), ("srhd", 64)])
@pytest.mark.parametrize("rec", ["pcm", "plm", "weno5"])
def test_sedov_fast_driver_matches_host_driver(tmp_path, rec, system_name,
                                               nr):
    """fast_step=1 (chunked advance_n driver planned to the task dues)
    must reproduce the per-step host loop: same checkpoint numbering,
    same final time, same conserved state at round-off, and the SAME
    time-series row count (dues land identically — dt is static)."""
    newtonian = 1 if system_name == "euler" else 0
    for sub, flag in (("host", "fast_step=0"), ("fast", "fast_step=1")):
        d = tmp_path / sub
        d.mkdir()
        assert _run_sedov(d, flag, f"nr={nr}", f"newtonian={newtonian}",
                          f"reconstruct_method={rec}") == 0

    def summary(d):
        names = sorted(f for f in os.listdir(d / "data")
                       if f.startswith("chkpt"))
        with h5py.File(d / "data" / names[-1]) as f:
            u, t = f["solution/conserved"][()], f["solution/time"][()]
        with h5py.File(d / "data" / "time_series.h5") as f:
            nts = f["time"].shape[0]
        return names, u, t, nts

    nh, uh, th, tsh = summary(tmp_path / "host")
    nf, uf, tf, tsf = summary(tmp_path / "fast")
    assert nh == nf
    assert tsh == tsf
    np.testing.assert_allclose(tf, th, rtol=1e-12)
    np.testing.assert_allclose(uf, uh, rtol=1e-9, atol=1e-12)
