"""Fully-jitted flagship step (schemes/binary_step.py) vs the host-side
next_solution path — CFL, RK stages, orbital bookkeeping, safe retry."""

import numpy as np
import pytest

from mara3_tpu.models import two_body_jax as tbj
from mara3_tpu.schemes import binary_step
from mara3_tpu.subprograms import binary as B


def build(updates):
    cfg = B.create_config_template().create().update(updates)
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    return cfg, sd, sol


def compare(sol_h, sol_f, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(sol_f.time, sol_h.time, rtol=rtol)
    assert sol_f.iteration == sol_h.iteration
    np.testing.assert_allclose(np.asarray(sol_f.conserved),
                               np.asarray(sol_h.conserved),
                               rtol=rtol, atol=atol)
    for k in ("mass_accreted_on", "angular_momentum_accreted_on",
              "integrated_torque_on", "work_done_on"):
        np.testing.assert_allclose(getattr(sol_f, k), getattr(sol_h, k),
                                   rtol=1e-7, atol=1e-15, err_msg=k)
    np.testing.assert_allclose(sol_f.mass_ejected, sol_h.mass_ejected,
                               rtol=1e-7, atol=1e-15)
    for k in ("orbital_elements_acc", "orbital_elements_grav",
              "orbital_elements"):
        a = np.asarray(tbj.pack_elements(getattr(sol_f, k)))
        b = np.asarray(tbj.pack_elements(getattr(sol_h, k)))
        # pomega/tau are ill-conditioned for near-circular orbits and both
        # Kepler solvers stop at |f|<=1e-10, so they agree only in absolute
        # terms; the other elements are tight
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(a[6:], b[6:], rtol=1e-4, atol=1e-9,
                                   err_msg=k + " (a,M,q,e)")


@pytest.mark.parametrize("rk_order", [1, 2])
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("reconstruct", ["plm", "pcm"])
@pytest.mark.parametrize("conserve_p", [True, False])
def test_fast_step_matches_host_path(conserve_p, reconstruct, riemann,
                                     rk_order):
    """The driver's fast scan (schemes/binary_step.make_fast_scan) must
    track the host-bookkeeping path step for step: state, accounting
    accumulators, live orbital elements."""
    cfg, sd, sol_h = build({
        "depth": 3, "block_size": 8, "rk_order": rk_order,
        "conserve_linear_p": 1 if conserve_p else 0,
        "reconstruct_method": reconstruct, "riemann": riemann,
        "begin_live_binary": 0.0})
    scan_steps = binary_step.make_fast_scan(sd)
    s = binary_step.solution_to_arrays(sol_h, np.float64)

    # two steps: pcm+hllc at rk2 faults on the third at this tiny mesh,
    # where the host path retries and the retry-free scan flags the row
    s, rows = scan_steps(s, 2)
    for _ in range(2):
        sol_h = B.next_solution(sol_h, sd)
    rows = np.asarray(rows)
    assert not rows[:, binary_step.INFO_INDEX["invalid"]].any()
    np.testing.assert_allclose(rows[-1, binary_step.INFO_INDEX["time"]],
                               sol_h.time, rtol=1e-9)
    compare(sol_h, binary_step.arrays_to_solution(s, B.Solution))


@pytest.mark.parametrize("conserve_p", [True, False])
def test_fast_step_info_matches_host_diagnostics(conserve_p):
    """The retrying single step's info scalars match the host
    diagnostics (disk mass and angular momentum, both formulations)."""
    cfg, sd, sol_h = build({
        "depth": 3, "block_size": 8,
        "conserve_linear_p": 1 if conserve_p else 0,
        "begin_live_binary": 0.0})
    step = binary_step.make_fast_step(sd)
    s = binary_step.solution_to_arrays(sol_h, np.float64)
    for _ in range(2):
        sol_h = B.next_solution(sol_h, sd)
        s, info = step(s)
        assert not bool(info["retried"])
        assert not bool(info["invalid"])
    compare(sol_h, binary_step.arrays_to_solution(s, B.Solution))
    np.testing.assert_allclose(float(info["disk_mass"]),
                               B.disk_mass(sol_h, sd), rtol=1e-9)
    np.testing.assert_allclose(float(info["disk_angular_momentum"]),
                               B.disk_angular_momentum(sol_h, sd), rtol=1e-8)


def test_fast_step_safe_retry_matches_host():
    """An over-CFL step must trigger the in-graph dt/10 theta=0 retry and
    land on the same state as the host try/except path
    (subprog_binary.cpp:285-292)."""
    updates = {"depth": 3, "block_size": 8, "fixed_dt": 1,
               "cfl_number": 6.0}
    cfg, sd, sol_h = build(updates)
    step = binary_step.make_fast_step(sd)
    s = binary_step.solution_to_arrays(sol_h, np.float64)

    s, info = step(s)
    assert bool(info["retried"]), "expected the safe-mode retry to fire"
    assert not bool(info["invalid"])
    sol_h = B.next_solution(sol_h, sd)     # host catches + retries
    compare(sol_h, binary_step.arrays_to_solution(s, B.Solution))


def test_retry_free_scan_plus_repair_matches_cond_steps():
    """The driver's fault handling: a retry-free scan chunk whose rows
    flag a negative density is rewound and repaired (replay good steps,
    run the faulted step through the retrying variant). The result must
    equal stepping sequentially with the in-graph-retry step."""
    import jax.numpy as jnp

    cfg, sd, sol = build({"depth": 3, "block_size": 8, "fixed_dt": 1,
                          "cfl_number": 3.0, "rk_order": 1})
    IX = binary_step.INFO_INDEX
    scan_steps = binary_step.make_fast_scan(sd)
    cond_step = binary_step.make_fast_step(sd)          # retrying variant
    s0 = binary_step.solution_to_arrays(sol, np.float64)

    # sequential reference: 4 steps with in-graph retry
    s_ref = s0
    retried = []
    for _ in range(4):
        s_ref, info = cond_step(s_ref)
        retried.append(bool(info["retried"]))
        assert not bool(info["invalid"])
    assert any(retried), "config should trigger at least one retry"

    # chunked path: retry-free scan + host repair, exactly as _main_fast
    s2 = s0
    steps_done = 0
    while steps_done < 4:
        n = min(4 - steps_done, 4)
        s_prev = s2
        s2, rows = scan_steps(s2, n)
        rows = np.asarray(rows)
        inv = rows[:, IX["invalid"]] > 0
        if inv.any():
            bad = int(np.argmax(inv))
            s2 = s_prev
            for _ in range(bad):
                s2, _ = scan_steps(s2, 1)
            s2, info = cond_step(s2)
            assert not bool(info["invalid"])
            steps_done += bad + 1
        else:
            steps_done += n

    np.testing.assert_allclose(np.asarray(s2["conserved"]),
                               np.asarray(s_ref["conserved"]),
                               rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(float(s2["time"]), float(s_ref["time"]),
                               rtol=1e-14)
