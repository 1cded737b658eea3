"""Dual-precision bounds, pinned (PRECISION.md is the narrative).

The performance path runs f32 on the accelerator while parity runs f64 on CPU
(SURVEY.md §7 'dual-precision support from day one'). These tests pin the
f32-vs-f64 error of each physics system to its derived scale, so a
regression in the numerics (or an overly aggressive fast-math change)
trips a bound rather than silently degrading the f32 path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.physics import euler, iso2d, srhd

EPS32 = float(np.finfo(np.float32).eps)


def srhd_grid():
    states = []
    for rho in (0.1, 1.0, 10.0):
        for ur in (0.0, 0.5, 2.0, 10.0):
            for uq in (0.0, -1.5):
                for p in (1e-6, 1e-2, 1.0, 100.0):
                    states.append([rho, ur, uq, 0.25 * uq, p])
    return jnp.asarray(states, jnp.float64)


def test_srhd_f32_recovery_error_scales():
    """f32 Newton recovery errors sit at the derived cancellation scales:
      |dp|      <= 8 eps32 (|tau| + D + p)      (f = small diff of these)
      |drho|/rho <= 64 eps32 W^2                 (dW/W ~ W^2 v^2 dp/(tau+D+p))
    and the only faults are states whose pressure is below the f32
    representability floor p ~ eps32 (tau + D), where no f32 algorithm
    could recover it (measured: bounds hold with ~7x headroom)."""
    P = srhd_grid()
    U = srhd.to_conserved_density(P, 4.0 / 3.0)
    R64 = srhd.recover_primitive(U, 4.0 / 3.0)
    R32, fault = srhd.recover_primitive(U.astype(jnp.float32), 4.0 / 3.0,
                                        return_fault=True)
    D = np.asarray(U[:, 0])
    tau = np.asarray(U[:, 4])
    p64 = np.asarray(R64[:, 4])
    W = np.sqrt(1.0 + np.sum(np.asarray(P[:, 1:4]) ** 2, axis=1))
    ok = ~np.asarray(fault)

    # faults only below the representability floor
    floor_ratio = p64 / (EPS32 * (np.abs(tau) + D))
    assert np.all(floor_ratio[~ok] < 1.0)

    err_p = np.abs(np.asarray(R32[:, 4], np.float64) - p64)
    assert np.max((err_p / (EPS32 * (np.abs(tau) + D + p64)))[ok]) < 8.0

    err_rho = (np.abs(np.asarray(R32[:, 0], np.float64)
                      - np.asarray(R64[:, 0])) / np.asarray(R64[:, 0]))
    assert np.max((err_rho / (EPS32 * W ** 2))[ok]) < 64.0


def test_euler_f32_recovery_error_scale():
    """The algebraic euler recovery computes p = (g-1)(E - KE): one
    cancellation, so |dp|/p <= 8 eps32 (E + KE)/|E - KE| (measured 0.66x
    the scale)."""
    states = []
    for rho in (0.1, 1.0, 2.5):
        for u in (-0.5, 0.0, 0.7):
            for v in (0.25, -1.0):
                for p in (0.01, 1.0, 10.0):
                    states.append([rho, u, v, 0.1 * u - 0.2 * v, p])
    P = jnp.asarray(states, jnp.float64)
    U = euler.to_conserved_density(P, 5.0 / 3.0)
    R64 = euler.recover_primitive(U, 5.0 / 3.0)
    R32 = euler.recover_primitive(U.astype(jnp.float32), 5.0 / 3.0)

    E = np.asarray(U[:, 4])
    KE = 0.5 * np.sum(np.asarray(U[:, 1:4]) ** 2, axis=1) / np.asarray(U[:, 0])
    amp = (E + KE) / np.abs(E - KE)
    rel_p = (np.abs(np.asarray(R32[:, 4], np.float64)
                    - np.asarray(R64[:, 4])) / np.asarray(R64[:, 4]))
    assert np.max(rel_p / (EPS32 * amp)) < 8.0


def test_iso2d_f32_evolution_drift_bound():
    """f32 vs f64 drift of the periodic PLM+HLLE scheme grows ~linearly at
    a few ulp/step (measured ~5.4): pinned at 32 ulp/step so fast-math
    changes that degrade the kernel numerics trip here."""
    from mara3_tpu.schemes import iso2d_grid

    n, steps = 64, 50
    cs2, dx = 0.1, 2.0 / n
    dt = 0.4 * dx
    x = (-1 + 2.0 * (jnp.arange(n) + 0.5) / n)[:, None]
    y = x.T
    sigma = 1.0 + 0.5 * jnp.exp(-(x ** 2 + y ** 2) / 0.1)
    vx = 0.1 * jnp.sin(2 * jnp.pi * y) * jnp.ones_like(sigma)
    vy = -0.1 * jnp.sin(2 * jnp.pi * x) * jnp.ones_like(sigma)
    u64 = iso2d.to_conserved_per_area(jnp.stack([sigma, vx, vy], axis=-1))
    u32 = u64.astype(jnp.float32)

    @jax.jit
    def run(u):
        return jax.lax.fori_loop(
            0, steps,
            lambda i, u: iso2d_grid.step_periodic_uniform(u, cs2, dx, dx,
                                                          dt, 1.8), u)

    u64 = run(u64)
    u32 = run(u32)
    drift = np.max(np.abs(np.asarray(u32, np.float64) - np.asarray(u64))
                   / (np.abs(np.asarray(u64)) + 1e-3))
    assert drift < steps * 32 * EPS32


def test_srhd_f64_keeps_reference_absolute_tolerance():
    """In float64 the dtype-aware tolerance must reduce to the reference's
    exact 1e-10 absolute rule — i.e. converged states satisfy |f| < 1e-10
    even at large magnitude (tau + D ~ 1e6), where a relative floor would
    have loosened it (ADVICE r2)."""
    big = jnp.asarray([[1e3, 0.5, 0.0, 0.0, 1e5]], jnp.float64)
    U = srhd.to_conserved_density(big, 4.0 / 3.0)
    R, fault = srhd.recover_primitive(U, 4.0 / 3.0, return_fault=True)
    assert not bool(fault[0])
    # residual of the recovered state, recomputed independently (the
    # returned p carries one extra Newton update past the |f| < 1e-10
    # check; quadratic convergence puts its own residual below the bound)
    gm = 4.0 / 3.0
    D, tau = U[0, 0], U[0, 4]
    SS = jnp.sum(U[0, 1:4] ** 2)
    p = R[0, 4]
    v2 = jnp.minimum(SS / (tau + D + p) ** 2, 1.0 - 1e-10)
    W2 = 1.0 / (1.0 - v2)
    W = jnp.sqrt(W2)
    e = (tau + D * (1.0 - W) + p * (1.0 - W2)) / (D * W)
    d = D / W
    f = d * e * (gm - 1.0) - p
    assert abs(float(f)) < 1e-10
