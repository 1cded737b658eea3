"""Traced (jit-compatible) two-body orbital mechanics for the in-graph
flagship step.

Mirrors models/two_body.py (itself a redesign of src/model_two_body.hpp)
formula for formula, but on jnp scalars so the whole binary step — Kepler
solve, element inversion, perturbation bookkeeping — compiles into the same
XLA program as the hydrodynamic advance, removing the per-stage
device<->host round trip.

Representations:
  elements  e10 = [pomega, tau, cm_x, cm_y, cm_vx, cm_vy, a, M, q, e]
  bodies    [2, 5] rows (mass, x, y, vx, vy) — the scheme's bodies array.

Differences from the host path, by design:
  - Kepler's Newton iteration is a FIXED-count unrolled chain (10
    updates from a series starter, machine-precision for e <= 0.95) vs
    the reference's unbounded tolerance loop (model_two_body.hpp:131-160)
    — a while_loop pays a kernel dispatch and a predicate check per pass.
  - compute_orbital_elements cannot throw on unbound orbits
    (model_two_body.hpp:294-402 throws); an unbound state yields NaN in
    the recorded perturbation diagnostics instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mara3_tpu.models import two_body as tb

# e10 component indices
POMEGA, TAU, CMX, CMY, CMVX, CMVY, A, M, Q, E = range(10)


def pack_elements(fe: tb.FullOrbitalElements, dtype=jnp.float64):
    el = fe.elements
    return jnp.asarray([fe.pomega, fe.tau, fe.cm_position_x,
                        fe.cm_position_y, fe.cm_velocity_x, fe.cm_velocity_y,
                        el.separation, el.total_mass, el.mass_ratio,
                        el.eccentricity], dtype=dtype)


def unpack_elements(e10) -> tb.FullOrbitalElements:
    v = [float(x) for x in e10]
    return tb.FullOrbitalElements(
        pomega=v[0], tau=v[1], cm_position_x=v[2], cm_position_y=v[3],
        cm_velocity_x=v[4], cm_velocity_y=v[5],
        elements=tb.OrbitalElements(v[6], v[7], v[8], v[9]))


def orbital_period(e10):
    return 2 * jnp.pi / jnp.sqrt(e10[M] / e10[A] ** 3)


KEPLER_ITERS = 10


def _solve_kepler(ecc, M_anom):
    """E - e sin E = M by Newton (model_two_body.hpp:131-160).

    FIXED-count unrolled Newton instead of a tolerance while_loop: every
    scalar lax.while_loop pass costs a kernel dispatch plus a loop
    predicate check, and the fast flagship step runs this solve 2-3
    times per step — the unrolled chain fuses into one scalar kernel. The series starter
    x0 = M + e sin M + (e^2/2) sin 2M puts Newton in its quadratic
    basin for e <~ 0.95, so 10 updates land at machine precision —
    within the reference loop's 1e-10 stopping tolerance of its answer
    (accuracy swept over (e, M) in tests/test_models.py)."""
    x = M_anom + ecc * jnp.sin(M_anom) \
        + 0.5 * ecc * ecc * jnp.sin(2.0 * M_anom)
    for _ in range(KEPLER_ITERS):
        y = x - ecc * jnp.sin(x) - M_anom
        x = x - y / (1.0 - ecc * jnp.cos(x))
    return x


def compute_two_body_state(e10, t):
    """bodies [2,5] at time t from full elements (model_two_body.hpp:168-270:
    Kepler solve, periapse rotation, CM boost)."""
    a, Mt, q, ecc = e10[A], e10[M], e10[Q], e10[E]
    P = orbital_period(e10)
    # host path: while t < tau: t += P
    n = jnp.maximum(0.0, jnp.ceil((e10[TAU] - t) / P))
    tloc = t + n * P - e10[TAU]

    omega = jnp.where(a == 0.0, 0.0, jnp.sqrt(Mt / a ** 3))
    mu = q / (1.0 + q)

    M_anom = omega * tloc
    Ecc = jnp.where(ecc > 0.0, _solve_kepler(ecc, M_anom), M_anom)

    cE, sE = jnp.cos(Ecc), jnp.sin(Ecc)
    root = jnp.sqrt(1.0 - ecc * ecc)
    x1 = -a * mu * (ecc - cE)
    y1 = +a * mu * sE * root
    vx1 = -a * mu * omega / (1.0 - ecc * cE) * sE
    vy1 = +a * mu * omega / (1.0 - ecc * cE) * cE * root
    m1 = Mt * (1.0 - mu)
    m2 = Mt * mu
    x2, y2, vx2, vy2 = -x1 / q, -y1 / q, -vx1 / q, -vy1 / q

    c = jnp.cos(-e10[POMEGA])
    s = jnp.sin(-e10[POMEGA])

    def transform(m, x, y, vx, vy):
        xr = +x * c + y * s
        yr = -x * s + y * c
        vxr = +vx * c + vy * s
        vyr = -vx * s + vy * c
        return jnp.stack([m, xr + e10[CMX], yr + e10[CMY],
                          vxr + e10[CMVX], vyr + e10[CMVY]])

    return jnp.stack([transform(m1, x1, y1, vx1, vy1),
                      transform(m2, x2, y2, vx2, vy2)])


def compute_orbital_elements(bodies, t):
    """Inverse map bodies -> e10 (model_two_body.hpp:294-402). Unbound
    orbits (E >= 0) produce NaN instead of the reference's throw."""
    M1, M2 = bodies[0, 0], bodies[1, 0]
    Mt = M1 + M2
    q = M2 / M1

    x_cm = (bodies[0, 1] * M1 + bodies[1, 1] * M2) / Mt
    y_cm = (bodies[0, 2] * M1 + bodies[1, 2] * M2) / Mt
    vx_cm = (bodies[0, 3] * M1 + bodies[1, 3] * M2) / Mt
    vy_cm = (bodies[0, 4] * M1 + bodies[1, 4] * M2) / Mt

    x1, y1 = bodies[0, 1] - x_cm, bodies[0, 2] - y_cm
    x2, y2 = bodies[1, 1] - x_cm, bodies[1, 2] - y_cm
    r1 = jnp.hypot(x1, y1)
    r2 = jnp.hypot(x2, y2)
    vx1, vy1 = bodies[0, 3] - vx_cm, bodies[0, 4] - vy_cm
    vx2, vy2 = bodies[1, 3] - vx_cm, bodies[1, 4] - vy_cm
    vf1 = -vx1 * y1 / r1 + vy1 * x1 / r1
    vf2 = -vx2 * y2 / r2 + vy2 * x2 / r2
    v1 = jnp.hypot(vx1, vy1)

    E1 = 0.5 * M1 * (vx1 ** 2 + vy1 ** 2)
    E2 = 0.5 * M2 * (vx2 ** 2 + vy2 ** 2)
    L = M1 * r1 * vf1 + M2 * r2 * vf2
    En = E1 + E2 - M1 * M2 / (r1 + r2)
    # NaN out unbound orbits (host path raises)
    En = jnp.where(En < 0.0, En, jnp.nan)

    a = -0.5 * M1 * M2 / En
    b = jnp.sqrt(-0.5 * L * L / En * Mt / (M1 * M2))
    ecc = jnp.sqrt(jnp.clip(1.0 - b * b / (a * a), 0.0, 1.0))
    omega = jnp.sqrt(Mt / a ** 3)

    a1 = a * q / (1.0 + q)
    b1 = b * q / (1.0 + q)

    circ = ecc == 0.0
    safe_e = jnp.where(circ, 1.0, ecc)
    cn = jnp.where(circ, x1 / r1, (1.0 - r1 / a1) / safe_e)
    cf = a1 / r1 * (cn - ecc)
    root = jnp.sqrt(1.0 - ecc * ecc)
    sn = jnp.where(circ, y1 / r1,
                   (vx1 * x1 + vy1 * y1) / (safe_e * v1 * r1)
                   * jnp.sqrt(1.0 - ecc * ecc * cn * cn))
    sf = (b1 / r1) * sn

    cE = (ecc + cf) / (1.0 + ecc * cf)
    sE = root * sf / (1.0 + ecc * cf)

    EE = jnp.arctan2(sE, cE)
    MM = EE - ecc * sE
    tau = t - MM / omega

    ax = +(cn - ecc) * x1 + sn * root * y1
    ay = +(cn - ecc) * y1 - sn * root * x1
    pomega = jnp.arctan2(ay, ax)

    return jnp.stack([pomega, tau, x_cm, y_cm, vx_cm, vy_cm,
                      a, Mt, q, ecc])


def _wrap(delta, period):
    """min(|delta|, |delta±period|) selection (model_two_body.hpp:492-523)."""
    lo = delta + period
    hi = delta - period
    best = jnp.where(jnp.abs(lo) < jnp.abs(delta), lo, delta)
    return jnp.where(jnp.abs(hi) < jnp.abs(best), hi, best)


def diff(a10, b10):
    """Periodic-aware perturbation b - a: pomega mod 2 pi, tau mod the
    orbital period of b."""
    d = b10 - a10
    d = d.at[POMEGA].set(_wrap(b10[POMEGA] - a10[POMEGA], 2 * jnp.pi))
    d = d.at[TAU].set(_wrap(b10[TAU] - a10[TAU], orbital_period(b10)))
    return d


def diff_cm(a10, dt):
    """CM drift over dt (model_two_body.hpp:525-532)."""
    z = jnp.zeros_like(a10)
    return z.at[CMX].set(a10[CMVX] * dt).at[CMY].set(a10[CMVY] * dt)
