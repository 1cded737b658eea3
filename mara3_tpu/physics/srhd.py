"""Special-relativistic hydrodynamics (gamma-law), 5 components, c = 1.

Re-design of src/physics_srhd.hpp. Primitive P = [rho, u1, u2, u3, p] where
u = gamma*beta is the spatial four-velocity (physics_srhd.hpp:71-97);
conserved density U = [D, S1, S2, S3, tau].

The reference's primitive recovery is a per-cell Newton iteration on the
pressure, <=50 steps to |f| < 1e-10 (physics_srhd.hpp:364-440), with thrown
exceptions on failure. JAX form: one vectorized masked
``lax.while_loop`` — every cell iterates together, converged cells freeze,
the loop exits when all cells converge (or at 50, matching the bound). The
failure conditions surface as a value-level fault mask (`recovery_failed`)
the driver can check on the host, mirroring the reference's catch-and-retry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NUM_COMPONENTS = 5

NEWTON_ITER_MAX = 50
ERROR_TOLERANCE = 1e-10


def mass_density(P):  return P[..., 0]
def gamma_beta_1(P):  return P[..., 1]
def gamma_beta_2(P):  return P[..., 2]
def gamma_beta_3(P):  return P[..., 3]
def gas_pressure(P):  return P[..., 4]


def gamma_beta_squared(P):
    return P[..., 1] ** 2 + P[..., 2] ** 2 + P[..., 3] ** 2


def lorentz_factor(P):
    return jnp.sqrt(1.0 + gamma_beta_squared(P))


def beta_along(P, nhat):
    n1, n2, n3 = nhat
    return (n1 * P[..., 1] + n2 * P[..., 2] + n3 * P[..., 3]) / lorentz_factor(P)


def enthalpy_density(P, gamma_law_index):
    """rho + p * (1 + 1/(gamma-1)) (physics_srhd.hpp:124-127)."""
    return mass_density(P) + gas_pressure(P) * (1.0 + 1.0 / (gamma_law_index - 1.0))


def specific_enthalpy(P, gamma_law_index):
    return enthalpy_density(P, gamma_law_index) / mass_density(P)


def specific_entropy(P, gamma_law_index):
    return jnp.log(gas_pressure(P) / mass_density(P) ** gamma_law_index)


def sound_speed_squared(P, gamma_law_index):
    """gamma p / (rho h) (physics_srhd.hpp:198-201)."""
    return gamma_law_index * gas_pressure(P) / enthalpy_density(P, gamma_law_index)


# -----------------------------------------------------------------------------
# conversions and fluxes (physics_srhd.hpp:204-280)
# -----------------------------------------------------------------------------

def to_conserved_density(P, gamma_law_index):
    W = lorentz_factor(P)
    h = specific_enthalpy(P, gamma_law_index)
    D = mass_density(P) * W
    p = gas_pressure(P)
    return jnp.stack([
        D,
        D * P[..., 1] * h,
        D * P[..., 2] * h,
        D * P[..., 3] * h,
        D * h * W - p - D,
    ], axis=-1)


def flux(P, nhat, gamma_law_index=None, U=None):
    if U is None:
        U = to_conserved_density(P, gamma_law_index)
    v = beta_along(P, nhat)
    p = gas_pressure(P)
    n1, n2, n3 = nhat
    return jnp.stack([
        v * U[..., 0],
        v * U[..., 1] + p * n1,
        v * U[..., 2] + p * n2,
        v * U[..., 3] + p * n3,
        v * U[..., 4] + p * v,
    ], axis=-1)


def wavespeeds(P, nhat, gamma_law_index):
    """Relativistic acoustic speeds (physics_srhd.hpp:283-300)."""
    c2 = sound_speed_squared(P, gamma_law_index)
    vn = beta_along(P, nhat)
    uu = gamma_beta_squared(P)
    vv = uu / (1.0 + uu)
    v2 = vn * vn
    k0 = jnp.sqrt(c2 * (1.0 - vv) * (1.0 - vv * c2 - v2 * (1.0 - c2)))
    return ((vn * (1.0 - c2) - k0) / (1.0 - vv * c2),
            (vn * (1.0 - c2) + k0) / (1.0 - vv * c2))


def max_wavespeed(P, gamma_law_index):
    """Upper bound on signal speed for CFL (always < 1 = c)."""
    am1, ap1 = wavespeeds(P, (1.0, 0.0, 0.0), gamma_law_index)
    am2, ap2 = wavespeeds(P, (0.0, 1.0, 0.0), gamma_law_index)
    a1 = jnp.maximum(jnp.abs(am1), jnp.abs(ap1))
    a2 = jnp.maximum(jnp.abs(am2), jnp.abs(ap2))
    return jnp.maximum(a1, a2)


# -----------------------------------------------------------------------------
# geometry source terms (physics_srhd.hpp:309-362)
# -----------------------------------------------------------------------------

def spherical_geometry_source_terms(P, spherical_radius, polar_angle_theta,
                                    gamma_law_index):
    cotq = jnp.tan(jnp.pi / 2 - polar_angle_theta)
    ur, uq, up = P[..., 1], P[..., 2], P[..., 3]
    pg = gas_pressure(P)
    H = enthalpy_density(P, gamma_law_index)
    r = spherical_radius
    z = jnp.zeros_like(pg)
    return jnp.stack([
        z,
        (2.0 * pg + H * (uq * uq + up * up)) / r,
        (cotq * pg + H * (up * up * cotq - ur * uq)) / r,
        -up * H * (ur + uq * cotq) / r,
        z,
    ], axis=-1)


def spherical_geometry_source_terms_radial(P, spherical_radius,
                                           gamma_law_index):
    uq = P[..., 2]
    pg = gas_pressure(P)
    H = enthalpy_density(P, gamma_law_index)
    z = jnp.zeros_like(pg)
    return jnp.stack([
        z,
        (2.0 * pg + H * uq * uq) / spherical_radius,
        z, z, z,
    ], axis=-1)


# -----------------------------------------------------------------------------
# primitive recovery: vectorized masked Newton (physics_srhd.hpp:364-440)
# -----------------------------------------------------------------------------

def recover_primitive(U, gamma_law_index, temperature_floor=0.0,
                      return_fault=False):
    """Iterative pressure solve, vectorized over all leading axes.

    Matches the reference loop exactly per cell: with guess p,
      v2 = min(SS/(tau+D+p)^2, 1-1e-10); W = 1/sqrt(1-v2)
      e = (tau + D(1-W) + p(1-W^2-ish)) / (D W); d = D/W; h = 1+e+p/d
      f = d e (gm-1) - p;  g = v2 * cs2 - 1;  p <- p - f/g
    converged when |f| < 1e-10; W0 is the W of the converging iteration
    (the reference records W *before* the final p update, then breaks).

    With return_fault=True also returns a bool array marking cells where the
    solver failed to converge or produced non-physical output — the jit-safe
    analog of the reference's thrown invalid_argument.
    """
    gm = gamma_law_index
    D = U[..., 0]
    tau = U[..., 4]
    SS = U[..., 1] ** 2 + U[..., 2] ** 2 + U[..., 3] ** 2

    p0 = jnp.zeros_like(D)
    W0 = jnp.ones_like(D)
    done0 = jnp.zeros_like(D, dtype=bool)

    def newton_vars(p):
        v2 = jnp.minimum(SS / (tau + D + p) ** 2, 1.0 - 1e-10)
        W2 = 1.0 / (1.0 - v2)
        W = jnp.sqrt(W2)
        e = (tau + D * (1.0 - W) + p * (1.0 - W2)) / (D * W)
        d = D / W
        h = 1.0 + e + p / d
        cs2 = gm * p / (d * h)
        f = d * e * (gm - 1.0) - p
        g = v2 * cs2 - 1.0
        return W, f, g

    def cond(state):
        p, W, done, it = state
        return jnp.logical_and(it < NEWTON_ITER_MAX, ~jnp.all(done))

    # dtype-aware tolerance: the reference's 1e-10 absolute bound
    # (physics_srhd.hpp:371) assumes double precision. f is a small
    # difference of the O(tau + D + p) terms inside e, so in finite
    # precision |f| floors at ~eps * (tau + D + p) from cancellation; in
    # float32 a single cell above that floor forces the while loop through
    # all 50 iterations over the whole mesh (measured on the cloud run).
    # The relative floor is gated off in float64 (eps ~ 2e-16 < 1e-12)
    # so f64 keeps the reference's exact absolute stopping rule even for
    # large-magnitude states (tau + D >~ 1e5 code units).
    eps = jnp.finfo(D.dtype).eps
    if eps > 1e-12:  # f32 / bf16: cancellation floor above the 1e-10 bound
        eps_rel = 8.0 * eps
        f_floor = eps_rel * (jnp.abs(tau) + D)
    else:            # f64: reference-exact absolute tolerance
        eps_rel = 0.0
        f_floor = 0.0

    def one_update(p, Wc, done):
        W, f, g = newton_vars(p)
        p_next = p - f / g
        newly = jnp.abs(f) < ERROR_TOLERANCE + f_floor + eps_rel * jnp.abs(p)
        # frozen once done; on the converging step the reference still
        # applies the p update before breaking
        p_out = jnp.where(done, p, p_next)
        W_out = jnp.where(done, Wc, jnp.where(newly, W, Wc))
        return p_out, W_out, jnp.logical_or(done, newly)

    # CHUNK updates per while iteration: per-cell results are identical
    # (frozen cells are untouched), but the all-cells-converged check and
    # its loop-carried sync happen 5x less often — each while pass is a
    # full-mesh kernel dispatch plus a predicate check
    CHUNK = 5
    assert NEWTON_ITER_MAX % CHUNK == 0

    def body(state):
        p, Wc, done, it = state
        for _ in range(CHUNK):
            p, Wc, done = one_update(p, Wc, done)
        return p, Wc, done, it + CHUNK

    p, W0, done, _ = jax.lax.while_loop(cond, body, (p0, W0, done0, 0))

    if temperature_floor > 0.0:
        p = jnp.maximum(p, temperature_floor * D / W0)

    denom = tau + D + p
    P = jnp.stack([
        D / W0,
        W0 * U[..., 1] / denom,
        W0 * U[..., 2] / denom,
        W0 * U[..., 3] / denom,
        p,
    ], axis=-1)

    if return_fault:
        fault = (~done) | (P[..., 0] <= 0.0) | (P[..., 4] <= 0.0) | jnp.isnan(W0)
        return P, fault
    return P


def recovery_failed(U, gamma_law_index, temperature_floor=0.0):
    """True anywhere primitive recovery would have thrown in the reference."""
    _, fault = recover_primitive(U, gamma_law_index, temperature_floor,
                                 return_fault=True)
    return jnp.any(fault)


# -----------------------------------------------------------------------------
# HLLE (physics_srhd.hpp:466-490)
# -----------------------------------------------------------------------------

def riemann_hlle(Pl, Pr, nhat, gamma_law_index):
    Ul = to_conserved_density(Pl, gamma_law_index)
    Ur = to_conserved_density(Pr, gamma_law_index)
    alm, alp = wavespeeds(Pl, nhat, gamma_law_index)
    arm, arp = wavespeeds(Pr, nhat, gamma_law_index)
    Fl = flux(Pl, nhat, U=Ul)
    Fr = flux(Pr, nhat, U=Ur)
    ap = jnp.maximum(0.0, jnp.maximum(alp, arp))[..., None]
    am = jnp.minimum(0.0, jnp.minimum(alm, arm))[..., None]
    return (Fl * ap - Fr * am - (Ul - Ur) * ap * am) / (ap - am)


# -----------------------------------------------------------------------------
# unit-checked API boundary: rho [M/L^3], gamma-beta dimensionless (c = 1),
# p [M/L/T^2] (reference physics_srhd.hpp:71-97)
# -----------------------------------------------------------------------------

def primitive_from_quantities(mass_density, gamma_beta_1, gamma_beta_2,
                              gamma_beta_3, gas_pressure):
    from mara3_tpu.core.dimensional import require_dims
    rho = require_dims(mass_density, -3, 1, 0, "mass_density")
    u1 = require_dims(gamma_beta_1, 0, 0, 0, "gamma_beta_1")
    u2 = require_dims(gamma_beta_2, 0, 0, 0, "gamma_beta_2")
    u3 = require_dims(gamma_beta_3, 0, 0, 0, "gamma_beta_3")
    p = require_dims(gas_pressure, -1, 1, -2, "gas_pressure")
    return jnp.stack(jnp.broadcast_arrays(rho, u1, u2, u3, p), axis=-1)


# -----------------------------------------------------------------------------
# SoA (tuple-of-components) forms of the same physics. Identical formulas
# and evaluation order per cell; states are 5-tuples of component arrays.
# The tuple form removes every stack/concatenate from the hot DAG, so XLA
# fuses whole flux chains instead of materializing [..., 5]
# intermediates. Used by the cloud
# subprogram's advance; the stacked API above remains the public surface.
# -----------------------------------------------------------------------------

def unstack(P):
    """[..., 5] -> 5-tuple of component arrays."""
    return tuple(P[..., k] for k in range(NUM_COMPONENTS))


def stack(Pt):
    return jnp.stack(Pt, axis=-1)


def lorentz_factor_t(Pt):
    return jnp.sqrt(1.0 + Pt[1] ** 2 + Pt[2] ** 2 + Pt[3] ** 2)


def to_conserved_density_t(Pt, gamma_law_index):
    rho, u1, u2, u3, p = Pt
    W = lorentz_factor_t(Pt)
    # h = enthalpy_density / rho, spelled as the stacked path rounds it
    h = (rho + p * (1.0 + 1.0 / (gamma_law_index - 1.0))) / rho
    D = rho * W
    return (D, D * u1 * h, D * u2 * h, D * u3 * h, D * h * W - p - D)


def wavespeeds_t(Pt, nhat, gamma_law_index):
    rho, u1, u2, u3, p = Pt
    n1, n2, n3 = nhat
    W = lorentz_factor_t(Pt)
    c2 = gamma_law_index * p / (rho + p * (1.0 + 1.0
                                           / (gamma_law_index - 1.0)))
    vn = (n1 * u1 + n2 * u2 + n3 * u3) / W
    uu = u1 ** 2 + u2 ** 2 + u3 ** 2
    vv = uu / (1.0 + uu)
    v2 = vn * vn
    k0 = jnp.sqrt(c2 * (1.0 - vv) * (1.0 - vv * c2 - v2 * (1.0 - c2)))
    return ((vn * (1.0 - c2) - k0) / (1.0 - vv * c2),
            (vn * (1.0 - c2) + k0) / (1.0 - vv * c2))


def flux_t(Pt, nhat, Ut):
    rho, u1, u2, u3, p = Pt
    n1, n2, n3 = nhat
    W = lorentz_factor_t(Pt)
    v = (n1 * u1 + n2 * u2 + n3 * u3) / W
    return (v * Ut[0], v * Ut[1] + p * n1, v * Ut[2] + p * n2,
            v * Ut[3] + p * n3, v * Ut[4] + p * v)


def riemann_hlle_t(Plt, Prt, nhat, gamma_law_index):
    """HLLE on tuples (physics_srhd.hpp:466-490)."""
    Ul = to_conserved_density_t(Plt, gamma_law_index)
    Ur = to_conserved_density_t(Prt, gamma_law_index)
    alm, alp = wavespeeds_t(Plt, nhat, gamma_law_index)
    arm, arp = wavespeeds_t(Prt, nhat, gamma_law_index)
    Fl = flux_t(Plt, nhat, Ul)
    Fr = flux_t(Prt, nhat, Ur)
    ap = jnp.maximum(0.0, jnp.maximum(alp, arp))
    am = jnp.minimum(0.0, jnp.minimum(alm, arm))
    return tuple((fl * ap - fr * am - (ul - ur) * ap * am) / (ap - am)
                 for fl, fr, ul, ur in zip(Fl, Fr, Ul, Ur))


def recover_primitive_t(Ut, gamma_law_index, temperature_floor=0.0,
                        p_guess=None):
    """Tuple form of recover_primitive (same masked chunked Newton).

    p_guess warm-starts the pressure iteration (e.g. from the previous
    step's recovered pressure); the reference always starts from p = 0
    (physics_srhd.hpp:393), so the default matches it. Warm starts converge
    to the same 1e-10 tolerance in ~1 chunked pass instead of 4-5 — the
    Newton loop was ~60%% of the cloud step's device time."""
    gm = gamma_law_index
    D, S1, S2, S3, tau = Ut
    SS = S1 ** 2 + S2 ** 2 + S3 ** 2

    p0 = jnp.zeros_like(D) if p_guess is None else \
        jnp.maximum(p_guess, 0.0)
    W0 = jnp.ones_like(D)
    done0 = jnp.zeros_like(D, dtype=bool)

    def newton_vars(p):
        v2 = jnp.minimum(SS / (tau + D + p) ** 2, 1.0 - 1e-10)
        W2 = 1.0 / (1.0 - v2)
        W = jnp.sqrt(W2)
        e = (tau + D * (1.0 - W) + p * (1.0 - W2)) / (D * W)
        d = D / W
        h = 1.0 + e + p / d
        cs2 = gm * p / (d * h)
        f = d * e * (gm - 1.0) - p
        g = v2 * cs2 - 1.0
        return W, f, g

    def cond(state):
        p, W, done, it = state
        return jnp.logical_and(it < NEWTON_ITER_MAX, ~jnp.all(done))

    # dtype-aware tolerance (see recover_primitive)
    eps_rel = 8.0 * jnp.finfo(D.dtype).eps
    f_floor = eps_rel * (jnp.abs(tau) + D)

    def one_update(p, Wc, done):
        W, f, g = newton_vars(p)
        p_next = p - f / g
        newly = jnp.abs(f) < ERROR_TOLERANCE + f_floor + eps_rel * jnp.abs(p)
        p_out = jnp.where(done, p, p_next)
        W_out = jnp.where(done, Wc, jnp.where(newly, W, Wc))
        return p_out, W_out, jnp.logical_or(done, newly)

    CHUNK = 5

    def body(state):
        p, Wc, done, it = state
        for _ in range(CHUNK):
            p, Wc, done = one_update(p, Wc, done)
        return p, Wc, done, it + CHUNK

    p, W0, done, _ = jax.lax.while_loop(cond, body, (p0, W0, done0, 0))

    if temperature_floor > 0.0:
        p = jnp.maximum(p, temperature_floor * D / W0)

    denom = tau + D + p
    return (D / W0, W0 * S1 / denom, W0 * S2 / denom, W0 * S3 / denom, p)


def spherical_geometry_source_terms_t(Pt, spherical_radius,
                                      polar_angle_theta, gamma_law_index):
    rho, ur, uq, up, pg = Pt
    cotq = jnp.tan(jnp.pi / 2 - polar_angle_theta)
    H = rho + pg * (1.0 + 1.0 / (gamma_law_index - 1.0))
    r = spherical_radius
    z = jnp.zeros(jnp.broadcast_shapes(jnp.shape(pg), jnp.shape(r)),
                  dtype=pg.dtype)
    return (z,
            (2.0 * pg + H * (uq * uq + up * up)) / r,
            (cotq * pg + H * (up * up * cotq - ur * uq)) / r,
            -up * H * (ur + uq * cotq) / r,
            z)


def spherical_geometry_source_terms_radial_t(Pt, spherical_radius,
                                             gamma_law_index):
    rho, ur, uq, up, pg = Pt
    H = rho + pg * (1.0 + 1.0 / (gamma_law_index - 1.0))
    z = jnp.zeros_like(pg)
    return (z, (2.0 * pg + H * uq * uq) / spherical_radius, z, z, z)
