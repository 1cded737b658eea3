"""Relativistic jet / cloud interaction (GRB progenitor) in 2D (r, theta).

Re-design of src/subprog_cloud.cpp:40-954: SRHD on a log-radial x polar
spherical mesh; initial state from the cloud/envelope model at t =
jet_delay_time; inner BC is the structured jet nozzle inflow (axis-mirrored,
q -> pi - q, subprog_cloud.cpp:466-493); outer BC zero-gradient; polar
boundary fluxes are zero (axis); PCM or PLM reconstruction with zero edge
slopes; RK1 or Shu-Osher-style RK2 averaging; full spherical source terms;
CGS unit system banner (print_run_dimensions, :856-905).

One jit-compiled advance over the whole [Nr, Nq, 5] conserved
array (the reference fans the lazy pipeline over a thread pool,
subprog_cloud.cpp:525; XLA fuses and parallelizes instead). The per-theta
shock diagnostics (:328-420) vmap the masked-scan locators over polar
columns. The time-series task matches the reference exactly: its
write_time_series body is empty upstream (subprog_cloud.cpp:801-803), so the
prepared time/shock_radius datasets stay empty here too.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.app import driver, serialize
from mara3_tpu.app.config import ConfigTemplate
from mara3_tpu.app.schedule import Schedule, mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.core import ops
from mara3_tpu.mathx.plm import plm_gradient
from mara3_tpu.mathx.shock import (find_index_of_maximum_behind,
                                   find_index_of_pressure_plateau_ahead,
                                   find_shock_index)
from mara3_tpu.models.atmosphere import CloudAndEnvelope, PowerLawAtmosphere
from mara3_tpu.models.jet_nozzle import JetNozzle
from mara3_tpu.physics import srhd

GAMMA_LAW_INDEX = 4.0 / 3.0
LIGHT_SPEED_CGS = 2.998e10
SOLAR_MASS_CGS = 1.989e33


def config_template():
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("nr", 256)
            .item("tfinal", 1.0)
            .item("cpi", 10.0)
            .item("tsi", 0.1)
            .item("dfi", 1.0)
            .item("num_decades", 2.0)
            .item("inner_radius", 3e08)
            .item("cloud_cutoff", 3e10)
            .item("cloud_mass", 2e-2)
            .item("density_index", 2.0)
            .item("density_index2", 6.0)
            .item("jet_delay_time", 1.0)
            .item("jet_total_energy", 1e50)
            .item("jet_duration", 1.0)
            .item("jet_gamma_beta", 10.0)
            .item("jet_opening_angle", 0.1)
            .item("jet_structure_exp", 2.0)
            .item("cfl_number", 0.4)
            .item("rk_order", 1)
            .item("reconstruct_method", 2)
            .item("plm_theta", 1.2)
            # chunked driver loop (one dispatch per N steps; -1 = auto,
            # on when the backend is not the CPU; 0 = per-step host loop,
            # 1 = force)
            .item("fast_step", -1)
            .item("temperature_floor", 1e-8))


# -----------------------------------------------------------------------------
# models and units (subprog_cloud.cpp:285-330)
# -----------------------------------------------------------------------------

def make_cloud_envelope_model(cfg) -> CloudAndEnvelope:
    return CloudAndEnvelope(inner_radius=cfg.get_double("inner_radius"),
                            cloud_index=cfg.get_double("density_index"))


def make_atmosphere_model(cfg) -> PowerLawAtmosphere:
    m = PowerLawAtmosphere(inner_radius=cfg.get_double("inner_radius"),
                           cutoff_radius=cfg.get_double("cloud_cutoff"),
                           inner_index=cfg.get_double("density_index"),
                           outer_index=cfg.get_double("density_index2"))
    return m.with_total_mass(cfg.get_double("cloud_mass") * SOLAR_MASS_CGS)


def make_jet_nozzle_model(cfg) -> JetNozzle:
    return JetNozzle(Ej=cfg.get_double("jet_total_energy"),
                     G0=cfg.get_double("jet_gamma_beta"),
                     tj=cfg.get_double("jet_duration"),
                     qj=cfg.get_double("jet_opening_angle"),
                     as_=cfg.get_double("jet_structure_exp"),
                     r0=cfg.get_double("inner_radius"))


@dataclass(frozen=True)
class UnitSystem:
    """CGS reference units (subprog_cloud.cpp:177-195). The derived units
    are built by Quantity algebra (core/dimensional.py) so their exponents
    are machine-checked; `.value`-free float properties keep the hot-path
    API unchanged."""
    length: float = 1.0   # cm
    mass: float = 1.0     # g
    time: float = 1.0     # s

    def quantities(self):
        from mara3_tpu.core import dimensional as dim
        L = dim.make_length(self.length)
        M = dim.make_mass(self.mass)
        T = dim.make_time(self.time)
        c = dim.make_velocity(LIGHT_SPEED_CGS)
        return dict(length=L, mass=M, time=T, velocity=c,
                    energy=M * c * c,
                    mass_density=M / (L * L * L),
                    energy_density=M * c * c / (L * L * L),
                    power=M * c * c / T)

    @property
    def velocity(self): return LIGHT_SPEED_CGS
    @property
    def energy(self):
        from mara3_tpu.core.dimensional import require_dims
        return require_dims(self.quantities()["energy"], 2, 1, -2, "energy")
    @property
    def mass_density(self):
        from mara3_tpu.core.dimensional import require_dims
        return require_dims(self.quantities()["mass_density"], -3, 1, 0,
                            "mass_density")
    @property
    def energy_density(self):
        from mara3_tpu.core.dimensional import require_dims
        return require_dims(self.quantities()["energy_density"], -1, 1, -2,
                            "energy_density")
    @property
    def power(self):
        from mara3_tpu.core.dimensional import require_dims
        return require_dims(self.quantities()["power"], 2, 1, -3, "power")


def make_reference_units(cfg) -> UnitSystem:
    atmosphere = make_atmosphere_model(cfg)
    r0 = atmosphere.inner_radius
    return UnitSystem(length=r0, mass=atmosphere.total_mass(),
                      time=r0 / LIGHT_SPEED_CGS)


# -----------------------------------------------------------------------------
# spherical mesh geometry (subprog_cloud.cpp:253-283)
# -----------------------------------------------------------------------------

def radial_face_areas(rv, qv):
    """dA_r[i, j] = rv[i]^2 (cos q[j] - cos q[j+1]) 2 pi,  [Nr+1, Nq]."""
    dm = -jnp.diff(jnp.cos(qv))
    return rv[:, None] ** 2 * dm[None, :] * 2 * jnp.pi


def polar_face_areas(rv, qv):
    """dA_q[i, j] = rc[i] dr[i] sin(q[j]) 2 pi,  [Nr, Nq+1]."""
    rc = ops.midpoint_on_axis(rv)
    dr = jnp.diff(rv)
    return (rc * dr)[:, None] * jnp.sin(qv)[None, :] * 2 * jnp.pi


def cell_volumes(rv, qv):
    """dv[i, j] = (rv[i+1]^3 - rv[i]^3)/3 (cos q[j] - cos q[j+1]) 2 pi."""
    dr3 = jnp.diff(rv ** 3)
    dm = -jnp.diff(jnp.cos(qv))
    return dr3[:, None] * dm[None, :] * 2 * jnp.pi / 3.0


# -----------------------------------------------------------------------------
# solution state
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class Solution:
    time: float
    iteration: int
    radial_vertices: jax.Array
    polar_vertices: jax.Array
    conserved: jax.Array  # extrinsic U*dv, [Nr, Nq, 5]
    # run-local Newton warm-start carry (recovered pressure from the last
    # stage). Not serialized — the checkpoint layout stays
    # reference-compatible and a restart merely cold-starts one step.
    pressure: jax.Array | None = None


def new_solution(cfg) -> Solution:
    envelope = make_cloud_envelope_model(cfg)
    units = make_reference_units(cfg)
    jet_delay_time = cfg.get_double("jet_delay_time")

    nr = cfg.get_int("nr")
    num_decades = cfg.get_double("num_decades")
    rv = 10.0 ** jnp.linspace(0.0, num_decades, int(num_decades * nr) + 1)
    qv = jnp.linspace(0.0, jnp.pi, nr + 1)
    rc = ops.midpoint_on_axis(rv)
    dv = cell_volumes(rv, qv)

    # the envelope model works in CGS; construction goes through the
    # unit-checked physics boundary: each quantity is tagged, divided by
    # the matching reference unit, and verified dimensionless at trace time.
    # CGS intermediates (r^3 ~ 1e39 cm^3, solar masses ~ 2e33 g) overflow
    # float32, so the model is evaluated under a temporary x64 scope and
    # only the O(1) code-unit ratios are cast back to the run dtype
    from jax import enable_x64

    from mara3_tpu.core import dimensional as dim
    uq = units.quantities()
    temperature = 1e-6
    with enable_x64():
        r_cm = jnp.asarray(np.asarray(rc, np.float64)) * units.length
        density_cgs = dim.make_mass_density(
            envelope.density_at(r_cm, jet_delay_time))
        density64 = dim.require_dims(density_cgs / uq["mass_density"],
                                     0, 0, 0, "code density")
        gamma_beta64 = envelope.gamma_beta_at(r_cm, jet_delay_time)
    density = jnp.asarray(np.asarray(density64), rc.dtype)
    gamma_beta = jnp.asarray(np.asarray(gamma_beta64), rc.dtype)

    nq = qv.shape[0] - 1
    rho = jnp.broadcast_to(density[:, None], (rc.shape[0], nq))
    ur = jnp.broadcast_to(gamma_beta[:, None], (rc.shape[0], nq))
    z = jnp.zeros_like(rho)
    # code values keep their unit *type* tags through the constructor,
    # as the reference's unit_mass_density etc. do (physics_srhd.hpp:71-97)
    P = srhd.primitive_from_quantities(
        dim.make_mass_density(rho), ur, z, z,
        dim.make_quantity(rho * temperature, -1, 1, -2))
    U = srhd.to_conserved_density(P, GAMMA_LAW_INDEX) * dv[..., None]
    return Solution(0.0, 0, rv, qv, U)


def read_solution(group) -> Solution:
    return Solution(
        time=float(group["time"][()]),
        iteration=int(group["iteration"][()]),
        radial_vertices=jnp.asarray(group["radial_vertices"][()]),
        polar_vertices=jnp.asarray(group["polar_vertices"][()]),
        conserved=jnp.asarray(group["conserved"][()]))


def write_solution(group, s: Solution):
    group["time"] = np.float64(s.time)
    group["iteration"] = np.int64(s.iteration)
    group["radial_vertices"] = np.asarray(s.radial_vertices)
    group["polar_vertices"] = np.asarray(s.polar_vertices)
    group["conserved"] = np.asarray(s.conserved)


def create_solution(cfg) -> Solution:
    import h5py
    restart = cfg.get_string("restart")
    if restart:
        with h5py.File(restart, "r") as f:
            return read_solution(f["solution"])
    return new_solution(cfg)


# -----------------------------------------------------------------------------
# the advance (subprog_cloud.cpp:511-583)
# -----------------------------------------------------------------------------

def _face_states(P, axis, plm_theta, method):
    """L/R states at the n-1 faces between adjacent cells along `axis`,
    reproducing the reference exactly: PCM uses cell values; PLM uses
    zip_adjacent3 gradients zero-padded at the array edges
    (subprog_cloud.cpp:536-570)."""
    def ax(a, sl):
        index = [slice(None)] * a.ndim
        index[axis] = sl
        return a[tuple(index)]

    n = P.shape[axis]
    if method == 1:  # PCM
        return ax(P, slice(0, n - 1)), ax(P, slice(1, n))

    yl = ax(P, slice(0, n - 2))
    y0 = ax(P, slice(1, n - 1))
    yr = ax(P, slice(2, n))
    g_int = plm_gradient(yl, y0, yr, plm_theta)
    pad = [(0, 0)] * P.ndim
    pad[axis] = (1, 1)
    G = jnp.pad(g_int, pad)
    L = ax(P, slice(0, n - 1)) + 0.5 * ax(G, slice(0, n - 1))
    R = ax(P, slice(1, n)) - 0.5 * ax(G, slice(1, n))
    return L, R


def _inflow_row(qc, t_code, cfg_static):
    """Jet-nozzle inner guard row of primitives (subprog_cloud.cpp:466-493):
    u = jet(q) + jet(pi - q), d = rho_base / rho_ref, p = 0."""
    (jet_Ej, jet_G0, jet_tj, jet_qj, jet_as, jet_r0,
     ref_density, ref_time) = cfg_static
    jet = JetNozzle(jet_Ej, jet_G0, jet_tj, jet_qj, jet_as, jet_r0)
    t_seconds = t_code * ref_time
    u = (jet.gamma_beta(qc, t_seconds)
         + jet.gamma_beta(jnp.pi - qc, t_seconds))
    d = jnp.full_like(qc, jet.density_at_base() / ref_density)
    z = jnp.zeros_like(qc)
    return jnp.stack([d, u, z, z, z], axis=-1)[None, :, :]


def _advance_once_stacked(u0, t, geometry, jet_static, dt, plm_theta: float,
                          method: int, temperature_floor: float):
    """Reference-semantics stacked-state advance (kept as the equivalence
    oracle for the tuple-form hot path below)."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry

    P = srhd.recover_primitive(u0 / dv[..., None], GAMMA_LAW_INDEX,
                               temperature_floor)
    s0 = srhd.spherical_geometry_source_terms(
        P, rc[:, None], qc[None, :], GAMMA_LAW_INDEX) * dv[..., None]

    # radial axis: inflow nozzle inner, zero-gradient outer
    Pe = jnp.concatenate([_inflow_row(qc, t, jet_static), P, P[-1:]], axis=0)
    L, R = _face_states(Pe, 0, plm_theta, method)
    Fr = srhd.riemann_hlle(L, R, (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    lr = -ops.difference_on_axis(Fr * dAr[..., None], 0)

    # polar axis: interior faces only, zero flux at both poles
    L, R = _face_states(P, 1, plm_theta, method)
    Fq = srhd.riemann_hlle(L, R, (0.0, 1.0, 0.0), GAMMA_LAW_INDEX)
    Fq = jnp.pad(Fq, ((0, 0), (1, 1), (0, 0)))
    lq = -ops.difference_on_axis(Fq * dAq[..., None], 1)

    return u0 + (lr + lq + s0) * dt


def _face_states_1(c, axis, plm_theta, method):
    """_face_states on a single component array (no trailing axis)."""
    def ax(a, sl):
        index = [slice(None)] * a.ndim
        index[axis] = sl
        return a[tuple(index)]

    n = c.shape[axis]
    if method == 1:  # PCM
        return ax(c, slice(0, n - 1)), ax(c, slice(1, n))

    yl = ax(c, slice(0, n - 2))
    y0 = ax(c, slice(1, n - 1))
    yr = ax(c, slice(2, n))
    g_int = plm_gradient(yl, y0, yr, plm_theta)
    pad = [(0, 0)] * c.ndim
    pad[axis] = (1, 1)
    G = jnp.pad(g_int, pad)
    L = ax(c, slice(0, n - 1)) + 0.5 * ax(G, slice(0, n - 1))
    R = ax(c, slice(1, n)) - 0.5 * ax(G, slice(1, n))
    return L, R


def _advance_once(u0, t, geometry, jet_static, dt, plm_theta: float,
                  method: int, temperature_floor: float, p_guess=None,
                  return_pressure=False):
    """Tuple-form advance: same formulas and per-cell evaluation order as
    _advance_once_stacked, with the state carried as 5 component arrays so
    no stack/concatenate sits in the hot DAG (XLA then fuses whole flux
    chains). p_guess warm-starts the SRHD pressure Newton (see
    recover_primitive_t)."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry

    Ut = tuple(u0[..., k] / dv for k in range(5))
    Pt = srhd.recover_primitive_t(Ut, GAMMA_LAW_INDEX, temperature_floor,
                                  p_guess)
    inflow = _inflow_row(qc, t, jet_static)
    u1 = _flux_update(Pt, u0, inflow, geometry, dt, plm_theta, method)
    if return_pressure:
        return u1, Pt[4]
    return u1


def _flux_update(Pt, u0, inflow, geometry, dt, plm_theta: float,
                 method: int):
    """Everything after primitive recovery: BC extension, face states,
    HLLE on both axes, geometric sources, conservative update."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry

    s0 = srhd.spherical_geometry_source_terms_t(
        Pt, rc[:, None], qc[None, :], GAMMA_LAW_INDEX)

    # radial axis: inflow nozzle inner, zero-gradient outer
    def radial(comp, k):
        return jnp.concatenate([inflow[..., k], comp, comp[-1:]], axis=0)

    Pe = tuple(radial(c, k) for k, c in enumerate(Pt))
    LR = [_face_states_1(c, 0, plm_theta, method) for c in Pe]
    Fr = srhd.riemann_hlle_t(tuple(l for l, _ in LR),
                             tuple(r for _, r in LR),
                             (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    lr = tuple(-(ops.difference_on_axis(f * dAr, 0)) for f in Fr)

    # polar axis: interior faces only, zero flux at both poles
    LR = [_face_states_1(c, 1, plm_theta, method) for c in Pt]
    Fq = srhd.riemann_hlle_t(tuple(l for l, _ in LR),
                             tuple(r for _, r in LR),
                             (0.0, 1.0, 0.0), GAMMA_LAW_INDEX)
    lq = tuple(-(ops.difference_on_axis(jnp.pad(f, ((0, 0), (1, 1))) * dAq,
                                        1)) for f in Fq)

    return jnp.stack(
        [u0[..., k] + (lr[k] + lq[k] + s0[k] * dv) * dt for k in range(5)],
        axis=-1)


# dt is TRACED (not static), so one compile serves every dt
@partial(jax.jit, static_argnames=("jet_static", "plm_theta", "method",
                                   "temperature_floor", "rk_order"))
def _advance_rk(u0, t, rv, qv, jet_static, dt, plm_theta: float,
                method: int, temperature_floor: float, rk_order: int):
    # the SoA carry path does the work (stage-warm-started Newton); this
    # wrapper keeps the component-last public state layout
    us = jnp.stack([u0[..., k] for k in range(5)])
    p0 = jnp.zeros_like(us[0])
    u1s, _ = _advance_rk_carry_soa(us, p0, t, rv, qv, jet_static, dt,
                                   plm_theta, method, temperature_floor,
                                   rk_order)
    return jnp.moveaxis(u1s, 0, -1)


def _advance_once_soa(us, t, geometry, jet_static, dt, plm_theta, method,
                      temperature_floor, p_guess):
    """SoA [5, NR, NQ] stage: recovery + flux update; returns the new
    state and the recovered pressure (the next stage's Newton guess)."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry
    inflow = _inflow_row(qc, t, jet_static)
    Ut = tuple(us[k] / dv for k in range(5))
    Pt = srhd.recover_primitive_t(Ut, GAMMA_LAW_INDEX, temperature_floor,
                                  p_guess)
    u1 = _flux_update(Pt, jnp.moveaxis(us, 0, -1), inflow, geometry,
                      dt, plm_theta, method)
    return jnp.moveaxis(u1, -1, 0), Pt[4]


def _advance_rk_carry_soa(us, p_prev, t, rv, qv, jet_static, dt,
                          plm_theta, method, temperature_floor, rk_order):
    rc = ops.midpoint_on_axis(rv)
    qc = ops.midpoint_on_axis(qv)
    geometry = (rv, qv, rc, qc, cell_volumes(rv, qv),
                radial_face_areas(rv, qv), polar_face_areas(rv, qv))
    u1, p1 = _advance_once_soa(us, t, geometry, jet_static, dt, plm_theta,
                               method, temperature_floor, p_prev)
    if rk_order == 1:
        return u1, p1
    u2, p2 = _advance_once_soa(u1, t + dt, geometry, jet_static, dt,
                               plm_theta, method, temperature_floor, p1)
    return 0.5 * us + 0.5 * u2, p2


@partial(jax.jit, static_argnames=("jet_static", "plm_theta",
                                   "method", "temperature_floor",
                                   "rk_order"))
def _advance_rk_carry(u0, p_prev, t, rv, qv, jet_static, dt,
                      plm_theta: float, method: int,
                      temperature_floor: float, rk_order: int):
    """_advance_rk with the recovered pressure carried across steps, so
    every stage's Newton warm-starts (driver loops thread (u, p)). The
    state travels SoA internally; use _advance_rk_carry_soa directly to
    keep it SoA across a scan."""
    us = jnp.stack([u0[..., k] for k in range(5)])
    u1s, p1 = _advance_rk_carry_soa(us, p_prev, t, rv, qv, jet_static, dt,
                                    plm_theta, method, temperature_floor,
                                    rk_order)
    return jnp.moveaxis(u1s, 0, -1), p1


def next_solution(state: Solution, cfg) -> Solution:
    dr_min = float(state.radial_vertices[1] - state.radial_vertices[0])
    dt = dr_min * cfg.get_double("cfl_number")
    units = make_reference_units(cfg)
    jet = make_jet_nozzle_model(cfg)
    jet_static = (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
                  units.mass_density, units.time)
    p0 = (state.pressure if state.pressure is not None
          else jnp.zeros(state.conserved.shape[:2],
                         state.conserved.dtype))
    u1, p1 = _advance_rk_carry(state.conserved, p0, state.time,
                               state.radial_vertices, state.polar_vertices,
                               jet_static, dt, cfg.get_double("plm_theta"),
                               cfg.get_int("reconstruct_method"),
                               cfg.get_double("temperature_floor"),
                               cfg.get_int("rk_order"))
    return replace(state, time=state.time + dt,
                   iteration=state.iteration + 1, conserved=u1, pressure=p1)


# -----------------------------------------------------------------------------
# diagnostics (subprog_cloud.cpp:328-420)
# -----------------------------------------------------------------------------

def make_diagnostic_fields(state: Solution, cfg):
    units = make_reference_units(cfg)
    rv, qv = state.radial_vertices, state.polar_vertices
    dv = cell_volumes(rv, qv)
    dAr = radial_face_areas(rv, qv)
    rc = ops.midpoint_on_axis(rv)

    P = srhd.recover_primitive(state.conserved / dv[..., None],
                               GAMMA_LAW_INDEX,
                               cfg.get_double("temperature_floor"))
    entropy = srhd.specific_entropy(P, GAMMA_LAW_INDEX)
    F = srhd.flux(P, (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)

    # per-theta columns: locators vmapped over axis 1
    Aj_mid = ops.midpoint_on_axis(dAr, 0)              # [Nr, Nq]
    Lj = F[..., 4] * Aj_mid * units.power              # radial energy flow

    col = lambda a: jnp.moveaxis(a, 1, 0)              # [Nq, Nr]
    midpoint = jax.vmap(find_shock_index)(col(entropy))
    upstream = jax.vmap(find_index_of_pressure_plateau_ahead)(
        col(P[..., 4]), midpoint)
    pressure = jax.vmap(find_index_of_maximum_behind)(col(P[..., 4]),
                                                      midpoint)
    luminosity = jax.vmap(find_index_of_maximum_behind)(col(Lj), midpoint)

    nq = qv.shape[0] - 1
    jj = jnp.arange(nq)
    LjT = col(Lj)

    def L_at(idx):
        return LjT[jj, idx]

    back = lambda k: jnp.where(midpoint > k, midpoint - k, 0)
    lorentz = jnp.sqrt(1.0 + P[..., 1] ** 2 + P[..., 2] ** 2 + P[..., 3] ** 2)

    fields = {
        "time": float(state.time) * units.time,
        "mass_density": P[..., 0] * units.mass_density,
        "gas_pressure": P[..., 4] * units.energy_density,
        "specific_entropy": entropy,
        "radial_gamma_beta": P[..., 1],
        "radial_energy_flow": F[..., 4] * dAr[:-1, :] * units.power,
        "radial_vertices": rv * units.length,
        "polar_vertices": qv,
        "solid_angle_at_theta": dAr[0, :] / float(rv[0]) ** 2,
        "total_energy_at_theta": jnp.sum(state.conserved[..., 4], axis=0)
                                 * units.energy,
        "shock_midpoint_radius": rc[midpoint] * units.length,
        "shock_upstream_radius": rc[upstream] * units.length,
        "shock_pressure_radius": rc[pressure] * units.length,
        "shock_luminosity_radius": rc[luminosity] * units.length,
        "postshock_flow_gamma": col(lorentz)[jj, pressure],
        "postshock_flow_power": L_at(pressure),
        "postshock_flow_power02": L_at(back(2)),
        "postshock_flow_power04": L_at(back(4)),
        "postshock_flow_power08": L_at(back(8)),
        "postshock_flow_power16": L_at(back(16)),
        "postshock_flow_power32": L_at(back(32)),
        "postshock_flow_power64": L_at(back(64)),
        "postshock_flow_power_max": L_at(luminosity),
    }
    return fields


# -----------------------------------------------------------------------------
# tasks / driver (subprog_cloud.cpp:729-954)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class AppState:
    solution: Solution
    schedule: Schedule
    run_config: object


def write_checkpoint(state: AppState) -> AppState:
    import h5py
    count = state.schedule.num_times_performed("write_checkpoint")
    state = replace(
        state, schedule=state.schedule.mark_as_completed("write_checkpoint"))
    path = driver.checkpoint_path(state.run_config, count)
    with h5py.File(path, "w") as f:
        write_solution(f.require_group("solution"), state.solution)
        serialize.write_schedule(f.require_group("schedule"), state.schedule)
        serialize.write_config(f.require_group("run_config"), state.run_config)
        serialize.write_config(f.require_group("config"), state.run_config)
    print(f"write checkpoint: {path}")
    return state


def write_diagnostics(state: AppState) -> AppState:
    import h5py
    count = state.schedule.num_times_performed("write_diagnostics")
    outdir = state.run_config.get_string("outdir")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              outdir)
    fields = make_diagnostic_fields(state.solution, state.run_config)
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f[k] = np.asarray(v)
    print(f"write diagnostics: {path}")
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_diagnostics"))


def write_time_series(state: AppState) -> AppState:
    # the reference's write_time_series body is empty
    # (subprog_cloud.cpp:801-803); the task only advances its counter
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_time_series"))


def prepare_filesystem(cfg):
    import h5py
    import os
    if cfg.get_string("restart"):
        return
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    path = (f"{outdir}/time_series.h5" if outdir not in (".", "")
            else "time_series.h5")
    with h5py.File(path, "w") as f:
        for name in ("time", "shock_radius"):
            f.create_dataset(name, shape=(0,), maxshape=(None,),
                             chunks=(1000,), dtype="f8")
        serialize.write_config(f.require_group("config"), cfg)


def print_run_dimensions(cfg):
    """(subprog_cloud.cpp:863-905)."""
    c2 = LIGHT_SPEED_CGS ** 2
    env = make_cloud_envelope_model(cfg)
    jet = make_jet_nozzle_model(cfg)
    t0 = cfg.get_double("jet_delay_time")
    total_mass = env.total_mass(t0)
    r0 = env.inner_radius
    print("=" * 52)
    print("model description:\n")
    print(f"\treference length.................. {r0} cm")
    print(f"\treference time.................... {r0 / LIGHT_SPEED_CGS} s")
    print(f"\treference mass.................... {total_mass} g")
    print(f"\treference density................. {total_mass / r0 ** 3} g/cm^3")
    print(f"\treference energy.................. {total_mass * c2} erg")
    print(f"\ttotal atmosphere mass............. {total_mass / SOLAR_MASS_CGS} M_solar")
    print(f"\tcloud cutoff radius............... {float(env.cloud_outer_boundary(t0))} cm")
    print(f"\tcloud velocity.................... {float(env.velocity_at(r0, t0))} cm/s")
    print(f"\tcloud four velocity............... {float(env.gamma_beta_at(r0, t0))}")
    print(f"\tdensity at cloud base............. {float(env.density_at(r0, t0))} g/cm^3")
    print(f"\tdensity at cloud cutoff........... {float(env.density_at(float(env.cloud_outer_boundary(t0)), t0))} g/cm^3")
    print(f"\tjet mass density at base.......... {jet.density_at_base()} g/cm^3")
    print(f"\tjet Lorentz factor at q=0, t=0s... {float(jet.gamma_beta(0.0, 0.0))}")
    print(f"\tjet Lorentz factor at q=0, t=1s... {float(jet.gamma_beta(0.0, 1.0))}")
    print(f"\texplosion E / M................... {jet.Ej / (total_mass * c2)}")
    print()


def run_tasks(state: AppState) -> AppState:
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state)
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state)
    if state.schedule.is_due("write_time_series"):
        state = write_time_series(state)
    return state


def next_state(state: AppState) -> AppState:
    solution = next_solution(state.solution, state.run_config)
    cfg = state.run_config
    schedule = mark_tasks(state.schedule, solution.time, [
        ("write_checkpoint", cfg.get_double("cpi")),
        ("write_diagnostics", cfg.get_double("dfi")),
        ("write_time_series", cfg.get_double("tsi")),
    ])
    return AppState(solution, schedule, cfg)


def _main_fast(cfg, state: AppState) -> int:
    """Chunked driver loop: dt is STATIC in this scheme (dr_min * cfl),
    so the whole schedule is deterministic — each dispatch runs a
    lax.scan of N full steps (N planned to land exactly on the next task
    due), with one host interaction per chunk instead of per step. Time
    re-anchors from a float64 host accumulator each chunk (f32 runs).
    The physics path is the same _advance_rk_carry_soa the per-step
    driver uses."""
    import math as _math
    import time as _time

    sol = state.solution
    schedule = state.schedule
    dr_min = float(sol.radial_vertices[1] - sol.radial_vertices[0])
    dt = dr_min * cfg.get_double("cfl_number")
    units = make_reference_units(cfg)
    jet = make_jet_nozzle_model(cfg)
    jet_static = (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
                  units.mass_density, units.time)
    theta = cfg.get_double("plm_theta")
    method = cfg.get_int("reconstruct_method")
    tfloor = cfg.get_double("temperature_floor")
    rk = cfg.get_int("rk_order")
    tfinal = cfg.get_double("tfinal")
    intervals = [("write_checkpoint", cfg.get_double("cpi")),
                 ("write_diagnostics", cfg.get_double("dfi")),
                 ("write_time_series", cfg.get_double("tsi"))]

    rv, qv = sol.radial_vertices, sol.polar_vertices
    us = jnp.moveaxis(jnp.asarray(sol.conserved), -1, 0)
    pz = (jnp.asarray(sol.pressure) if sol.pressure is not None
          else jnp.zeros(us.shape[1:], us.dtype))
    t = float(sol.time)
    it = int(sol.iteration)
    nzones = us.shape[1] * us.shape[2]

    # dt rides as a TRACED arg so the compiled chunk is dt-independent
    @partial(jax.jit, static_argnames=("n",))
    def chunk_scan(u, pw, t0, dt_, n: int):
        def body(carry, _):
            u_, p_, td = carry
            u1, p1 = _advance_rk_carry_soa(u_, p_, td, rv, qv, jet_static,
                                           dt_, theta, method, tfloor, rk)
            return (u1, p1, td + dt_), None
        (u, pw, _), _ = jax.lax.scan(body, (u, pw, t0), length=n)
        return u, pw

    CHUNKS = (64, 16, 4, 1)
    eps = 1e-12
    while t < tfinal - eps:
        # steps to the next task due (dt static: plan exactly)
        n_cap = max(1, int(_math.ceil((tfinal - t) / dt - eps)))
        for name, ivl in intervals:
            nxt = schedule.last_performed(name) + ivl
            if nxt > t + eps:
                n_cap = min(n_cap, max(1, int(_math.ceil(
                    (nxt - t) / dt - eps))))
        n = next(c for c in CHUNKS if c <= n_cap)
        t0 = _time.perf_counter()
        us, pz = chunk_scan(us, pz, jnp.asarray(t, us.dtype), dt, n)
        jax.block_until_ready(us)
        ms = (_time.perf_counter() - t0) * 1e3
        t += n * dt
        it += n
        schedule = mark_tasks(schedule, t, intervals)
        if any(schedule.is_due(name) for name, _ in intervals):
            sol = replace(state.solution, time=t, iteration=it,
                          conserved=jnp.moveaxis(us, 0, -1), pressure=pz)
            st = run_tasks(AppState(sol, schedule, cfg))
            schedule = st.schedule
        print(f"[{it:04d}] t={t:3.7f} "
              f"kzps={n * nzones / max(ms, 1e-9) :3.2f}")

    sol = replace(state.solution, time=t, iteration=it,
                  conserved=jnp.moveaxis(us, 0, -1), pressure=pz)
    run_tasks(AppState(sol, mark_tasks(schedule, t, intervals), cfg))
    return 0


@register("cloud")
def main(argv) -> int:
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    prepare_filesystem(cfg)
    print_run_dimensions(cfg)

    state = AppState(
        create_solution(cfg),
        driver.create_schedule(cfg, ["write_checkpoint", "write_diagnostics",
                                     "write_time_series"]),
        cfg)
    state = run_tasks(state)

    if driver.use_fast_driver(cfg):
        return _main_fast(cfg, state)

    from mara3_tpu.app.performance import time_execution
    nzones = (state.solution.conserved.shape[0]
              * state.solution.conserved.shape[1])
    while state.solution.time < cfg.get_double("tfinal"):
        state, perf = time_execution(
            lambda s: run_tasks(next_state(s)), state)
        driver.print_run_loop_message(
            state.solution.iteration, state.solution.time, nzones, perf)

    run_tasks(next_state(state))
    return 0
