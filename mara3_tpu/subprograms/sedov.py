"""Sedov-Taylor blast wave in 1D spherical symmetry (Euler or SRHD).

Re-design of src/subprog_sedov.cpp:40-672: a log-spaced radial grid spanning
log10(outer_radius) decades at `nr` zones per decade, first-order Godunov
with HLLE fluxes, spherical geometry sources, reflecting-inner /
zero-gradient-outer BCs, gamma = 4/3, CFL 0.4. The `newtonian` flag selects
the Euler system instead of SRHD — the reference's compile-time template
parameter becomes a module handle chosen at config time (both physics
modules share one function vocabulary).

Shock-tracking time series (entropy-gradient locator + parabola-vertex
sub-cell interpolation, subprog_sedov.cpp:276-308) appends to an extendable
chunked time_series.h5 exactly as the reference does (:518-530, 600-614).

Design notes:
- conserved state is extrinsic (per-cell totals U*dv) in a [nr, 5] array;
  the whole update traces into one fused XLA kernel under jit.
- dt = CFL * min(dr) depends only on the static grid, so it is a Python
  float and the step count per output interval is known on the host.
- `advance_n` runs N steps inside one lax.fori_loop for benchmarking with
  zero host round-trips.

Deliberate deviation: the reference writes the checkpoint config group as
"config" (subprog_sedov.cpp:487) but its own restart path reads "run_config"
(:672 create_run_config) — restart from a sedov checkpoint is broken
upstream. Here checkpoints write "run_config" so restart works; a "config"
alias group is also written for plotting-tool compatibility.
"""

from __future__ import annotations

import math
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
from mara3_tpu.mathx.polynomial import parabola_vertex
from mara3_tpu.mathx.shock import (find_index_of_maximum_behind,
                                   find_index_of_pressure_plateau_ahead,
                                   find_shock_index)
from mara3_tpu.physics import euler, srhd

GAMMA_LAW_INDEX = 4.0 / 3.0
CFL_NUMBER = 0.4

TIME_SERIES_COLUMNS = (
    "time",
    "shock_radius",
    "shock_radius_upstream",
    "shock_radius_downstream",
    "shock_radius_interpolated",
    "shock_velocity",
)


def config_template():
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("nr", 256)
            .item("tfinal", 1.0)
            .item("cpi", 1.0)
            .item("tsi", 0.1)
            .item("dfi", 0.1)
            .item("outer_radius", 100.0)
            .item("explosion_pressure", 1.0)
            .item("explosion_density", 1.0)
            .item("density_index", 0.0)
            .item("newtonian", 0)
            # chunked driver loop (-1 = auto, on when the backend is not
            # the CPU; 0 = per-step, 1 = on)
            .item("fast_step", -1)
            # reconstruction: pcm is the reference scheme
            # (subprog_sedov.cpp runs first-order Godunov); plm and weno5
            # (mathx/weno.py, from the reference's WenoInterpolation.nb
            # derivation) reconstruct in the computational (log-radius)
            # coordinate — formally 2nd/5th order on uniform grids
            .item("reconstruct_method", "pcm")
            .item("plm_theta", 1.5))


def hydro_system(cfg):
    return euler if cfg.get_int("newtonian") != 0 else srhd


# -----------------------------------------------------------------------------
# geometry (reference subprog_sedov.cpp:144-163)
# -----------------------------------------------------------------------------

def face_areas(vertices):
    return vertices ** 2


def cell_volumes(vertices):
    r0, r1 = ops.zip_adjacent2_on_axis(vertices)
    return (r1 ** 3 - r0 ** 3) / 3.0


# -----------------------------------------------------------------------------
# solution state
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class SolutionState:
    time: float
    iteration: int
    vertices: jax.Array
    conserved: jax.Array  # extrinsic: U * dv, shape [nr, 5]


def new_solution(cfg) -> SolutionState:
    system = hydro_system(cfg)
    nr = cfg.get_int("nr")
    outer_radius = cfg.get_double("outer_radius")
    radial_decades = math.log10(outer_radius)

    y = jnp.linspace(-0.5, radial_decades, int(radial_decades * nr) + 1)
    vertices = 10.0 ** y
    rc = ops.midpoint_on_axis(vertices)
    dv = cell_volumes(vertices)

    explosion_density = cfg.get_double("explosion_density")
    explosion_pressure = cfg.get_double("explosion_pressure")
    density_index = cfg.get_double("density_index")
    temperature = 1e-6

    ambient = rc ** -density_index
    rho = jnp.where(rc < 1.0, explosion_density, ambient)
    pre = jnp.where(rc < 1.0, explosion_pressure, ambient * temperature)
    zeros = jnp.zeros_like(rc)
    # unit-checked construction (core/dimensional.py): Euler velocities are
    # [L/T]; SRHD gamma-beta is dimensionless (c = 1)
    from mara3_tpu.core import dimensional as dim
    rho_q = dim.make_mass_density(rho)
    pre_q = dim.make_quantity(pre, -1, 1, -2)
    if system is euler:
        vz = dim.make_velocity(zeros)
        P = euler.primitive_from_quantities(rho_q, vz, vz, vz, pre_q)
    else:
        P = srhd.primitive_from_quantities(rho_q, zeros, zeros, zeros,
                                           pre_q)
    U = system.to_conserved_density(P, GAMMA_LAW_INDEX) * dv[:, None]
    return SolutionState(0.0, 0, vertices, U)


def read_solution(group) -> SolutionState:
    return SolutionState(
        time=float(group["time"][()]),
        iteration=int(group["iteration"][()]),
        vertices=jnp.asarray(group["vertices"][()]),
        conserved=jnp.asarray(group["conserved"][()]))


def write_solution(group, s: SolutionState):
    group["time"] = np.float64(s.time)
    group["iteration"] = np.int64(s.iteration)
    group["vertices"] = np.asarray(s.vertices)
    group["conserved"] = np.asarray(s.conserved)


def create_solution(cfg) -> SolutionState:
    import h5py
    restart = cfg.get_string("restart")
    if restart:
        with h5py.File(restart, "r") as f:
            return read_solution(f["solution"])
    return new_solution(cfg)


# -----------------------------------------------------------------------------
# the Godunov step (reference next_solution, subprog_sedov.cpp:395-420)
# -----------------------------------------------------------------------------

def _extend_bc(P, g: int = 1):
    """Reflecting inner + zero-gradient outer (subprog_sedov.cpp:231-250),
    generalized to g guard cells per side for the higher-order stencils."""
    refl = jnp.array([1.0, -1.0, 1.0, 1.0, 1.0])
    inner = (P[:g] * refl)[::-1]
    outer = jnp.repeat(P[-1:], g, axis=0)
    return jnp.concatenate([inner, P, outer], axis=0)


def _face_states(P, reconstruct: str, plm_theta: float):
    """(L, R) states at the n+1 faces. pcm matches the reference's
    first-order scheme; plm/weno5 reconstruct in the computational
    coordinate (the grid is uniform in log radius)."""
    if reconstruct == "weno5":
        from mara3_tpu.mathx.weno import weno5_faces
        L, R = weno5_faces(_extend_bc(P, 3), axis=0)
        # positivity fallback: WENO is not positivity-preserving, so faces
        # whose reconstructed density or pressure is non-positive revert to
        # the first-order states (standard practice for blast waves)
        Pe = _extend_bc(P, 1)
        L0, R0 = Pe[:-1], Pe[1:]
        bad = ((L[:, 0] <= 0.0) | (L[:, 4] <= 0.0)
               | (R[:, 0] <= 0.0) | (R[:, 4] <= 0.0))[:, None]
        return jnp.where(bad, L0, L), jnp.where(bad, R0, R)
    if reconstruct == "plm":
        from mara3_tpu.mathx.plm import plm_gradient
        Pe = _extend_bc(P, 2)
        grad = plm_gradient(Pe[:-2], Pe[1:-1], Pe[2:], plm_theta)
        L = (Pe[1:-1] + 0.5 * grad)[:-1]
        R = (Pe[1:-1] - 0.5 * grad)[1:]
        return L, R
    Pe = _extend_bc(P, 1)
    return Pe[:-1], Pe[1:]


def _step_stacked(system, u0, vertices, dt, reconstruct="pcm",
                  plm_theta=1.5):
    """Stacked-state step: the weno5 path and the equivalence oracle for
    the tuple-form step below."""
    dv = cell_volumes(vertices)
    da = face_areas(vertices)
    rc = ops.midpoint_on_axis(vertices)

    P = system.recover_primitive(u0 / dv[:, None], GAMMA_LAW_INDEX, 0.0)
    s0 = system.spherical_geometry_source_terms_radial(
        P, rc, GAMMA_LAW_INDEX) * dv[:, None]

    L, R = _face_states(P, reconstruct, plm_theta)
    F = system.riemann_hlle(L, R, (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    l0 = -ops.difference_on_axis(F * da[:, None])
    return u0 + (l0 + s0) * dt


_REFLECT_SIGNS = (1.0, -1.0, 1.0, 1.0, 1.0)


def _step(system, u0, vertices, dt, reconstruct="pcm", plm_theta=1.5):
    """Tuple-form step: identical formulas/rounding to _step_stacked with
    the state carried as 5 component arrays, so no stack/concatenate sits
    in the fused advance loop (the stacked path materializes ~8 full-size
    [nr, 5] intermediates per step)."""
    if reconstruct == "weno5":
        return _step_stacked(system, u0, vertices, dt, reconstruct,
                             plm_theta)
    dv = cell_volumes(vertices)
    da = face_areas(vertices)
    rc = ops.midpoint_on_axis(vertices)

    Ut = tuple(u0[:, k] / dv for k in range(5))
    Pt = system.recover_primitive_t(Ut, GAMMA_LAW_INDEX, 0.0)
    s0 = system.spherical_geometry_source_terms_radial_t(
        Pt, rc, GAMMA_LAW_INDEX)

    def faces_1(c, sign):
        # reflecting inner (velocity sign flip) + zero-gradient outer,
        # matching _extend_bc with g guards per side
        if reconstruct == "plm":
            ce = jnp.concatenate([(c[:2] * sign)[::-1], c, c[-1:], c[-1:]])
            grad = plm_gradient(ce[:-2], ce[1:-1], ce[2:], plm_theta)
            L = (ce[1:-1] + 0.5 * grad)[:-1]
            R = (ce[1:-1] - 0.5 * grad)[1:]
            return L, R
        ce = jnp.concatenate([c[:1] * sign, c, c[-1:]])
        return ce[:-1], ce[1:]

    LR = [faces_1(c, s) for c, s in zip(Pt, _REFLECT_SIGNS)]
    F = system.riemann_hlle_t(tuple(l for l, _ in LR),
                              tuple(r for _, r in LR),
                              (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    return jnp.stack(
        [u0[:, k] + (-(F[k][1:] * da[1:] - F[k][:-1] * da[:-1])
                     + s0[k] * dv) * dt for k in range(5)], axis=-1)


@partial(jax.jit, static_argnames=("newtonian", "num_steps", "reconstruct",
                                   "plm_theta"))
def advance_n(u0, vertices, dt, newtonian: bool, num_steps: int,
              reconstruct: str = "pcm", plm_theta: float = 1.5):
    """num_steps Godunov steps as one fused lax.fori_loop, no host
    syncs."""
    system = euler if newtonian else srhd

    def body(_, u):
        return _step(system, u, vertices, dt, reconstruct, plm_theta)

    return jax.lax.fori_loop(0, num_steps, body, u0)


def grid_dt(vertices) -> float:
    """CFL timestep from the innermost (minimum) radial spacing — static per
    run on the fixed log grid (subprog_sedov.cpp:407-408)."""
    return CFL_NUMBER * float(vertices[1] - vertices[0])


def next_solution(state: SolutionState, newtonian: bool,
                  reconstruct: str = "pcm",
                  plm_theta: float = 1.5) -> SolutionState:
    dt = grid_dt(state.vertices)
    u1 = advance_n(state.conserved, state.vertices, dt, newtonian, 1,
                   reconstruct, plm_theta)
    return replace(state, time=state.time + dt,
                   iteration=state.iteration + 1, conserved=u1)


# -----------------------------------------------------------------------------
# diagnostics & time series (reference subprog_sedov.cpp:253-308, 493-530)
# -----------------------------------------------------------------------------

def primitives_of(state: SolutionState, system):
    dv = cell_volumes(state.vertices)
    return system.recover_primitive(state.conserved / dv[:, None],
                                    GAMMA_LAW_INDEX, 0.0)


def make_diagnostic_fields(state: SolutionState, system):
    P = primitives_of(state, system)
    return {
        "mass_density": P[:, 0],
        "gas_pressure": P[:, 4],
        "specific_entropy": system.specific_entropy(P, GAMMA_LAW_INDEX),
        "radial_gamma_beta": P[:, 1],
        "radial_coordinates": ops.midpoint_on_axis(state.vertices),
    }


def _solve_for_shock_velocity(system, p1, p2):
    """Mass-flux jump condition (subprog_sedov.cpp:88-106): relativistic
    (d2 u2 - d1 u1)/(d2 g2 - d1 g1) or newtonian (d2 v2 - d1 v1)/(d2 - d1)."""
    d1, d2 = p1[0], p2[0]
    u1, u2 = p1[1], p2[1]
    if system is srhd:
        g1 = jnp.sqrt(1.0 + p1[1] ** 2 + p1[2] ** 2 + p1[3] ** 2)
        g2 = jnp.sqrt(1.0 + p2[1] ** 2 + p2[2] ** 2 + p2[3] ** 2)
        return (d2 * u2 - d1 * u1) / (d2 * g2 - d1 * g1)
    return (d2 * u2 - d1 * u1) / (d2 - d1)


def compute_time_series_data(state: SolutionState, system):
    P = primitives_of(state, system)
    entropy = system.specific_entropy(P, GAMMA_LAW_INDEX)
    shock_index = int(find_shock_index(entropy))
    downstream_index = int(find_index_of_maximum_behind(P[:, 4], shock_index))
    upstream_index = int(find_index_of_pressure_plateau_ahead(P[:, 4],
                                                              shock_index))
    rc = ops.midpoint_on_axis(state.vertices)
    vc = P[:, 1]

    i = max(downstream_index, 1)
    x_vertex, _ = parabola_vertex(rc[i - 1], rc[i], rc[i + 1],
                                  vc[i - 1], vc[i], vc[i + 1])

    return {
        "time": float(state.time),
        "shock_radius": float(state.vertices[shock_index]),
        "shock_radius_upstream": float(rc[min(upstream_index, rc.shape[0] - 1)]),
        "shock_radius_downstream": float(rc[downstream_index]),
        "shock_radius_interpolated": float(x_vertex),
        "shock_velocity": float(_solve_for_shock_velocity(
            system, P[upstream_index if upstream_index < P.shape[0] else -1],
            P[downstream_index])),
    }


# -----------------------------------------------------------------------------
# tasks (reference subprog_sedov.cpp:480-578)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class AppState:
    solution_state: SolutionState
    schedule: Schedule
    run_config: object


def write_checkpoint(state: AppState) -> AppState:
    import h5py
    count = state.schedule.num_times_performed("write_checkpoint")
    state = replace(
        state, schedule=state.schedule.mark_as_completed("write_checkpoint"))
    path = driver.checkpoint_path(state.run_config, count)
    with h5py.File(path, "w") as f:
        write_solution(f.require_group("solution"), state.solution_state)
        serialize.write_schedule(f.require_group("schedule"), state.schedule)
        serialize.write_config(f.require_group("run_config"), state.run_config)
        serialize.write_config(f.require_group("config"), state.run_config)
    print(f"write checkpoint: {path}")
    return state


def write_diagnostics(state: AppState, system) -> AppState:
    import h5py
    count = state.schedule.num_times_performed("write_diagnostics")
    outdir = state.run_config.get_string("outdir")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              outdir)
    fields = make_diagnostic_fields(state.solution_state, system)
    ts = compute_time_series_data(state.solution_state, system)
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f[k] = np.asarray(v)
        for k, v in ts.items():
            f[k] = np.float64(v)
    print(f"write diagnostics: {path}")
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_diagnostics"))


def write_time_series(state: AppState, system) -> AppState:
    import h5py
    outdir = state.run_config.get_string("outdir")
    path = f"{outdir}/time_series.h5" if outdir not in (".", "") \
        else "time_series.h5"
    current_size = state.schedule.num_times_performed("write_time_series")
    data = compute_time_series_data(state.solution_state, system)
    with h5py.File(path, "r+") as f:
        for name, value in data.items():
            ds = f[name]
            ds.resize((current_size + 1,))
            ds[current_size] = value
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_time_series"))


def prepare_filesystem(cfg):
    """Create outdir and the extendable chunked time_series.h5
    (reference subprog_sedov.cpp:589-614)."""
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
        for name in TIME_SERIES_COLUMNS:
            f.create_dataset(name, shape=(0,), maxshape=(None,),
                             chunks=(1000,), dtype="f8")
        serialize.write_config(f.require_group("run_config"), cfg)


def run_tasks(state: AppState, system) -> AppState:
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state)
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, system)
    if state.schedule.is_due("write_time_series"):
        state = write_time_series(state, system)
    return state


def next_state(state: AppState, newtonian: bool) -> AppState:
    cfg = state.run_config
    solution = next_solution(state.solution_state, newtonian,
                             cfg.get_string("reconstruct_method"),
                             cfg.get_double("plm_theta"))
    schedule = mark_tasks(state.schedule, solution.time, [
        ("write_checkpoint", cfg.get_double("cpi")),
        ("write_diagnostics", cfg.get_double("dfi")),
        ("write_time_series", cfg.get_double("tsi")),
    ])
    return AppState(solution, schedule, cfg)


def _main_fast(cfg, state: AppState, system, newtonian: bool) -> int:
    """Chunked driver loop (cloud._main_fast rationale): the log-grid dt
    is static, so each dispatch advances N steps (one advance_n call)
    planned to land exactly on the next task due; one host interaction
    per chunk instead of per step."""
    import math as _math
    import time as _time

    ss = state.solution_state
    schedule = state.schedule
    dt = grid_dt(ss.vertices)
    tfinal = cfg.get_double("tfinal")
    rec = cfg.get_string("reconstruct_method")
    theta = cfg.get_double("plm_theta")
    intervals = [("write_checkpoint", cfg.get_double("cpi")),
                 ("write_diagnostics", cfg.get_double("dfi")),
                 ("write_time_series", cfg.get_double("tsi"))]

    u = ss.conserved
    t = float(ss.time)
    it = int(ss.iteration)
    nz = u.shape[0]

    CHUNKS = (128, 32, 8, 1)
    eps = 1e-12
    while t < tfinal - eps:
        n_cap = max(1, int(_math.ceil((tfinal - t) / dt - eps)))
        for name, ivl in intervals:
            nxt = schedule.last_performed(name) + ivl
            if nxt > t + eps:
                n_cap = min(n_cap, max(1, int(_math.ceil(
                    (nxt - t) / dt - eps))))
        n = next(c for c in CHUNKS if c <= n_cap)
        t0 = _time.perf_counter()
        u = advance_n(u, ss.vertices, dt, newtonian, n, rec, theta)
        jax.block_until_ready(u)
        ms = (_time.perf_counter() - t0) * 1e3
        t += n * dt
        it += n
        schedule = mark_tasks(schedule, t, intervals)
        if any(schedule.is_due(name) for name, _ in intervals):
            st = AppState(replace(ss, time=t, iteration=it, conserved=u),
                          schedule, cfg)
            st = run_tasks(st, system)
            schedule = st.schedule
        print(f"[{it:04d}] t={t:3.7f} "
              f"kzps={n * nz / max(ms, 1e-9):3.2f}")

    st = AppState(replace(ss, time=t, iteration=it, conserved=u),
                  mark_tasks(schedule, t, intervals), cfg)
    run_tasks(st, system)
    return 0


@register("sedov")
def main(argv) -> int:
    cfg = driver.create_run_config(config_template(), argv)
    system = hydro_system(cfg)
    newtonian = cfg.get_int("newtonian") != 0
    if cfg.get_string("reconstruct_method") not in ("pcm", "plm", "weno5"):
        raise ValueError("reconstruct_method must be pcm, plm or weno5")

    prepare_filesystem(cfg)
    cfg.pretty_print()

    state = AppState(
        create_solution(cfg),
        driver.create_schedule(cfg, ["write_checkpoint", "write_diagnostics",
                                     "write_time_series"]),
        cfg)
    state = run_tasks(state, system)

    if driver.use_fast_driver(cfg):
        return _main_fast(cfg, state, system, newtonian)

    from mara3_tpu.app.performance import time_execution
    while state.solution_state.time < cfg.get_double("tfinal"):
        state, perf = time_execution(
            lambda s: run_tasks(next_state(s, newtonian), system), state)
        if state.solution_state.iteration % 100 == 0:
            driver.print_run_loop_message(
                state.solution_state.iteration, state.solution_state.time,
                state.solution_state.conserved.shape[0], perf)

    run_tasks(next_state(state, newtonian), system)
    return 0
