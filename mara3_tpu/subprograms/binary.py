"""Circumbinary disk accretion — the flagship workload.

Re-design of src/subprog_binary.{hpp,cpp} + _scheme/_solver_data/_io/
_diagnostics.cpp: 2D locally-isothermal thin disk (iso2d) on a static
quadtree AMR mesh focused on the binary, with live orbital evolution driven
by accreted mass/momentum and gravitational torque, sink particles,
softened gravity, wave-damping buffer, alpha/nu viscosity, density floor,
PLM+HLLE, RK1/RK2, and safe-mode retry on negative density
(subprog_binary.cpp:285-292).

Division of labor: the whole hydrodynamic advance is one jit
program over [B, bs, bs, 3] blocks (schemes/binary_scheme.py); the host
keeps only the scalar orbital-element bookkeeping — Kepler solves and
element inversion (models/two_body.py) act on ~10 numbers per step, exactly
the part the reference also runs serially.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.app import driver, serialize
from mara3_tpu.app.config import ConfigTemplate
from mara3_tpu.app.schedule import Schedule, mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.mesh import block_layout, tree
from mara3_tpu.models import two_body
from mara3_tpu.physics import iso2d
from mara3_tpu.schemes import binary_scheme
from mara3_tpu.schemes.binary_scheme import SchemeConfig


def create_config_template():
    """(subprog_binary.cpp:50-99)."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("cpi", 10.0)
            .item("dfi", 1.0)
            .item("tsi", 2e-3)
            .item("tfinal", 1.0)
            .item("cfl_number", 0.4)
            .item("fixed_dt", 0)
            .item("depth", 4)
            .item("begin_live_binary", 1e6)
            .item("conserve_linear_p", 1)
            .item("block_size", 24)
            .item("focus_factor", 2.00)
            .item("focus_index", 2.00)
            .item("threaded", 1)
            .item("rk_order", 2)
            .item("reconstruct_method", "plm")
            # the reference pins hlle (subprog_binary_solver_data.cpp:109);
            # hllc (physics_iso2d.hpp:704-712) is selectable here
            .item("riemann", "hlle")
            .item("plm_theta", 1.8)
            .item("source_term_softening", 1.0)
            .item("softening_radius", 0.05)
            .item("sink_radius", 0.05)
            .item("sink_rate", 1.0)
            .item("buffer_damping_rate", 10.0)
            .item("domain_radius", 12.0)
            .item("disk_radius", 2.0)
            .item("disk_mass", 1e-3)
            .item("ambient_density", 1e-4)
            .item("density_floor", 0.0)
            .item("separation", 1.0)
            .item("mass_ratio", 1.0)
            .item("eccentricity", 0.0)
            .item("counter_rotate", 0)
            .item("mach_number", 10.0)
            .item("axisymmetric_cs2", 0)
            .item("no_accretion_force", 0)
            .item("alpha_cutoff_radius", 0.0)
            .item("alpha", 0.1)
            .item("nu", 0.0)
            .item("mdot", 0.0)
            # fully-jitted step (CFL + RK + orbital bookkeeping + safe
            # retry in one XLA program, schemes/binary_step.py):
            # 1 on, 0 off, -1 auto (on when the backend is not the CPU)
            # adaptive regridding (beyond the reference, whose trees are
            # static): rebuild the leaf set from the density-gradient
            # indicator every `rgi` orbits (mesh/regrid.py); each regrid
            # recompiles the step for the new block count (amortized by
            # the persistent compilation cache)
            .item("regrid", 0)
            .item("rgi", 0.5)
            .item("fast_step", -1))


# -----------------------------------------------------------------------------
# disk profile (subprog_binary.cpp:104-152; sigma normalization from the
# equilibrium Mathematica notebook, cited at :115)
# -----------------------------------------------------------------------------

def disk_profile(cfg, xy):
    """Primitive state [.., 3] at positions xy [.., 2]."""
    rs = cfg.get_double("softening_radius")
    rc = cfg.get_double("disk_radius")
    Ma = cfg.get_double("mach_number")
    disk_mass = cfg.get_double("disk_mass")
    ambient = cfg.get_double("ambient_density")
    mdot = cfg.get_double("mdot")
    counter = -1.0 if cfg.get_int("counter_rotate") else 1.0

    s0 = disk_mass / (17.0618 * rc * rc)
    s1 = ambient * s0

    x, y = xy[..., 0], xy[..., 1]
    r = jnp.sqrt(x * x + y * y)
    xs = r / rc
    sigma = s0 * jnp.exp(-0.5 * (xs - 1) ** 2) + s1
    dp_dr = (1.0 / Ma / Ma / (r + rs)) * (
        xs * (1 - xs) * (1 - s1 / sigma) - 1.0)
    vp = jnp.sqrt(jnp.maximum(1.0 / (r + rs) + dp_dr, 0.0)) * counter
    vr = -mdot / (sigma * 2 * jnp.pi * r) * (r > 2.0)
    vx = vr * (x / r) + vp * (-y / r)
    vy = vr * (y / r) + vp * (x / r)
    # unit-checked construction at the physics boundary: sigma carries
    # the surface-density tag, velocities the velocity tag
    # (core/dimensional.py; reference physics_iso2d.hpp:58-77)
    from mara3_tpu.core import dimensional as dim
    return iso2d.primitive_from_quantities(
        dim.make_quantity(sigma, -2, 1, 0),
        dim.make_velocity(vx), dim.make_velocity(vy))


# -----------------------------------------------------------------------------
# solver data (subprog_binary_solver_data.cpp:18-117)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class SolverData:
    cfg_scheme: SchemeConfig
    leaves: tuple
    nt: object
    geometry: tuple            # (xc, dA, spacing, xf, yf)
    vertices: np.ndarray       # [B, bs+1, bs+1, 2]
    initial_conserved: jax.Array
    buffer_rate: jax.Array
    recommended_time_step: float
    cfl_number: float
    plm_theta: float
    rk_order: int
    fixed_dt: bool
    begin_live_binary: float
    no_accretion_force: bool
    conserve_linear_p: bool
    advance: object = field(repr=False, default=None)
    maximum_timestep: object = field(repr=False, default=None)


def create_leaves(cfg):
    focus_factor = cfg.get_double("focus_factor")
    focus_index = cfg.get_double("focus_index")
    depth = cfg.get_int("depth")

    from mara3_tpu import native
    if native.available():
        return tuple(native.build_quadtree(focus_factor, focus_index, depth))

    def predicate(level, radius):
        # reference refinement_radius (subprog_binary.cpp:166-184); at
        # level 0 the pow is 1/0^n -> inf, so the root always refines
        threshold = (focus_factor / level ** focus_index if level > 0
                     else float("inf"))
        return radius < threshold

    return tuple(tree.create_quadtree(predicate, depth))


def create_solver_data(cfg, leaves=None) -> SolverData:
    bs = cfg.get_int("block_size")
    rd = cfg.get_double("domain_radius")
    if leaves is None:
        leaves = create_leaves(cfg)
    leaves = tuple(leaves)
    nt = block_layout.build_neighbor_table(leaves)

    verts = block_layout.block_vertices(leaves, bs) * rd
    xc = block_layout.block_cell_centers(leaves, bs) * rd
    spacing = block_layout.block_dx(leaves, bs) * rd
    dA = np.broadcast_to((spacing ** 2)[:, None, None],
                         xc.shape[:-1]).copy()
    xf = 0.5 * (verts[:, :, :-1] + verts[:, :, 1:])   # x-face centers
    yf = 0.5 * (verts[:, :-1, :] + verts[:, 1:, :])   # y-face centers

    conserve_linear_p = bool(cfg.get_int("conserve_linear_p"))
    P0 = disk_profile(cfg, jnp.asarray(xc))
    if conserve_linear_p:
        initial = iso2d.to_conserved_per_area(P0)
    else:
        initial = iso2d.to_conserved_angmom_per_area(P0, jnp.asarray(xc))

    # buffer damping field (subprog_binary_solver_data.cpp:61-76)
    r_cell = np.sqrt(xc[..., 0] ** 2 + xc[..., 1] ** 2)
    buffer_rate = cfg.get_double("buffer_damping_rate") * (
        1.0 + np.tanh(3.0 * (r_cell - rd)))

    max_velocity = max(1.0, float(jnp.max(jnp.sqrt(
        P0[..., 1] ** 2 + P0[..., 2] ** 2))))
    min_dx = float(spacing.min())
    recommended_dt = min_dx / max_velocity * cfg.get_double("cfl_number")

    scheme = SchemeConfig(
        block_size=bs,
        domain_radius=rd,
        mach_number=cfg.get_double("mach_number"),
        softening_radius=cfg.get_double("softening_radius"),
        sink_radius=cfg.get_double("sink_radius"),
        sink_rate=cfg.get_double("sink_rate"),
        gst_suppr_radius=cfg.get_double("source_term_softening") * min_dx,
        density_floor=cfg.get_double("density_floor")
                      * cfg.get_double("disk_mass"),
        alpha=cfg.get_double("alpha"),
        alpha_cutoff_radius=cfg.get_double("alpha_cutoff_radius"),
        nu=cfg.get_double("nu"),
        axisymmetric_cs2=bool(cfg.get_int("axisymmetric_cs2")),
        conserve_linear_p=conserve_linear_p,
        reconstruct_method=cfg.get_string("reconstruct_method"),
        buffer_damping_rate=cfg.get_double("buffer_damping_rate"),
        riemann=cfg.get_string("riemann"))
    if scheme.reconstruct_method not in ("plm", "pcm"):
        raise ValueError(f"invalid reconstruct_method "
                         f"'{scheme.reconstruct_method}', must be plm or pcm")
    if scheme.riemann not in ("hlle", "hllc"):
        raise ValueError(f"invalid riemann '{scheme.riemann}', "
                         f"must be hlle or hllc")
    if cfg.get_int("threaded") <= 0:
        raise ValueError("runtime option 'threaded' must be > 0")

    geometry = (xc, dA, spacing, xf, yf)
    return SolverData(
        cfg_scheme=scheme, leaves=leaves, nt=nt, geometry=geometry,
        vertices=verts,
        initial_conserved=initial,
        buffer_rate=jnp.asarray(buffer_rate),
        recommended_time_step=recommended_dt,
        cfl_number=cfg.get_double("cfl_number"),
        plm_theta=cfg.get_double("plm_theta"),
        rk_order=cfg.get_int("rk_order"),
        fixed_dt=bool(cfg.get_int("fixed_dt")),
        # the reference's config comment says orbits but its code compares
        # the raw value against code time (subprog_binary_solver_data.cpp
        # begin_live_binary assignment; advance_u's `live` test) — match the
        # code, not the comment
        begin_live_binary=cfg.get_double("begin_live_binary"),
        no_accretion_force=bool(cfg.get_int("no_accretion_force")),
        conserve_linear_p=conserve_linear_p,
        advance=binary_scheme.make_advance(
            scheme, nt, geometry, initial, buffer_rate),
        maximum_timestep=binary_scheme.make_maximum_timestep(scheme,
                                                             geometry))


# -----------------------------------------------------------------------------
# solution state (subprog_binary.hpp:95-126)
# -----------------------------------------------------------------------------

ZERO2 = (0.0, 0.0)


@dataclass(frozen=True)
class Solution:
    time: float
    iteration: int
    conserved: jax.Array              # [B, bs, bs, 3] (u or q formulation)
    mass_accreted_on: Tuple[float, float] = ZERO2
    angular_momentum_accreted_on: Tuple[float, float] = ZERO2
    integrated_torque_on: Tuple[float, float] = ZERO2
    work_done_on: Tuple[float, float] = ZERO2
    mass_ejected: float = 0.0
    angular_momentum_ejected: float = 0.0
    orbital_elements_acc: two_body.FullOrbitalElements = \
        two_body.make_full_orbital_elements_with_zeros()
    orbital_elements_grav: two_body.FullOrbitalElements = \
        two_body.make_full_orbital_elements_with_zeros()
    orbital_elements: two_body.FullOrbitalElements = \
        two_body.FullOrbitalElements()

    def scaled_plus(self, other: "Solution", wa: float, wb: float):
        """wa*self + wb*other for the RK averaging (the reference's
        solution_t operator+/operator*, subprog_binary_scheme.cpp:1022+)."""
        add2 = lambda a, b: (wa * a[0] + wb * b[0], wa * a[1] + wb * b[1])
        return Solution(
            time=wa * self.time + wb * other.time,
            iteration=int(wa * self.iteration + wb * other.iteration),
            conserved=wa * self.conserved + wb * other.conserved,
            mass_accreted_on=add2(self.mass_accreted_on,
                                  other.mass_accreted_on),
            angular_momentum_accreted_on=add2(
                self.angular_momentum_accreted_on,
                other.angular_momentum_accreted_on),
            integrated_torque_on=add2(self.integrated_torque_on,
                                      other.integrated_torque_on),
            work_done_on=add2(self.work_done_on, other.work_done_on),
            mass_ejected=wa * self.mass_ejected + wb * other.mass_ejected,
            angular_momentum_ejected=wa * self.angular_momentum_ejected
                                     + wb * other.angular_momentum_ejected,
            orbital_elements_acc=self.orbital_elements_acc * wa
                                 + other.orbital_elements_acc * wb,
            orbital_elements_grav=self.orbital_elements_grav * wa
                                  + other.orbital_elements_grav * wb,
            orbital_elements=self.orbital_elements * wa
                             + other.orbital_elements * wb)


def create_binary_params(cfg) -> two_body.OrbitalElements:
    return two_body.OrbitalElements(
        separation=cfg.get_double("separation"),
        total_mass=1.0,
        mass_ratio=cfg.get_double("mass_ratio"),
        eccentricity=cfg.get_double("eccentricity"))


def create_solution(cfg, solver_data: SolverData) -> Solution:
    return Solution(
        time=0.0, iteration=0,
        conserved=jnp.asarray(solver_data.initial_conserved),
        orbital_elements=two_body.make_full_orbital_elements(
            create_binary_params(cfg)))


def _bodies_array(state: two_body.TwoBodyState) -> jax.Array:
    return jnp.asarray([
        [state.body1.mass, state.body1.position_x, state.body1.position_y,
         state.body1.velocity_x, state.body1.velocity_y],
        [state.body2.mass, state.body2.position_x, state.body2.position_y,
         state.body2.velocity_x, state.body2.velocity_y]])


class NegativeDensityError(RuntimeError):
    pass


def advance(solution: Solution, sd: SolverData, dt: float,
            safe_mode: bool = False) -> Solution:
    """One hydro step + orbital-element bookkeeping
    (binary::advance_u/advance_q, subprog_binary_scheme.cpp:790-1020)."""
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    bodies = _bodies_array(bstate)
    theta = 0.0 if safe_mode else sd.plm_theta

    u1, totals, invalid = sd.advance(solution.conserved, bodies, dt, theta)
    if bool(invalid):
        # report the worst cell like the reference's validate_u printout
        # (subprog_binary_scheme.cpp:726-744)
        sig = np.asarray(u1[..., 0])
        b, i, j = np.unravel_index(np.nanargmin(sig), sig.shape)
        x, y = np.asarray(sd.geometry[0])[b, i, j]
        print(f"negative density {sig[b, i, j]:3.2e} "
              f"(at position [{x:+3.2f} {y:+3.2f}])")
        raise NegativeDensityError("negative density in updated state")
    t = {k: np.asarray(v) for k, v in totals.items()}

    b1, b2 = bstate.body1, bstate.body2
    dM1, dM2 = float(t["mass_accreted_on"][0]), float(t["mass_accreted_on"][1])
    dpx1 = float(t["momentum_x_accreted_on"][0])
    dpy1 = float(t["momentum_y_accreted_on"][0])
    dpx2 = float(t["momentum_x_accreted_on"][1])
    dpy2 = float(t["momentum_y_accreted_on"][1])

    def accreted(b, dM, dpx, dpy):
        if sd.no_accretion_force:
            vx, vy = b.velocity_x, b.velocity_y
        else:
            vx = (b.mass * b.velocity_x + dpx) / (b.mass + dM)
            vy = (b.mass * b.velocity_y + dpy) / (b.mass + dM)
        return two_body.PointMass(b.mass + dM, b.position_x, b.position_y,
                                  vx, vy)

    def forced(b, dfx, dfy):
        return two_body.PointMass(
            b.mass, b.position_x, b.position_y,
            b.velocity_x + dfx / b.mass, b.velocity_y + dfy / b.mass)

    E0 = solution.orbital_elements
    E_acc = two_body.compute_orbital_elements(
        two_body.TwoBodyState(accreted(b1, dM1, dpx1, dpy1),
                              accreted(b2, dM2, dpx2, dpy2)), solution.time)
    E_grv = two_body.compute_orbital_elements(
        two_body.TwoBodyState(
            forced(b1, float(t["integrated_force_x_on"][0]),
                   float(t["integrated_force_y_on"][0])),
            forced(b2, float(t["integrated_force_x_on"][1]),
                   float(t["integrated_force_y_on"][1]))), solution.time)

    live = 1.0 if solution.time > sd.begin_live_binary else 0.0
    d_acc = two_body.diff(E0, E_acc)
    d_grv = two_body.diff(E0, E_grv)
    d_cm = two_body.diff_cm(E0, dt)

    add2 = lambda a, v: (a[0] + float(v[0]), a[1] + float(v[1]))
    return Solution(
        time=solution.time + dt,
        iteration=solution.iteration + 1,
        conserved=u1,
        mass_accreted_on=add2(solution.mass_accreted_on,
                              t["mass_accreted_on"]),
        angular_momentum_accreted_on=add2(
            solution.angular_momentum_accreted_on,
            t["angular_momentum_accreted_on"]),
        integrated_torque_on=add2(solution.integrated_torque_on,
                                  t["integrated_torque_on"]),
        work_done_on=add2(solution.work_done_on, t["work_done_on"]),
        mass_ejected=solution.mass_ejected + float(t["mass_ejected"]),
        angular_momentum_ejected=solution.angular_momentum_ejected
                                 + float(t["angular_momentum_ejected"]),
        orbital_elements_acc=solution.orbital_elements_acc + d_acc,
        orbital_elements_grav=solution.orbital_elements_grav + d_grv,
        orbital_elements=solution.orbital_elements
                         + (d_acc + d_grv + d_cm) * live)


def next_solution(solution: Solution, sd: SolverData) -> Solution:
    """RK1/RK2 with safe-mode retry (subprog_binary.cpp:258-292)."""
    if sd.fixed_dt:
        dt = sd.recommended_time_step
    else:
        bodies = _bodies_array(two_body.compute_two_body_state(
            solution.orbital_elements, solution.time))
        dt = sd.cfl_number * float(sd.maximum_timestep(solution.conserved,
                                                       bodies))

    def can_fail(dt, safe_mode):
        if sd.rk_order == 1:
            return advance(solution, sd, dt, safe_mode)
        s1 = advance(solution, sd, dt, safe_mode)
        s2 = advance(s1, sd, dt, safe_mode)
        return solution.scaled_plus(s2, 0.5, 0.5)

    try:
        return can_fail(dt, False)
    except NegativeDensityError as e:
        print(e)
        return can_fail(dt * 0.1, True)


# -----------------------------------------------------------------------------
# I/O (subprog_binary_io.cpp)
# -----------------------------------------------------------------------------

ORBITAL_DTYPE = np.dtype([
    ("separation", "f8"), ("total_mass", "f8"), ("mass_ratio", "f8"),
    ("eccentricity", "f8")])
FULL_ORBITAL_DTYPE = np.dtype([
    ("pomega", "f8"), ("tau", "f8"), ("cm_position_x", "f8"),
    ("cm_position_y", "f8"), ("cm_velocity_x", "f8"),
    ("cm_velocity_y", "f8"), ("elements", ORBITAL_DTYPE)])
TIME_SERIES_DTYPE = np.dtype([
    ("time", "f8"), ("disk_mass", "f8"), ("disk_angular_momentum", "f8"),
    ("mass_accreted_on", "f8", (2,)),
    ("angular_momentum_accreted_on", "f8", (2,)),
    ("integrated_torque_on", "f8", (2,)),
    ("work_done_on", "f8", (2,)),
    ("mass_ejected", "f8"), ("angular_momentum_ejected", "f8"),
    ("orbital_elements_acc", FULL_ORBITAL_DTYPE),
    ("orbital_elements_grav", FULL_ORBITAL_DTYPE),
    ("orbital_elements", FULL_ORBITAL_DTYPE),
    ("position_of_mass1", "f8", (2,)), ("position_of_mass2", "f8", (2,))])


def _full_elements_to_np(e: two_body.FullOrbitalElements):
    return (e.pomega, e.tau, e.cm_position_x, e.cm_position_y,
            e.cm_velocity_x, e.cm_velocity_y,
            (e.elements.separation, e.elements.total_mass,
             e.elements.mass_ratio, e.elements.eccentricity))


def _full_elements_from_np(row) -> two_body.FullOrbitalElements:
    el = row["elements"]
    return two_body.FullOrbitalElements(
        pomega=float(row["pomega"]), tau=float(row["tau"]),
        cm_position_x=float(row["cm_position_x"]),
        cm_position_y=float(row["cm_position_y"]),
        cm_velocity_x=float(row["cm_velocity_x"]),
        cm_velocity_y=float(row["cm_velocity_y"]),
        elements=two_body.OrbitalElements(
            float(el["separation"]), float(el["total_mass"]),
            float(el["mass_ratio"]), float(el["eccentricity"])))


def write_solution(group, s: Solution, sd: SolverData):
    group["time"] = np.float64(s.time)
    group["iteration"] = np.int64(s.iteration)
    idxs = [(l, (i, j)) for (l, i, j) in sd.leaves]
    name = "conserved_u" if sd.conserve_linear_p else "conserved_q"
    serialize.write_tree(group.require_group(name), idxs,
                         list(np.asarray(s.conserved)))
    group.require_group("conserved_q" if sd.conserve_linear_p
                        else "conserved_u")
    for key in ("mass_accreted_on", "angular_momentum_accreted_on",
                "integrated_torque_on", "work_done_on"):
        group[key] = np.asarray(getattr(s, key))
    group["mass_ejected"] = np.float64(s.mass_ejected)
    group["angular_momentum_ejected"] = np.float64(s.angular_momentum_ejected)
    for key in ("orbital_elements_acc", "orbital_elements_grav",
                "orbital_elements"):
        group[key] = np.array(_full_elements_to_np(getattr(s, key)),
                              dtype=FULL_ORBITAL_DTYPE)


def read_solution(group, sd: SolverData) -> Solution:
    name = "conserved_u" if sd.conserve_linear_p else "conserved_q"
    idxs, blocks = serialize.read_tree(group[name])
    order = {(l, i, j): b for b, (l, i, j) in
             enumerate((l, c[0], c[1]) for l, c in idxs)}
    stacked = np.stack([blocks[order[leaf]] for leaf in sd.leaves])
    g2 = lambda k: tuple(float(v) for v in group[k][()])
    return Solution(
        time=float(group["time"][()]),
        iteration=int(group["iteration"][()]),
        conserved=jnp.asarray(stacked),
        mass_accreted_on=g2("mass_accreted_on"),
        angular_momentum_accreted_on=g2("angular_momentum_accreted_on"),
        integrated_torque_on=g2("integrated_torque_on"),
        work_done_on=g2("work_done_on"),
        mass_ejected=float(group["mass_ejected"][()]),
        angular_momentum_ejected=float(
            group["angular_momentum_ejected"][()]),
        orbital_elements_acc=_full_elements_from_np(
            group["orbital_elements_acc"][()]),
        orbital_elements_grav=_full_elements_from_np(
            group["orbital_elements_grav"][()]),
        orbital_elements=_full_elements_from_np(
            group["orbital_elements"][()]))


# -----------------------------------------------------------------------------
# time series & diagnostics (subprog_binary.cpp:358-379,
# subprog_binary_diagnostics.cpp)
# -----------------------------------------------------------------------------

def disk_mass(solution: Solution, sd: SolverData) -> float:
    xc, dA = sd.geometry[0], sd.geometry[1]
    return float(jnp.sum(solution.conserved[..., 0] * dA))


def disk_angular_momentum(solution: Solution, sd: SolverData) -> float:
    xc, dA = jnp.asarray(sd.geometry[0]), jnp.asarray(sd.geometry[1])
    if sd.conserve_linear_p:
        lz = iso2d.angular_momentum(solution.conserved, xc)
    else:
        lz = solution.conserved[..., 2]
    return float(jnp.sum(lz * dA))


def time_series_sample(solution: Solution, sd: SolverData):
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    return np.array((
        solution.time, disk_mass(solution, sd),
        disk_angular_momentum(solution, sd),
        solution.mass_accreted_on, solution.angular_momentum_accreted_on,
        solution.integrated_torque_on, solution.work_done_on,
        solution.mass_ejected, solution.angular_momentum_ejected,
        _full_elements_to_np(solution.orbital_elements_acc),
        _full_elements_to_np(solution.orbital_elements_grav),
        _full_elements_to_np(solution.orbital_elements),
        (bstate.body1.position_x, bstate.body1.position_y),
        (bstate.body2.position_x, bstate.body2.position_y)),
        dtype=TIME_SERIES_DTYPE)


def diagnostic_fields(solution: Solution, sd: SolverData):
    xc = jnp.asarray(sd.geometry[0])
    if sd.conserve_linear_p:
        p0 = iso2d.recover_primitive(solution.conserved)
    else:
        p0 = iso2d.recover_primitive_angmom(solution.conserved, xc)
    r = jnp.sqrt(xc[..., 0] ** 2 + xc[..., 1] ** 2)
    vx, vy = p0[..., 1], p0[..., 2]
    vr = (vx * xc[..., 0] + vy * xc[..., 1]) / r
    vp = (-vx * xc[..., 1] + vy * xc[..., 0]) / r
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    return {
        "sigma": np.asarray(p0[..., 0]),
        "radial_velocity": np.asarray(vr),
        "phi_velocity": np.asarray(vp),
        "position_of_mass1": np.array([bstate.body1.position_x,
                                       bstate.body1.position_y]),
        "position_of_mass2": np.array([bstate.body2.position_x,
                                       bstate.body2.position_y]),
    }


# -----------------------------------------------------------------------------
# app state / tasks / driver (subprog_binary.cpp:295-449)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule
    time_series: tuple
    run_config: object


def write_checkpoint(state: State, sd: SolverData) -> State:
    import h5py
    count = state.schedule.num_times_performed("write_checkpoint")
    state = replace(
        state, schedule=state.schedule.mark_as_completed("write_checkpoint"))
    path = driver.checkpoint_path(state.run_config, count)
    with h5py.File(path, "w") as f:
        write_solution(f.require_group("solution"), state.solution, sd)
        serialize.write_schedule(f.require_group("schedule"), state.schedule)
        serialize.write_config(f.require_group("run_config"),
                               state.run_config)
        if state.time_series:
            f["time_series"] = np.stack(state.time_series)
        else:
            f.create_dataset("time_series", shape=(0,),
                             dtype=TIME_SERIES_DTYPE)
    print(f"write checkpoint: {path}")
    return state


def write_diagnostics(state: State, sd: SolverData) -> State:
    import h5py
    count = state.schedule.num_times_performed("write_diagnostics")
    outdir = state.run_config.get_string("outdir")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              outdir)
    fields = diagnostic_fields(state.solution, sd)
    idxs = [(l, (i, j)) for (l, i, j) in sd.leaves]
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.solution.time)
        serialize.write_tree(f.require_group("vertices"), idxs,
                             list(sd.vertices))
        for name in ("sigma", "radial_velocity", "phi_velocity"):
            serialize.write_tree(f.require_group(name), idxs,
                                 list(fields[name]))
        f["position_of_mass1"] = fields["position_of_mass1"]
        f["position_of_mass2"] = fields["position_of_mass2"]
        serialize.write_config(f.require_group("run_config"),
                               state.run_config)
    print(f"write diagnostics: {path}")
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_diagnostics"))


def record_time_series(state: State, sd: SolverData) -> State:
    sample = time_series_sample(state.solution, sd)
    return replace(
        state,
        time_series=state.time_series + (sample,),
        schedule=state.schedule.mark_as_completed("record_time_series"))


def run_tasks(state: State, sd: SolverData) -> State:
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, sd)
    if state.schedule.is_due("record_time_series"):
        state = record_time_series(state, sd)
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state, sd)
    return state


def create_state(cfg, sd: SolverData) -> State:
    import h5py
    restart = cfg.get_string("restart")
    if not restart:
        return State(create_solution(cfg, sd),
                     driver.create_schedule(cfg, ["write_checkpoint",
                                                  "write_diagnostics",
                                                  "record_time_series"]),
                     (), cfg)
    with h5py.File(restart, "r") as f:
        solution = read_solution(f["solution"], sd)
        schedule = serialize.read_schedule(f["schedule"])
        ts = tuple(f["time_series"][()]) if "time_series" in f else ()
    return State(solution, schedule, ts, cfg)


def apply_regrid(solution: Solution, sd: SolverData, cfg):
    """Data-driven leaf-set rebuild for the flagship (beyond the reference,
    whose trees are static): flag on the density-gradient indicator,
    enforce 2:1 balance, remap the state by prolong/restrict, and rebuild
    the solver for the new layout. Conservation: the cell-average remap
    preserves total mass and momentum exactly on the uniform-area blocks
    (tested). Returns (solution, sd) — unchanged objects if the leaf set
    is stable."""
    from mara3_tpu.mesh import regrid as rg

    bs = cfg.get_int("block_size")
    depth = cfg.get_int("depth")
    u = np.asarray(solution.conserved)
    dxb = np.asarray(sd.geometry[2])
    indicator = rg.gradient_indicator(u, dxb)
    new_leaves = rg.propose_leaves(sd.leaves, indicator,
                                   refine_threshold=0.3,
                                   coarsen_threshold=0.05,
                                   max_level=depth)
    if tuple(new_leaves) == tuple(sd.leaves):
        return solution, sd
    remapped = rg.remap_blocks(sd.leaves, u, new_leaves)
    sd2 = create_solver_data(cfg, leaves=new_leaves)
    print(f"regrid: {len(sd.leaves)} -> {len(new_leaves)} blocks")
    return replace(solution, conserved=jnp.asarray(remapped)), sd2


def next_state(state: State, sd: SolverData) -> State:
    solution = next_solution(state.solution, sd)
    cfg = state.run_config
    schedule = mark_tasks(state.schedule, solution.time, [
        ("write_checkpoint", cfg.get_double("cpi") * 2 * math.pi),
        ("write_diagnostics", cfg.get_double("dfi") * 2 * math.pi),
        ("record_time_series", cfg.get_double("tsi") * 2 * math.pi)])
    return State(solution, schedule, state.time_series, cfg)


def _main_fast(cfg, sd: SolverData, state: State) -> int:
    """Driver loop over the fully-jitted step (schemes/binary_step.py),
    executed in lax.scan chunks: the loop syncs once per chunk and
    replays the drift-free schedule marking from the packed per-step info
    rows. Checkpoints/diagnostics fire at the first chunk boundary after
    coming due (bounded by the chunk span, << their cadence)."""
    import time as _time

    from mara3_tpu.schemes import binary_step

    scan_steps = binary_step.make_fast_scan(sd)
    IX = binary_step.INFO_INDEX
    dtype = jnp.asarray(sd.initial_conserved).dtype
    s = binary_step.solution_to_arrays(state.solution, dtype)
    schedule, ts = state.schedule, state.time_series
    num_zones = (s["conserved"].shape[0] * s["conserved"].shape[1]
                 * s["conserved"].shape[2])
    tfinal_t = cfg.get_double("tfinal") * 2 * math.pi
    intervals = [
        ("write_checkpoint", cfg.get_double("cpi") * 2 * math.pi),
        ("write_diagnostics", cfg.get_double("dfi") * 2 * math.pi),
        ("record_time_series", cfg.get_double("tsi") * 2 * math.pi)]

    retry_step = None                      # built lazily (faults are rare)

    CHUNKS = (256, 64, 16, 4, 1)
    t_now = float(s["time"])
    t_f64 = float(state.solution.time)     # float64 time anchor
    dt_est = None
    regrid_on = cfg.get_int("regrid") != 0
    rgi_t = cfg.get_double("rgi") * 2 * math.pi
    next_regrid = t_now + rgi_t

    def repair(s_prev, rows):
        """A step in this chunk hit a negative density. The hot scan is
        retry-free, so rewind to the chunk head, replay the good steps,
        and run the faulted step through the retrying single-step (the
        reference's catch + dt/10 theta=0 path, subprog_binary.cpp:
        285-292)."""
        nonlocal retry_step
        if retry_step is None:
            retry_step = binary_step.make_fast_step(sd)
        bad = int(np.argmax(rows[:, IX["invalid"]] > 0))
        s2 = s_prev
        good = []
        left = bad
        while left > 0:
            c = next(cc for cc in CHUNKS if cc <= left)
            s2, r2 = scan_steps(s2, c)
            good.append(np.asarray(r2))
            left -= c
        s2, info = retry_step(s2)
        if bool(info["invalid"]):
            raise NegativeDensityError(
                "negative density persisted through safe-mode retry")
        print("negative density: step retried in safe mode (dt/10, "
              "theta=0)")
        good.append(binary_step.pack_info_host(
            {k: np.asarray(v) for k, v in info.items()})[None])
        return s2, np.concatenate(good, axis=0)

    while t_now < tfinal_t:
        if regrid_on and t_now >= next_regrid:
            sol2, sd2 = apply_regrid(
                binary_step.arrays_to_solution(s, Solution), sd, cfg)
            if sd2 is not sd:
                sd = sd2
                scan_steps = binary_step.make_fast_scan(sd)
                retry_step = None
                num_zones = (len(sd.leaves)
                             * sd.geometry[0].shape[1] ** 2)
                s = binary_step.solution_to_arrays(sol2, dtype)
            next_regrid += rgi_t
        if dt_est is None:
            n = 1          # learn dt (and compile the step) first
        else:
            remaining = max(1, int((tfinal_t - t_now) / dt_est) + 1)
            n_cap = max(1, int((next_regrid - t_now) / dt_est) + 1) \
                if regrid_on else remaining
            # stop the chunk just short of the predicted time-series due
            # so the due lands in the first steps of the NEXT chunk and
            # the state replay for the sample stays ~free
            tsi_t = cfg.get_double("tsi") * 2 * math.pi
            next_ts = schedule.last_performed("record_time_series") \
                + tsi_t
            if t_now < next_ts:
                to_due = max(1, int((next_ts - t_now) / dt_est) - 1)
                n_cap = min(n_cap, to_due)
            remaining = min(remaining, n_cap)
            n = next(c for c in CHUNKS if c <= remaining)

        t0 = _time.perf_counter()
        s_prev = s
        s, rows = scan_steps(s, n)
        rows = np.asarray(rows)            # the chunk's single device sync
        ms = (_time.perf_counter() - t0) * 1e3

        if rows[:, IX["invalid"]].any():
            s, rows = repair(s_prev, rows)

        # long-run time accuracy in f32 runs: the scan accumulates time
        # in the run dtype; re-anchor it each chunk from a float64 host
        # accumulation of the dt actually used (the reference carries time
        # in double)
        t_f64 += float(rows[:, IX["dt"]].astype(np.float64).sum())
        if s["time"].dtype == np.float32:
            s = {**s, "time": jnp.asarray(t_f64, s["time"].dtype)}

        due_steps = []
        for i, row in enumerate(rows):
            schedule = mark_tasks(schedule, float(row[IX["time"]]),
                                  intervals)
            if schedule.is_due("record_time_series"):
                due_steps.append(i)
                schedule = schedule.mark_as_completed("record_time_series")
        # sample the full STATE at each due step (the reference's
        # record_time_series runs on the current solution,
        # subprog_binary.cpp:358-378): the last step's state is `s`;
        # earlier dues replay deterministically from the chunk head. The
        # planner below caps chunks just short of a predicted due so the
        # replay is almost always 0-3 steps.
        if due_steps:
            s_cursor, done = s_prev, 0
            for i in due_steps:
                if i == len(rows) - 1:
                    sol_due = binary_step.arrays_to_solution(s, Solution)
                else:
                    left = i + 1 - done
                    while left > 0:
                        c = next(cc for cc in CHUNKS if cc <= left)
                        s_cursor, _ = scan_steps(s_cursor, c)
                        left -= c
                        done += c
                    sol_due = binary_step.arrays_to_solution(s_cursor,
                                                             Solution)
                ts = ts + (time_series_sample(sol_due, sd),)

        if schedule.is_due("write_diagnostics") or \
                schedule.is_due("write_checkpoint"):
            st = State(binary_step.arrays_to_solution(s, Solution),
                       schedule, ts, cfg)
            st = run_tasks(st, sd)
            schedule, ts = st.schedule, st.time_series

        t_now = float(rows[-1, IX["time"]])
        dt_est = float(rows[:, IX["dt"]].min())
        print(f"[{int(rows[-1, IX['iteration']]):04d}] "
              f"orbits={t_now / (2 * math.pi):3.7f} "
              f"kzps={n * num_zones / max(ms, 1e-12):3.2f}")

    state = State(binary_step.arrays_to_solution(s, Solution),
                  schedule, ts, cfg)
    run_tasks(state, sd)
    return 0


@register("binary")
def main(argv) -> int:
    import os
    cfg = driver.create_run_config(create_config_template(), argv)
    sd = create_solver_data(cfg)
    state = create_state(cfg, sd)
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    cfg.pretty_print()
    bs = cfg.get_int("block_size")
    print(f"quadtree: {len(sd.leaves)} blocks of {bs}x{bs}, "
          f"depth {tree.tree_depth(sd.leaves)}")

    state = run_tasks(state, sd)

    if driver.use_fast_driver(cfg):
        return _main_fast(cfg, sd, state)

    from mara3_tpu.app.performance import time_execution
    regrid_on = cfg.get_int("regrid") != 0
    rgi_t = cfg.get_double("rgi") * 2 * math.pi
    next_regrid = state.solution.time + rgi_t
    while state.solution.time / (2 * math.pi) < cfg.get_double("tfinal"):
        if regrid_on and state.solution.time >= next_regrid:
            sol2, sd = apply_regrid(state.solution, sd, cfg)
            state = State(sol2, state.schedule, state.time_series, cfg)
            next_regrid += rgi_t
        num_zones = len(sd.leaves) * bs * bs
        state, perf = time_execution(
            lambda s: run_tasks(next_state(s, sd), sd), state)
        rate = num_zones / max(perf.execution_time_ms, 1e-12)
        print(f"[{state.solution.iteration:04d}] "
              f"orbits={state.solution.time / (2 * math.pi):3.7f} "
              f"kzps={rate:3.2f}")

    run_tasks(next_state(state, sd), sd)
    return 0
