"""Fully-jitted flagship step: CFL + RK stages + two-body bookkeeping +
safe-mode retry as ONE XLA program.

The host path (subprograms/binary.py::next_solution) round-trips
device->host once per RK stage to run the scalar orbital-element
bookkeeping. Here the whole step — the reference's next_solution + advance_u orbital updates
(subprog_binary.cpp:258-292, subprog_binary_scheme.cpp:790-1020) —
compiles into one program using the traced two-body module
(models/two_body_jax.py), and the negative-density safe-mode retry
(dt/10, theta=0; subprog_binary.cpp:285-292) becomes a lax.cond instead
of a caught exception.

State crosses the step as a flat dict-of-arrays pytree; converters to and
from the host Solution dataclass live here. Equivalence with the host
path is tested in tests/test_binary_fast_step.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mara3_tpu.models import two_body_jax as tbj


def solution_to_arrays(sol, dtype):
    """State pytree for the fast step (conserved stays [B, bs, bs, C])."""
    f = lambda v: jnp.asarray(v, dtype)
    return {
        "time": f(sol.time),
        "iteration": jnp.asarray(sol.iteration, jnp.int32),
        "conserved": f(sol.conserved),
        "mass_accreted_on": f(sol.mass_accreted_on),
        "angular_momentum_accreted_on": f(sol.angular_momentum_accreted_on),
        "integrated_torque_on": f(sol.integrated_torque_on),
        "work_done_on": f(sol.work_done_on),
        "mass_ejected": f(sol.mass_ejected),
        "angular_momentum_ejected": f(sol.angular_momentum_ejected),
        "oe_acc": tbj.pack_elements(sol.orbital_elements_acc, dtype),
        "oe_grav": tbj.pack_elements(sol.orbital_elements_grav, dtype),
        "oe": tbj.pack_elements(sol.orbital_elements, dtype),
    }


def arrays_to_solution(s, sol_cls):
    t2 = lambda a: (float(a[0]), float(a[1]))
    return sol_cls(
        time=float(s["time"]),
        iteration=int(s["iteration"]),
        conserved=s["conserved"],
        mass_accreted_on=t2(s["mass_accreted_on"]),
        angular_momentum_accreted_on=t2(s["angular_momentum_accreted_on"]),
        integrated_torque_on=t2(s["integrated_torque_on"]),
        work_done_on=t2(s["work_done_on"]),
        mass_ejected=float(s["mass_ejected"]),
        angular_momentum_ejected=float(s["angular_momentum_ejected"]),
        orbital_elements_acc=tbj.unpack_elements(s["oe_acc"]),
        orbital_elements_grav=tbj.unpack_elements(s["oe_grav"]),
        orbital_elements=tbj.unpack_elements(s["oe"]))


def make_fast_step(sd, retry=True):
    """step(arrays) -> (arrays, info) where info = dict(dt, retried,
    invalid, disk_mass, disk_angular_momentum) of scalars. `sd` is the
    SolverData from subprograms/binary.py.

    retry=False omits the in-graph safe-mode lax.cond: the driver's hot
    scan runs retry-free and repairs faulted chunks host-side (rewind to
    the chunk head, replay the good steps, run the single faulted step
    through the retrying variant), so the common path carries no
    conditional."""
    adv = sd.advance.traced
    xc = jnp.asarray(sd.geometry[0])
    dA = jnp.asarray(sd.geometry[1])
    cfl = sd.cfl_number
    rec_dt = sd.recommended_time_step
    theta0 = sd.plm_theta
    live_after = sd.begin_live_binary
    no_acc_force = sd.no_accretion_force
    conserve_p = sd.conserve_linear_p
    rk_order = sd.rk_order
    fixed_dt = sd.fixed_dt

    def stage(s, dt, theta):
        """One advance + orbital-element bookkeeping (the traced analog of
        subprograms/binary.py::advance)."""
        bodies = tbj.compute_two_body_state(s["oe"], s["time"])
        u1, t, invalid = adv(s["conserved"], bodies, dt, theta)

        dM = t["mass_accreted_on"]
        dpx = t["momentum_x_accreted_on"]
        dpy = t["momentum_y_accreted_on"]
        m, vx, vy = bodies[:, 0], bodies[:, 3], bodies[:, 4]
        if no_acc_force:
            avx, avy = vx, vy
        else:
            avx = (m * vx + dpx) / (m + dM)
            avy = (m * vy + dpy) / (m + dM)
        acc_bodies = jnp.stack(
            [m + dM, bodies[:, 1], bodies[:, 2], avx, avy], axis=1)
        grv_bodies = jnp.stack(
            [m, bodies[:, 1], bodies[:, 2],
             vx + t["integrated_force_x_on"] / m,
             vy + t["integrated_force_y_on"] / m], axis=1)

        # one vmapped inversion for both perturbed body sets (elementwise
        # formulas only, so bitwise-identical to two separate calls)
        E0 = s["oe"]
        both = jnp.stack([acc_bodies, grv_bodies])
        e_both = jax.vmap(tbj.compute_orbital_elements,
                          in_axes=(0, None))(both, s["time"])
        d_both = jax.vmap(tbj.diff, in_axes=(None, 0))(E0, e_both)
        d_acc, d_grv = d_both[0], d_both[1]
        d_cm = tbj.diff_cm(E0, dt)
        live = jnp.where(s["time"] > live_after, 1.0, 0.0).astype(E0.dtype)

        s1 = {
            "time": s["time"] + dt,
            "iteration": s["iteration"] + 1,
            "conserved": u1,
            "mass_accreted_on": s["mass_accreted_on"]
                + t["mass_accreted_on"],
            "angular_momentum_accreted_on":
                s["angular_momentum_accreted_on"]
                + t["angular_momentum_accreted_on"],
            "integrated_torque_on": s["integrated_torque_on"]
                + t["integrated_torque_on"],
            "work_done_on": s["work_done_on"] + t["work_done_on"],
            "mass_ejected": s["mass_ejected"] + t["mass_ejected"],
            "angular_momentum_ejected": s["angular_momentum_ejected"]
                + t["angular_momentum_ejected"],
            "oe_acc": s["oe_acc"] + d_acc,
            "oe_grav": s["oe_grav"] + d_grv,
            "oe": E0 + (d_acc + d_grv + d_cm) * live,
        }
        return s1, invalid

    def do_step(s, dt, theta):
        """RK1/RK2 composition (subprog_binary.cpp:258-283; the RK2 average
        is Solution.scaled_plus with weights 1/2, 1/2)."""
        s1, i1 = stage(s, dt, theta)
        if rk_order == 1:
            return s1, i1
        s2, i2 = stage(s1, dt, theta)

        def avg(a, b):
            if a.dtype == jnp.int32:
                return (a + b) // 2
            return 0.5 * a + 0.5 * b

        return jax.tree.map(avg, s, s2), jnp.logical_or(i1, i2)

    def step_impl(s):
        if fixed_dt:
            dt = jnp.asarray(rec_dt, s["time"].dtype)
        else:
            bodies = tbj.compute_two_body_state(s["oe"], s["time"])
            dt = cfl * sd.maximum_timestep(s["conserved"], bodies)

        theta_t = jnp.asarray(theta0, dt.dtype)
        s1, inv = do_step(s, dt, theta_t)

        if retry:
            # safe-mode retry in-graph: recompute the whole step at dt/10
            # with first-order reconstruction when any stage saw a negative
            # density
            def do_retry(_):
                s_safe, inv_safe = do_step(s, dt * 0.1,
                                           jnp.zeros_like(theta_t))
                return s_safe, inv_safe, dt * 0.1

            def keep(_):
                return s1, jnp.zeros_like(inv), dt

            s_out, invalid, dt_used = jax.lax.cond(inv, do_retry, keep,
                                                   None)
        else:
            s_out, invalid, dt_used = s1, inv, dt
        u_out = s_out["conserved"]
        if conserve_p:
            lz = xc[..., 0] * u_out[..., 2] - xc[..., 1] * u_out[..., 1]
        else:
            lz = u_out[..., 2]
        info = {
            "dt": dt_used,
            "retried": inv,
            "invalid": invalid,
            "disk_mass": jnp.sum(u_out[..., 0] * dA),
            "disk_angular_momentum": jnp.sum(lz * dA),
        }
        # everything but the conserved field rides along per step so the
        # driver can rebuild time-series rows without extra device syncs
        info.update({k: v for k, v in s_out.items() if k != "conserved"})
        return s_out, info

    jitted = jax.jit(step_impl)

    def step(s):
        return jitted(s)

    step.traced = step_impl
    return step


# packed per-step info layout for the chunked driver loop: one flat row per
# step so a whole chunk reads back as a SINGLE device->host transfer.
#
# LEAN by design: the reference samples its time series only
# when the record_time_series task is due (subprog_binary.cpp:358-378),
# so per-step rows carry just what the driver loop itself needs — task
# marking (time), the f64 time anchor (dt), and fault location
# (invalid). At a due the driver replays to the due step and samples the
# full STATE (subprograms/binary._main_fast), which keeps the disk
# reductions out of the scan and is closer to the reference's
# record-at-due semantics.
_INFO_LAYOUT = [
    ("time", 1), ("iteration", 1), ("dt", 1), ("retried", 1),
    ("invalid", 1),
]
INFO_INDEX = {}
_off = 0
for _name, _w in _INFO_LAYOUT:
    INFO_INDEX[_name] = slice(_off, _off + _w) if _w > 1 else _off
    _off += _w
INFO_WIDTH = _off


def _pack_info(info):
    # f64 rows when x64 is live (CPU tests); f32 otherwise — asking for
    # f64 without x64 only truncates with a warning per trace
    ft = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    parts = []
    for name, w in _INFO_LAYOUT:
        v = jnp.asarray(info[name], ft).reshape(-1)
        parts.append(v)
    return jnp.concatenate(parts)


def pack_info_host(info):
    """Host-side equivalent of _pack_info for a single step's info dict."""
    import numpy as np
    parts = []
    for name, w in _INFO_LAYOUT:
        parts.append(np.asarray(info[name], np.float64).reshape(-1))
    return np.concatenate(parts)


def make_fast_scan(sd):
    """scan_steps(s, n) -> (s, rows [n, INFO_WIDTH]): n fully-jitted steps
    as one XLA program with the per-step info packed into one array. One
    device sync per *chunk* instead of per step; the driver loop replays
    schedule marking host-side from the packed rows. The scan body is
    retry-FREE; the driver repairs faulted chunks by rewinding (see
    subprograms/binary._main_fast)."""
    from functools import partial

    step = make_fast_step(sd, retry=False)

    @partial(jax.jit, static_argnames=("n",))
    def scan_steps(s, n: int):
        def body(s, _):
            s1, info = step.traced(s)
            # one packed [INFO_WIDTH] row per step: lax.scan stacks each
            # output leaf separately, so one leaf is one stacking op
            return s1, _pack_info(info)

        return jax.lax.scan(body, s, length=n)

    return scan_steps
