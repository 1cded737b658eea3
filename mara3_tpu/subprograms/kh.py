"""Kelvin-Helmholtz shear layer: 2D isothermal gas on a uniform doubly-
periodic grid.

Beyond-reference subprogram (the reference ships only empty uniform-grid
examples, examples/advect_2d.cpp:35-38): same physics and hot-path formulas
as the flagship binary scheme (PLM + HLLE iso2d Godunov update,
subprog_binary_scheme.cpp:268-343/568-612) on the one mesh the reference
never exercises them on — a plain uniform periodic box. The whole chunk of
steps between two scheduled outputs is one jitted fori_loop over the jnp
scheme (schemes/iso2d_grid.py); `shards=N` x-shards the grid over N
devices with ppermute halos (parallel/iso2d_sharded.py).

App plumbing matches the reference's subprogram contract: config template
with key=val CLI and checkpoint-restart merge (subprog_binary.cpp:155-164),
task schedule driving numbered chkpt/diagnostics files plus an extendable
chunked time_series.h5 (subprog_sedov.cpp:518-530, 600-614), kzps meter
(subprog_binary.cpp:394-404).

Setup: density band sigma1 inside |y - 1/2| < 1/4 (else sigma0) moving at
+mach*cs, the rest at -mach*cs, with a small sinusoidal vy seed at both
interfaces. dt is FIXED for the whole run (the reference's fixed_dt mode,
subprog_binary.cpp:67): computed once from the initial CFL condition and
stored in checkpoints so restarted runs are bit-identical to uninterrupted
ones.
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
from mara3_tpu.app.schedule import mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.schemes import iso2d_grid


def config_template():
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("N", 1024)            # square grid
            .item("cs", 1.0)            # isothermal sound speed
            .item("mach", 0.5)          # band speed / cs
            .item("sigma0", 1.0)        # outer band density
            .item("sigma1", 2.0)        # inner band density
            .item("pert", 0.01)         # vy seed amplitude
            .item("pert_k", 2)          # vy seed wavenumber (cycles/box)
            .item("plm_theta", 1.8)
            .item("riemann", "hlle")    # hlle | hllc
            .item("rk_order", 1)        # 2 = SSP-RK2
            # "" = JAX's default float type; f32 | bf16 | f64. bf16 is
            # the mixed-precision ceiling
            # trial (PRECISION.md protocol); checkpoints store f32
            # (HDF5 has no bf16) — exact both ways for bf16 values.
            .item("precision", "")
            .item("cfl", 0.3)
            .item("fixed_dt", 0.0)      # 0 -> cfl * dx / max wavespeed(IC)
            .item("tfinal", 2.0)
            .item("cpi", 0.5)           # checkpoint interval
            .item("dfi", 0.25)          # diagnostics interval
            .item("tsi", 0.05)          # time-series interval
            # multi-device: x-shard the grid over this many devices, the
            # jnp step under shard_map with ppermute halos
            # (parallel/iso2d_sharded.py). 0 = off, -1 = all local
            # devices.
            .item("shards", 0))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    dt: float                     # fixed for the run; checkpointed
    conserved: jax.Array          # [N, N, 3] = (sigma, sigma vx, sigma vy)


# -----------------------------------------------------------------------------
# initial condition + fixed dt
# -----------------------------------------------------------------------------

def initial_conserved(cfg):
    n = cfg.get_int("N")
    cs = cfg.get_double("cs")
    x = (jnp.arange(n, dtype=jnp.float64) + 0.5)[:, None] / n
    y = (jnp.arange(n, dtype=jnp.float64) + 0.5)[None, :] / n
    inner = jnp.abs(y - 0.5) < 0.25
    sigma = jnp.where(inner, cfg.get_double("sigma1"),
                      cfg.get_double("sigma0")) * jnp.ones_like(x * y)
    vx = jnp.where(inner, 1.0, -1.0) * cfg.get_double("mach") * cs
    vx = vx * jnp.ones_like(sigma)
    k = cfg.get_int("pert_k")
    # seed localized at the two interfaces y = 1/4, 3/4
    envelope = (jnp.exp(-((y - 0.25) / 0.05) ** 2)
                + jnp.exp(-((y - 0.75) / 0.05) ** 2))
    vy = cfg.get_double("pert") * cs * jnp.sin(2 * jnp.pi * k * x) * envelope
    u = jnp.stack([sigma, sigma * vx, sigma * vy], axis=-1)
    dtype = _dtype_from_cfg(cfg)
    return u if dtype is None else u.astype(dtype)


def _dtype_from_cfg(cfg):
    p = cfg.get_string("precision") if "precision" in cfg else ""
    if p == "":
        return None
    return {"f32": jnp.float32, "bf16": jnp.bfloat16,
            "f64": jnp.float64}[p]


def fixed_timestep(cfg, u0) -> float:
    dt = cfg.get_double("fixed_dt")
    if dt > 0.0:
        return dt
    n = cfg.get_int("N")
    cs2 = cfg.get_double("cs") ** 2
    P = np.asarray(jax.device_get(u0), dtype=np.float64)
    P = P.copy()
    P[..., 1] /= P[..., 0]
    P[..., 2] /= P[..., 0]
    amax = float(np.max(np.abs(P[..., 1:3])) + math.sqrt(cs2))
    return cfg.get_double("cfl") / n / amax


# -----------------------------------------------------------------------------
# advance
# -----------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cs2", "dx", "dy", "dt", "theta",
                                   "riemann", "rk_order"))
def advance_n(u, n, *, cs2: float, dx: float, dy: float, dt: float,
              theta: float, riemann: str = "hlle", rk_order: int = 1):
    """n PLM steps on [N, N, 3] (forward Euler, or SSP-RK2 when
    rk_order=2) as one fori_loop."""
    step = (iso2d_grid.step_periodic_uniform if rk_order == 1
            else iso2d_grid.step_periodic_uniform_rk2)

    def body(_, u):
        return step(u, cs2, dx, dy, dt, theta, riemann)
    return jax.lax.fori_loop(0, n, body, u)


def make_sharded_advance(cfg, dt: float):
    """Multi-device advance: x-shard over `shards` devices, the jnp step
    under shard_map with ppermute halo strips (the collective analog of
    the reference's isend/irecv guard exchange,
    subprog_binary_scheme.cpp:132-142). Returns (advance(u, n), mesh)
    with u the [N, N, 3] state."""
    from jax.sharding import Mesh
    from mara3_tpu.parallel import iso2d_sharded

    shards = cfg.get_int("shards")
    devices = jax.devices()
    ndev = len(devices) if shards < 0 else shards
    if ndev > len(devices):
        raise ValueError(f"shards={ndev} but only {len(devices)} devices")
    n = cfg.get_int("N")
    if n % ndev or n // ndev < iso2d_grid.GUARD:
        raise ValueError(f"N={n} does not split into {ndev} shards of at "
                         f"least {iso2d_grid.GUARD} rows")
    mesh = Mesh(np.array(devices[:ndev]), ("x",))
    adv = iso2d_sharded.make_advance_sharded(
        mesh, cs2=cfg.get_double("cs") ** 2, dx=1.0 / n, dy=1.0 / n, dt=dt,
        theta=cfg.get_double("plm_theta"),
        rk_order=cfg.get_int("rk_order"),
        riemann=cfg.get_string("riemann"))
    return adv, mesh


# -----------------------------------------------------------------------------
# outputs
# -----------------------------------------------------------------------------

TIME_SERIES_COLUMNS = ("time", "total_mass", "momentum_x", "momentum_y",
                       "kinetic_energy", "sigma_min", "sigma_max")


def compute_time_series_data(state: Solution, cfg):
    u = np.asarray(jax.device_get(state.conserved), dtype=np.float64)
    n = u.shape[0]
    da = (1.0 / n) ** 2
    sigma = u[..., 0]
    ke = 0.5 * (u[..., 1] ** 2 + u[..., 2] ** 2) / sigma
    return {
        "time": state.time,
        "total_mass": float(sigma.sum() * da),
        "momentum_x": float(u[..., 1].sum() * da),
        "momentum_y": float(u[..., 2].sum() * da),
        "kinetic_energy": float(ke.sum() * da),
        "sigma_min": float(sigma.min()),
        "sigma_max": float(sigma.max()),
    }


def vorticity(u, dx):
    """z-vorticity dvy/dx - dvx/dy by periodic central differences."""
    vx = u[..., 1] / u[..., 0]
    vy = u[..., 2] / u[..., 0]
    dvy_dx = (np.roll(vy, -1, axis=0) - np.roll(vy, 1, axis=0)) / (2 * dx)
    dvx_dy = (np.roll(vx, -1, axis=1) - np.roll(vx, 1, axis=1)) / (2 * dx)
    return dvy_dx - dvx_dy


def write_checkpoint(state: Solution, schedule, cfg):
    # complete the task *before* writing so the checkpoint stores the
    # post-completion count and restarts continue numbering without
    # overwriting (subprog_binary.cpp:331-341 ordering)
    count = schedule.num_times_performed("write_checkpoint")
    schedule = schedule.mark_as_completed("write_checkpoint")
    path = driver.checkpoint_path(cfg, count)

    def write_solution(group):
        group["iteration"] = np.int64(state.iteration)
        group["time"] = np.float64(state.time)
        group["dt"] = np.float64(state.dt)
        u = state.conserved
        if u.dtype == jnp.bfloat16:      # HDF5 has no bf16; f32 is exact
            u = u.astype(jnp.float32)
        group["conserved"] = np.asarray(u)

    driver.write_checkpoint_groups(path, cfg, schedule, write_solution)
    return schedule


def write_diagnostics(state: Solution, schedule, cfg):
    import h5py
    count = schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              cfg.get_string("outdir"))
    u = np.asarray(jax.device_get(state.conserved), dtype=np.float64)
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.time)
        f["sigma"] = u[..., 0]
        f["vorticity"] = vorticity(u, 1.0 / u.shape[0])
    print(f"write diagnostics: {path}")
    return schedule.mark_as_completed("write_diagnostics")


def write_time_series(state: Solution, schedule, cfg):
    import h5py
    outdir = cfg.get_string("outdir")
    path = (f"{outdir}/time_series.h5" if outdir not in (".", "")
            else "time_series.h5")
    row = schedule.num_times_performed("write_time_series")
    data = compute_time_series_data(state, cfg)
    with h5py.File(path, "r+") as f:
        for name, value in data.items():
            ds = f[name]
            ds.resize((row + 1,))
            ds[row] = value
    return schedule.mark_as_completed("write_time_series")


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
        for name in TIME_SERIES_COLUMNS:
            f.create_dataset(name, shape=(0,), maxshape=(None,),
                             chunks=(1000,), dtype="f8")
        serialize.write_config(f.require_group("run_config"), cfg)


TASKS = ("write_checkpoint", "write_diagnostics", "write_time_series")


def run_tasks(state: Solution, schedule, cfg):
    if schedule.is_due("write_checkpoint"):
        schedule = write_checkpoint(state, schedule, cfg)
    if schedule.is_due("write_diagnostics"):
        schedule = write_diagnostics(state, schedule, cfg)
    if schedule.is_due("write_time_series"):
        schedule = write_time_series(state, schedule, cfg)
    return schedule


# -----------------------------------------------------------------------------
# driver
# -----------------------------------------------------------------------------

def create_state(cfg) -> Solution:
    import h5py
    restart = cfg.get_string("restart")
    if restart:
        with h5py.File(restart, "r") as f:
            g = f["solution"]
            u = jnp.asarray(g["conserved"][()])
            dtype = _dtype_from_cfg(cfg)
            if dtype is not None:
                u = u.astype(dtype)
            return Solution(int(g["iteration"][()]),
                            float(g["time"][()]),
                            float(g["dt"][()]), u)
    u0 = initial_conserved(cfg)
    return Solution(0, 0.0, fixed_timestep(cfg, u0), u0)


@register("kh")
def main(argv) -> int:
    import time as _time
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    prepare_filesystem(cfg)

    state = create_state(cfg)
    schedule = driver.create_schedule(cfg, list(TASKS))

    n = cfg.get_int("N")
    kw = dict(cs2=cfg.get_double("cs") ** 2, dx=1.0 / n, dy=1.0 / n,
              dt=state.dt, theta=cfg.get_double("plm_theta"),
              riemann=cfg.get_string("riemann"),
              rk_order=cfg.get_int("rk_order"))
    advance = partial(advance_n, **kw)

    if cfg.get_int("shards") != 0:
        from mara3_tpu.parallel import iso2d_sharded
        advance, mesh = make_sharded_advance(cfg, state.dt)
        state = replace(state, conserved=iso2d_sharded.shard_state(
            state.conserved, mesh))
        print(f"kh: x-sharded over {mesh.shape['x']} devices "
              f"(ppermute halos)")
    intervals = [("write_checkpoint", cfg.get_double("cpi")),
                 ("write_diagnostics", cfg.get_double("dfi")),
                 ("write_time_series", cfg.get_double("tsi"))]

    eps = 1e-12
    tfinal = cfg.get_double("tfinal")
    while state.time < tfinal - eps:
        schedule = run_tasks(state, schedule, cfg)
        # plan the chunk to land exactly on the next scheduled output (or
        # tfinal): the whole chunk is one dispatch
        n_run = max(1, int(math.ceil((tfinal - state.time) / state.dt
                                     - eps)))
        for name, interval in intervals:
            due = schedule.last_performed(name) + interval
            if due > state.time + eps:
                n_run = min(n_run, max(1, int(math.ceil(
                    (due - state.time) / state.dt - eps))))
        t0 = _time.perf_counter()
        u1 = advance(state.conserved, n_run)
        jax.block_until_ready(u1)
        ms = (_time.perf_counter() - t0) * 1e3
        state = replace(state, iteration=state.iteration + n_run,
                        time=state.time + n_run * state.dt, conserved=u1)
        schedule = mark_tasks(schedule, state.time, intervals)
        print(f"[{state.iteration:04d}] t={state.time:3.7f} "
              f"kzps={n_run * n * n / max(ms, 1e-9):3.2f}")

    schedule = run_tasks(state, schedule, cfg)
    return 0
