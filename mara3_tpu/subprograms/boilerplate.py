"""1D scalar advection on a periodic uniform grid — the template workload.

Re-design of src/subprog_boilerplate.cpp:40-300: sin(2*pi*x) advected at
unit speed with an upwind flux, fixed dt = 0.25/N, checkpoints every `cpi`
time units, full restart support. This is the smallest end-to-end exercise
of the config/schedule/serialize/driver stack.

Design: the update is a jit-compiled pure function of (u, dx, dt); the
reference's lazy pipeline (subprog_boilerplate.cpp:121-136) traces into one
fused XLA kernel. The reference prints its MPI process count at startup
(subprog_boilerplate.cpp:268-276); here that is the jax distributed process
count.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.app import driver
from mara3_tpu.app.config import ConfigTemplate
from mara3_tpu.app.schedule import Schedule, mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.core import ops


def config_template():
    return (ConfigTemplate()
            .item("restart", "")
            .item("cpi", 1.0)
            .item("tfinal", 1.0)
            .item("N", 256)
            .item("outdir", "."))


@dataclass(frozen=True)
class SolutionState:
    time: float
    iteration: int
    vertices: jax.Array
    solution: jax.Array


@dataclass(frozen=True)
class AppState:
    solution_state: SolutionState
    schedule: Schedule
    run_config: object


def new_solution(cfg) -> SolutionState:
    nx = cfg.get_int("N")
    xv = ops.linspace_verts(0.0, 1.0, nx)
    xc = ops.midpoint_on_axis(xv)
    return SolutionState(0.0, 0, xv, jnp.sin(2 * jnp.pi * xc))


def read_solution(group) -> SolutionState:
    return SolutionState(
        time=float(group["time"][()]),
        iteration=int(group["iteration"][()]),
        vertices=jnp.asarray(group["vertices"][()]),
        solution=jnp.asarray(group["solution"][()]))


def write_solution(group, s: SolutionState):
    group["time"] = np.float64(s.time)
    group["iteration"] = np.int32(s.iteration)
    group["vertices"] = np.asarray(s.vertices)
    group["solution"] = np.asarray(s.solution)


def create_solution(cfg) -> SolutionState:
    import h5py
    restart = cfg.get_string("restart")
    if restart:
        with h5py.File(restart, "r") as f:
            return read_solution(f["solution"])
    return new_solution(cfg)


@partial(jax.jit, static_argnames=("nx",))
def _advance(u0, xv, nx: int):
    """Upwind update u1 = u0 - dt/dx * (f[i+1] - f[i]), f = u upstream
    (reference next_solution, subprog_boilerplate.cpp:121-136)."""
    dt = 0.25 / nx
    dx = ops.difference_on_axis(xv)
    ue = ops.extend_periodic_on_axis(u0, 1)
    fc = ue[: nx + 1]
    lc = ops.difference_on_axis(fc) / dx
    return u0 - lc * dt


def next_solution(state: SolutionState) -> SolutionState:
    nx = state.solution.shape[0]
    u1 = _advance(state.solution, state.vertices, nx)
    return replace(state, time=state.time + 0.25 / nx,
                   iteration=state.iteration + 1, solution=u1)


def write_checkpoint(state: AppState) -> AppState:
    # complete the task *before* writing so the checkpoint stores the
    # post-completion count and restarts continue numbering without
    # overwriting (the reference flagship's ordering,
    # subprog_binary.cpp:331-341)
    count = state.schedule.num_times_performed("write_checkpoint")
    next_state = replace(
        state, schedule=state.schedule.mark_as_completed("write_checkpoint"))
    path = driver.checkpoint_path(state.run_config, count)
    driver.write_checkpoint_groups(
        path, next_state.run_config, next_state.schedule,
        lambda g: write_solution(g, next_state.solution_state))
    return next_state


def run_tasks(state: AppState) -> AppState:
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state)
    return state


def next_state(state: AppState) -> AppState:
    solution = next_solution(state.solution_state)
    schedule = mark_tasks(state.schedule, solution.time,
                          [("write_checkpoint", state.run_config.get_double("cpi"))])
    return AppState(solution, schedule, state.run_config)


@register("boilerplate")
def main(argv) -> int:
    print(f"initialized on {jax.process_count()} processes, "
          f"{jax.local_device_count()} local devices")

    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()

    state = AppState(create_solution(cfg),
                     driver.create_schedule(cfg, ["write_checkpoint"]), cfg)
    state = run_tasks(state)

    state = driver.run_loop(
        state,
        should_continue=lambda s: s.solution_state.time < cfg.get_double("tfinal"),
        step=lambda s: run_tasks(next_state(s)),
        zones_of=lambda s: s.solution_state.solution.shape[0],
        iteration_of=lambda s: s.solution_state.iteration,
        time_of=lambda s: s.solution_state.time)

    run_tasks(next_state(state))
    return 0
