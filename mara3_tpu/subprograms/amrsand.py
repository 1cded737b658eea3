"""AMR sandbox: quadtree advection of a Gaussian blob at v = (0.5, 0.5).

Re-design of src/subprog_amrsand.cpp:49-369: builds a static quadtree with
refinement predicate `centroid_radius < 1/level` up to `depth`, advects a
Gaussian with first-order upwind fluxes, writes per-block diagnostics trees
with "level:i-j" keys. Exercises the full AMR mechanics — tree build, 2:1
balance, guard exchange with on-the-fly prolong/restrict — without physics
complexity.

Layout: leaves live in one dense [B, bs, bs, 1] array in Hilbert order;
the per-step extend+flux+update is one jit program of masked gathers
(mesh/block_layout.py) — the reference fans get_cell_block recursion over a
thread pool instead (core_tree.hpp:615-639).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.app import driver, serialize
from mara3_tpu.app.config import ConfigTemplate
from mara3_tpu.app.schedule import mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.mesh import block_layout, tree


def config_template():
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("dfi", 1.0)
            .item("tfinal", 1.0)
            .item("block_size", 16)
            .item("depth", 4)
            # adaptive regridding (beyond the reference, whose trees are
            # static): rebuild the mesh from the solution gradient every
            # `rgi` time units when `regrid=1`
            .item("regrid", 0)
            # chunked driver loop (-1 = auto, on when the backend is not
            # the CPU; 0 = per-step, 1 = on)
            .item("fast_step", -1)
            .item("rgi", 0.1)
            .item("refine_threshold", 0.3)
            .item("coarsen_threshold", 0.05))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    leaves: tuple                 # static quadtree (Hilbert-ordered)
    conserved: jax.Array          # [B, bs, bs, 1]


def build_tree(cfg):
    return tuple(tree.create_quadtree(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth")))


def new_solution(cfg) -> Solution:
    bs = cfg.get_int("block_size")
    leaves = build_tree(cfg)
    xc = block_layout.block_cell_centers(leaves, bs)
    u = np.exp(-(xc[..., 0] ** 2 + xc[..., 1] ** 2) / 0.025)
    return Solution(0, 0.0, leaves, jnp.asarray(u[..., None]))


@partial(jax.jit, static_argnames=("dt",))
def _advance(u0, dxb, nt_arrays, dt: float):
    """One upwind step over all blocks (subprog_amrsand.cpp:243-300):
    f = 0.5 * u_upwind per axis, u1 = u0 - dt * (dfx + dfy) / dx."""
    nt = block_layout.NeighborTable(*nt_arrays)

    ue = block_layout.extend_blocks(u0, nt, axis=0, g=1)
    fx = 0.5 * ue[:, : u0.shape[1] + 1]          # upwind (v > 0)
    lx = fx[:, 1:] - fx[:, :-1]

    ue = block_layout.extend_blocks(u0, nt, axis=1, g=1)
    fy = 0.5 * ue[:, :, : u0.shape[2] + 1]
    ly = fy[:, :, 1:] - fy[:, :, :-1]

    return u0 - (lx + ly) * dt / dxb[:, None, None, None]


@partial(jax.jit, static_argnames=("dt",))
def _advance_loop(u0, dxb, nt_arrays, dt: float, num_steps):
    return jax.lax.fori_loop(
        0, num_steps, lambda _, u: _advance(u, dxb, nt_arrays, dt), u0)


def advance_n(u0, dxb, nt, dt: float, num_steps: int):
    """num_steps upwind steps as one dispatch (a jitted fori_loop)."""
    nt_arrays = (nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                 nt.fine_id)
    return _advance_loop(u0, dxb, nt_arrays, dt, num_steps)


def next_solution(state: Solution, nt, dxb) -> Solution:
    bs = state.conserved.shape[1]
    depth = tree.tree_depth(state.leaves)
    dt = 2.0 / bs / (1 << depth)   # subprog_amrsand.cpp:244-245
    u1 = advance_n(state.conserved, dxb, nt, dt, 1)
    return replace(state, iteration=state.iteration + 1,
                   time=state.time + dt, conserved=u1)


# -----------------------------------------------------------------------------
# diagnostics (per-block trees with "level:i-j" keys)
# -----------------------------------------------------------------------------

def write_diagnostics(state: Solution, schedule, cfg):
    import h5py
    count = schedule.num_times_performed("write_diagnostics")
    outdir = cfg.get_string("outdir")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              outdir)
    bs = state.conserved.shape[1]
    verts = block_layout.block_vertices(state.leaves, bs)
    idxs = [(l, (i, j)) for (l, i, j) in state.leaves]
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.time)
        serialize.write_tree(f.require_group("vertices"), idxs, list(verts))
        serialize.write_tree(f.require_group("conserved"), idxs,
                             list(np.asarray(state.conserved[..., 0])))
    print(f"write diagnostics: {path}")
    return schedule.mark_as_completed("write_diagnostics")


def apply_regrid(state: Solution, cfg):
    """One adaptive regrid cycle (mesh/regrid.py); returns the new state
    plus rebuilt neighbor table and spacings."""
    from mara3_tpu.mesh import regrid as rg
    bs = state.conserved.shape[1]
    dxb_np = block_layout.block_dx(state.leaves, bs)
    new_leaves, new_blocks, changed = rg.regrid(
        state.leaves, np.asarray(state.conserved), dxb_np,
        refine_threshold=cfg.get_double("refine_threshold"),
        coarsen_threshold=cfg.get_double("coarsen_threshold"),
        max_level=cfg.get_int("depth"))
    if changed:
        state = replace(state, leaves=tuple(new_leaves),
                        conserved=jnp.asarray(new_blocks))
        print(f"regrid: {len(new_leaves)} blocks, "
              f"depth {tree.tree_depth(new_leaves)}")
    nt = block_layout.build_neighbor_table(state.leaves)
    dxb = jnp.asarray(block_layout.block_dx(state.leaves, bs))
    return state, nt, dxb


@register("amrsand")
def main(argv) -> int:
    import os
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)

    state = new_solution(cfg)
    bs = cfg.get_int("block_size")
    nt = block_layout.build_neighbor_table(state.leaves)
    dxb = jnp.asarray(block_layout.block_dx(state.leaves, bs))
    print(f"quadtree: {state.conserved.shape[0]} blocks of {bs}x{bs}, "
          f"depth {tree.tree_depth(state.leaves)}")

    adaptive = cfg.get_int("regrid") != 0
    rgi = cfg.get_double("rgi")
    next_regrid = rgi

    schedule = driver.create_schedule(cfg, ["write_diagnostics"])

    if driver.use_fast_driver(cfg):
        # chunked driver (cloud/sedov _main_fast rationale): dt is static
        # per layout, so each dispatch is ONE advance_n call planned to
        # land exactly on the next diagnostics due or regrid event
        import math as _math
        import time as _time
        eps = 1e-12
        CHUNKS = (256, 64, 16, 4, 1)
        tfinal = cfg.get_double("tfinal")
        dfi = cfg.get_double("dfi")
        while state.time < tfinal - eps:
            if schedule.is_due("write_diagnostics"):
                schedule = write_diagnostics(state, schedule, cfg)
            if adaptive and state.time >= next_regrid:
                state, nt, dxb = apply_regrid(state, cfg)
                next_regrid += rgi
            depth = tree.tree_depth(state.leaves)
            dt = 2.0 / bs / (1 << depth)
            n_cap = max(1, int(_math.ceil((tfinal - state.time) / dt
                                          - eps)))
            nxt = schedule.last_performed("write_diagnostics") + dfi
            if nxt > state.time + eps:
                n_cap = min(n_cap, max(1, int(_math.ceil(
                    (nxt - state.time) / dt - eps))))
            if adaptive and next_regrid > state.time + eps:
                n_cap = min(n_cap, max(1, int(_math.ceil(
                    (next_regrid - state.time) / dt - eps))))
            n = next(c for c in CHUNKS if c <= n_cap)
            t0 = _time.perf_counter()
            u1 = advance_n(state.conserved, dxb, nt, dt, n)
            jax.block_until_ready(u1)
            ms = (_time.perf_counter() - t0) * 1e3
            state = replace(state, iteration=state.iteration + n,
                            time=state.time + n * dt, conserved=u1)
            schedule = mark_tasks(schedule, state.time,
                                  [("write_diagnostics", dfi)])
            num_zones = state.conserved.shape[0] * bs * bs
            print(f"[{state.iteration:04d}] t={state.time:3.7f} "
                  f"kzps={n * num_zones / max(ms, 1e-9):3.2f}")
        if schedule.is_due("write_diagnostics"):
            schedule = write_diagnostics(state, schedule, cfg)
        return 0

    from mara3_tpu.app.performance import time_execution
    while state.time < cfg.get_double("tfinal"):
        if schedule.is_due("write_diagnostics"):
            schedule = write_diagnostics(state, schedule, cfg)
        if adaptive and state.time >= next_regrid:
            state, nt, dxb = apply_regrid(state, cfg)
            next_regrid += rgi
        state, perf = time_execution(next_solution, state, nt, dxb)
        schedule = mark_tasks(schedule, state.time,
                              [("write_diagnostics", cfg.get_double("dfi"))])
        if state.iteration % 50 == 0:
            num_zones = state.conserved.shape[0] * bs * bs
            driver.print_run_loop_message(state.iteration, state.time,
                                          num_zones, perf)
    if schedule.is_due("write_diagnostics"):
        schedule = write_diagnostics(state, schedule, cfg)
    return 0
