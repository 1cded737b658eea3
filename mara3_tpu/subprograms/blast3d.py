"""3D Euler point explosion on the AMR octree (beyond-reference).

The rank-3, real-hydro sibling of `sand3d`: a Sedov-like central
overpressure on a centre-refined octree, advanced by mesh/euler3d.py —
HLLE fluxes through the six-face guard exchange with exactly
conservative coarse-fine flux correction — through the full app
framework (config, drift-free schedule, numbered diagnostics with
"level:i-j-k" tree keys, per-step kzps meters). Every reference
workload is 1D/2D (its sedov is spherically-symmetric 1D,
subprog_sedov.cpp); this exercises genuinely multi-dimensional
shock propagation across refinement boundaries.

CFL timesteps are recomputed from the global max wavespeed at every
inter-output window (one device reduction per window, the same chunked
dispatch design as sand3d)."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from mara3_tpu.app import driver, serialize
from mara3_tpu.app.config import ConfigTemplate
from mara3_tpu.app.schedule import mark_tasks
from mara3_tpu.app.subprogram import register
from mara3_tpu.mesh import amr3d, euler3d, tree_nd
from mara3_tpu.physics import euler

GAMMA = 5.0 / 3.0


def config_template():
    return (ConfigTemplate()
            .item("outdir", "data")
            .item("dfi", 0.1)
            .item("tfinal", 0.25)
            .item("block_size", 16)
            .item("depth", 3)
            .item("cfl", 0.3))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    conserved: jax.Array          # [B, bs, bs, bs, 5]


def build_mesh(cfg):
    """Octree refined toward the explosion centre (the sand3d
    predicate): level == 0 or centroid radius < 1/level."""
    return amr3d.BlockMesh3D.create(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth"))


def initial_conserved(X, Y, Z):
    """Unit-density medium with a hot central sphere (the 3D analog of
    subprog_sedov.cpp's initial overpressure region)."""
    r2 = X ** 2 + Y ** 2 + Z ** 2
    d = jnp.ones_like(X)
    p = jnp.where(r2 < 0.05, 10.0, 0.1)
    P = jnp.stack([d, 0 * X, 0 * X, 0 * X, p], axis=-1)
    return euler.to_conserved_density(P, GAMMA)


def new_solution(cfg, mesh) -> Solution:
    return Solution(0, 0.0, amr3d.sample_blocks(
        mesh, cfg.get_int("block_size"), initial_conserved))


def write_diagnostics(state, mesh, schedule, cfg):
    import h5py
    count = schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename(
        "diagnostics", count, "h5", cfg.get_string("outdir"))
    P = np.asarray(euler.recover_primitive(state.conserved, GAMMA))
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.time)
        serialize.write_tree(f.require_group("mass_density"),
                             mesh.leaves, list(P[..., 0]))
        serialize.write_tree(f.require_group("gas_pressure"),
                             mesh.leaves, list(P[..., 4]))
    print(f"write diagnostics: {path}")
    return schedule.mark_as_completed("write_diagnostics")


@register("blast3d")
def main(argv) -> int:
    import os
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)

    bs = cfg.get_int("block_size")
    cfl = cfg.get_double("cfl")
    mesh = build_mesh(cfg)
    state = new_solution(cfg, mesh)
    B = state.conserved.shape[0]
    depth = tree_nd.tree_depth(mesh.leaves)
    print(f"octree: {B} blocks of {bs}^3 x 5, depth {depth}")

    dx_min = 2.0 / (1 << (depth - 1)) / bs
    advance = euler3d.make_advance(mesh, bs, GAMMA)

    schedule = driver.create_schedule(cfg, ["write_diagnostics"])
    eps = 1e-12
    tfinal = cfg.get_double("tfinal")
    dfi = cfg.get_double("dfi")
    num_zones = B * bs ** 3

    while state.time < tfinal - eps:
        if schedule.is_due("write_diagnostics"):
            schedule = write_diagnostics(state, mesh, schedule, cfg)
        # dimension-split CFL from the current global max wavespeed
        a = float(euler3d.max_signal_speed(state.conserved, GAMMA))
        dt = cfl * dx_min / a / 3.0
        n = max(1, int(math.ceil((tfinal - state.time) / dt - eps)))
        nxt = schedule.last_performed("write_diagnostics") + dfi
        if nxt > state.time + eps:
            n = min(n, max(1, int(math.ceil((nxt - state.time) / dt
                                            - eps))))
        t0 = time.perf_counter()
        u1 = advance(state.conserved, dt, n)
        jax.block_until_ready(u1)
        ms = (time.perf_counter() - t0) * 1e3
        if not bool(jnp.isfinite(u1[..., 0]).all()):
            print("blast3d: non-finite state detected; aborting")
            return 1
        state = replace(state, iteration=state.iteration + n,
                        time=state.time + n * dt, conserved=u1)
        schedule = mark_tasks(schedule, state.time,
                              [("write_diagnostics", dfi)])
        print(f"[{state.iteration:04d}] t={state.time:3.7f} "
              f"kzps={n * num_zones / max(ms, 1e-9):3.2f}")

    if schedule.is_due("write_diagnostics"):
        schedule = write_diagnostics(state, mesh, schedule, cfg)
    return 0
