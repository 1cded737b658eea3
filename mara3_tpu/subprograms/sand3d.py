"""3D AMR sandbox: octree advection of a Gaussian blob at v = (.5,.5,.5).

The rank-3 analog of `amrsand` (reference subprog_amrsand.cpp:49-369 is
2D, like every shipped reference workload; the reference's tree
machinery is rank-templated, core_tree.hpp:43-235). This subprogram is
beyond-reference surface: it drives mesh/amr3d.py — octree build with
2:1 balance, six-face guard exchange across level jumps, exactly
conservative coarse-fine flux correction — through the full app
framework: config, drift-free schedule, numbered diagnostics with
rank-3 "level:i-j-k" flat tree keys (app_serialize_tree.hpp:72-87
format, which is already rank-generic), and per-step kzps meters.

The whole inter-output window runs as ONE jit dispatch
(amr3d.make_advance scans `steps` in-graph), the same chunked-driver
design as the 2D amrsand fast path.
"""

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
from mara3_tpu.mesh import amr3d, tree_nd

VELOCITY = (0.5, 0.5, 0.5)


def config_template():
    return (ConfigTemplate()
            .item("outdir", "data")
            .item("dfi", 1.0)
            .item("tfinal", 1.0)
            .item("block_size", 16)
            .item("depth", 3))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    conserved: jax.Array          # [B, bs, bs, bs]


def build_mesh(cfg):
    """Octree with the 2D sandbox's predicate (refine toward the
    centre): level == 0 or centroid radius < 1/level, up to `depth`."""
    return amr3d.BlockMesh3D.create(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth"))


def new_solution(cfg, mesh) -> Solution:
    u = amr3d.sample_blocks(
        mesh, cfg.get_int("block_size"),
        lambda X, Y, Z: jnp.exp(-(X**2 + Y**2 + Z**2) / 0.025))
    return Solution(0, 0.0, u)


def write_diagnostics(state, mesh, schedule, cfg):
    import h5py
    count = schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename(
        "diagnostics", count, "h5", cfg.get_string("outdir"))
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.time)
        serialize.write_tree(f.require_group("conserved"), mesh.leaves,
                             list(np.asarray(state.conserved)))
    print(f"write diagnostics: {path}")
    return schedule.mark_as_completed("write_diagnostics")


@register("sand3d")
def main(argv) -> int:
    import os
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)

    bs = cfg.get_int("block_size")
    mesh = build_mesh(cfg)
    state = new_solution(cfg, mesh)
    B = state.conserved.shape[0]
    depth = tree_nd.tree_depth(mesh.leaves)
    print(f"octree: {B} blocks of {bs}^3, depth {depth}")

    # dimension-split upwind stability: dt * sum(v) / dx_min <= 1
    dx_min = 2.0 / (1 << (depth - 1)) / bs
    dt = 0.5 * dx_min / sum(VELOCITY)
    advance = amr3d.make_advance(mesh, bs, VELOCITY)

    schedule = driver.create_schedule(cfg, ["write_diagnostics"])
    eps = 1e-12
    tfinal = cfg.get_double("tfinal")
    dfi = cfg.get_double("dfi")
    num_zones = B * bs ** 3

    while state.time < tfinal - eps:
        if schedule.is_due("write_diagnostics"):
            schedule = write_diagnostics(state, mesh, schedule, cfg)
        n = max(1, int(math.ceil((tfinal - state.time) / dt - eps)))
        nxt = schedule.last_performed("write_diagnostics") + dfi
        if nxt > state.time + eps:
            n = min(n, max(1, int(math.ceil((nxt - state.time) / dt
                                            - eps))))
        t0 = time.perf_counter()
        u1 = advance(state.conserved, dt, n)
        jax.block_until_ready(u1)
        ms = (time.perf_counter() - t0) * 1e3
        state = replace(state, iteration=state.iteration + n,
                        time=state.time + n * dt, conserved=u1)
        schedule = mark_tasks(schedule, state.time,
                              [("write_diagnostics", dfi)])
        print(f"[{state.iteration:04d}] t={state.time:3.7f} "
              f"kzps={n * num_zones / max(ms, 1e-9):3.2f}")

    if schedule.is_due("write_diagnostics"):
        schedule = write_diagnostics(state, mesh, schedule, cfg)
    return 0
