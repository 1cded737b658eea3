"""blast3d 3D Euler AMR advance rate on the current backend.

Measures the jnp gather-based octree Euler advance (mesh/euler3d.py:
HLLE through the six-face guard exchange with exactly conservative
coarse-fine flux correction), with finiteness and global conservation
checks on the result (mass/energy totals must drift only at f32
round-off; the flux correction makes level-jump faces exact).
Prints one BLAST3D_RESULT json line per config.

Usage: python benchmarks/bench_blast3d.py [depths=3,4]
"""

from __future__ import annotations

import json
import sys
import time

import jax
import numpy as np

import mara3_tpu  # noqa: F401  (platform/compile-cache setup)
from mara3_tpu.mesh import euler3d
from mara3_tpu.subprograms import blast3d as S


def measure(advance, u, dt, n):
    t0 = time.perf_counter()
    out = advance(u, dt, n)
    np.asarray(out[0, 0, 0, 0])          # honest host-readback fence
    return time.perf_counter() - t0, out


def run_config(depth: int) -> dict:
    bs = 16
    cfg = S.config_template().create().update(
        {"depth": depth, "block_size": bs})
    mesh = S.build_mesh(cfg)
    u = S.new_solution(cfg, mesh).conserved
    B = u.shape[0]
    dx_min = 2.0 / (1 << max(1, depth - 1)) / bs
    # fixed dt from the initial max wavespeed with a 3x safety margin:
    # the blast's expansion fan outruns the initial sound speed, so the
    # effective CFL grows during the run — 0.1 keeps the 300-step
    # window stable while measuring the same advance the product runs.
    a0 = float(euler3d.max_signal_speed(u, S.GAMMA))
    dt = 0.1 * dx_min / a0 / 3.0
    advance = euler3d.make_advance(mesh, bs, S.GAMMA)

    tot0 = np.asarray(euler3d.total_conserved(mesh, bs, u), np.float64)
    wall_c, _ = measure(advance, u, dt, 1)           # compile + 1 step
    # marginal rate between two step counts (cancels dispatch overhead)
    n1, n2 = 100, 300
    # auto-widen until the marginal is resolved (>=0.2 s): a sub-noise
    # w2-w1 measures timer jitter, not the step.
    # dt shrinks with the widened window so the blast stays in the
    # stable regime over the longer integration.
    for _ in range(6):
        w1, _ = measure(advance, u, dt, n1)
        w2, out = measure(advance, u, dt, n2)
        if w2 - w1 >= 0.2:
            break
        n1, n2, dt = n1 * 4, n2 * 4, dt / 4
    tot1 = np.asarray(euler3d.total_conserved(mesh, bs, out), np.float64)
    zones = B * bs ** 3
    zps = (n2 - n1) * zones / max(w2 - w1, 1e-9)
    # mass (0) and total energy (4) are conserved quantities; momentum
    # starts at exactly zero, so compare its drift against the energy
    # scale instead of itself.
    scale = max(abs(tot0[0]), abs(tot0[4]))
    drift = float(np.max(np.abs(tot1 - tot0)) / scale)
    res = dict(config=f"blast3d_d{depth}b{bs}",
               backend=jax.default_backend(), blocks=B, zones=zones,
               compile_s=round(wall_c, 1), zps=zps,
               conserved_drift_rel=drift,
               finite=bool(np.isfinite(np.asarray(out)).all()))
    res["ok"] = bool(res["finite"] and drift < 1e-4)
    print("BLAST3D_RESULT " + json.dumps(res), flush=True)
    return res


def main():
    args = dict(a.split("=", 1) for a in sys.argv[1:])
    depths = [int(d) for d in args.get("depths", "3").split(",")]
    ok = True
    for depth in depths:
        ok = run_config(depth)["ok"] and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
