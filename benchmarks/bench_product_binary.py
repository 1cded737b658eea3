"""Default-config flagship product rate.

Runs `python -m mara3_tpu binary` at the d6b96 geometry with the shipped
defaults through the real driver (checkpoint/diagnostics/time series
scheduling included), and reports the sustained in-run kzps: the
median of the [iter] lines over the second half of the run, which skips
compile + warmup chunks the way a user-facing sustained rate should.

Prints one PRODUCT_RESULT json line.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time

_ARGS = dict(a.split("=", 1) for a in sys.argv[1:])
STEPS = int(_ARGS.get("steps", 4096))
# extra CLI overrides, comma-separated k=v pairs (e.g.
# extra=begin_live_binary=0 measures the scientifically-live mode);
# they tag the PRODUCT_RESULT config name
EXTRA = [kv for kv in _ARGS.get("extra", "").split(",") if kv]


def main():
    import numpy as np

    # one probe step through the library to learn dt at this config
    sys.path.insert(0, ".")
    import jax.numpy as jnp
    from mara3_tpu.schemes import binary_step
    from mara3_tpu.subprograms import binary as B
    cfg = B.create_config_template().create().update(
        {"depth": 6, "block_size": 96, "rk_order": 1})
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    s0 = binary_step.solution_to_arrays(
        sol, jnp.asarray(sd.initial_conserved).dtype)
    fast = binary_step.make_fast_scan(sd)
    _, rows = fast(s0, 1)
    dt = float(np.asarray(rows)[0, binary_step.INFO_INDEX["dt"]])
    tfinal = STEPS * dt / (2 * math.pi)          # orbits

    outdir = "/tmp/bench_product_binary"
    shutil.rmtree(outdir, ignore_errors=True)
    argv = [sys.executable, "-m", "mara3_tpu", "binary",
            "depth=6", "block_size=96", "rk_order=1",
            f"tfinal={tfinal:.8g}", f"cpi={tfinal:.8g}",
            f"dfi={tfinal:.8g}", f"tsi={tfinal:.8g}",
            f"outdir={outdir}"] + EXTRA
    print("argv:", " ".join(argv), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    print("\n".join(proc.stdout.splitlines()[-8:]))
    if proc.returncode != 0:
        print(proc.stderr[-3000:])

    kzps = [float(m.group(1)) for m in re.finditer(
        r"kzps=([0-9.]+)", proc.stdout)]
    fell_back = "falling back to per-step scan" in proc.stdout
    half = kzps[len(kzps) // 2:]
    sustained = float(np.median(half)) * 1e3 if half else float("nan")
    # print the rate summary BEFORE anything that could still fail, so an
    # unattended capture never loses the measurement again (r5 product job
    # lost its median to a json TypeError after a 45-min run)
    if half:
        q = np.percentile(half, [10, 50, 90]) * 1e3
        print(f"KZPS_SUMMARY n={len(kzps)} half_n={len(half)} "
              f"p10={q[0]:.4g} median={q[1]:.4g} p90={q[2]:.4g} zones/s",
              flush=True)

    # finite-state check on the final checkpoint (never trust a rate
    # without one — r4 finding)
    import glob

    import h5py
    finite = False
    chk = sorted(glob.glob(f"{outdir}/chkpt.*.h5"))
    if chk:
        with h5py.File(chk[-1], "r") as h:
            grp = h["solution"]["conserved_u"]
            finite = all(np.isfinite(np.asarray(grp[k])).all()
                         for k in grp)

    tag = "".join("+" + kv.split("=")[0] for kv in EXTRA)
    res = dict(config="binary_d6b96_rk1_default_product" + tag,
               steps=STEPS, rc=proc.returncode, wall_s=round(wall, 1),
               sustained_zps=sustained, fell_back=fell_back,
               finite=finite,
               ok=bool(proc.returncode == 0 and finite and not fell_back
                       and np.isfinite(sustained)))
    print("PRODUCT_RESULT " + json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
