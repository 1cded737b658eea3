"""Default-path cloud product rate (the bench_product_binary analog).

Runs `python -m mara3_tpu cloud` at the nr=1024 rk2 geometry with the
shipped defaults through the real driver (checkpoint/diagnostics/
time-series scheduling included), and reports the sustained
in-run kzps: the median of the [iter] lines over the second half.

Prints one PRODUCT_RESULT json line.
"""

from __future__ import annotations

import glob
import json
import math
import shutil
import re
import subprocess
import sys
import time

_ARGS = dict(a.split("=", 1) for a in sys.argv[1:])
STEPS = int(_ARGS.get("steps", 2048))
EXTRA = [kv for kv in _ARGS.get("extra", "").split(",") if kv]


def main():
    import numpy as np

    sys.path.insert(0, ".")
    from mara3_tpu.subprograms import cloud as C
    cfg = C.config_template().create().update(
        {"nr": 1024, "rk_order": 2})
    sol = C.create_solution(cfg)
    dr_min = float(sol.radial_vertices[1] - sol.radial_vertices[0])
    dt = dr_min * cfg.get_double("cfl_number")
    tfinal = STEPS * dt

    outdir = "/tmp/bench_product_cloud"
    shutil.rmtree(outdir, ignore_errors=True)
    argv = [sys.executable, "-m", "mara3_tpu", "cloud",
            "nr=1024", "rk_order=2",
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
    half = kzps[len(kzps) // 2:]
    sustained = float(np.median(half)) * 1e3 if half else float("nan")
    if half:
        q = np.percentile(half, [10, 50, 90]) * 1e3
        print(f"KZPS_SUMMARY n={len(kzps)} half_n={len(half)} "
              f"p10={q[0]:.4g} median={q[1]:.4g} p90={q[2]:.4g} zones/s",
              flush=True)

    import h5py
    finite = False
    chk = sorted(glob.glob(f"{outdir}/chkpt.*.h5"))
    if chk:
        with h5py.File(chk[-1], "r") as h:
            u = h["solution/conserved"][()]
            finite = bool(np.isfinite(u).all())

    tag = "".join("+" + kv.split("=")[0] for kv in EXTRA)
    res = dict(config="cloud_nr1024_rk2_default_product" + tag,
               steps=STEPS, rc=proc.returncode, wall_s=round(wall, 1),
               sustained_zps=sustained, finite=finite,
               ok=bool(proc.returncode == 0 and finite
                       and np.isfinite(sustained)))
    print("PRODUCT_RESULT " + json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
