"""The GPU smoke script's host-side parts, on the CPU: its refusal to run
without a GPU, the fast-driver selection rule it relies on, and the
in-memory stand-in for h5py it uses where h5py is not installed."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mara3_tpu.app import driver, subprogram
from mara3_tpu.app.config import ConfigTemplate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_a_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    if script == "chip_smoke.py":
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        assert last["ok"] is False
    else:
        assert proc.stdout.strip() == ""


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("fast_step", [-1, 0, 1])
def test_use_fast_driver_rule(fast_step, backend, monkeypatch):
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = ConfigTemplate().item("fast_step", -1).create().update(
        {"fast_step": str(fast_step)})
    want = {1: True, 0: False, -1: backend != "cpu"}[fast_step]
    assert driver.use_fast_driver(cfg) is want


# (argv of a run with checkpoints, argv of its restart)
RESTARTS = {
    "binary": (["depth=2", "block_size=8", "tfinal=0.02", "cpi=0.01",
                "dfi=0.02", "tsi=0.005", "outdir=."],
               ["restart=chkpt.0001.h5", "tfinal=0.03"]),
    "kh": (["N=32", "tfinal=0.02", "cpi=0.01", "dfi=0.02", "tsi=0.005",
            "outdir=."], ["restart=chkpt.0001.h5", "tfinal=0.03"]),
    "cloud": (["nr=16", "tfinal=0.1", "cpi=0.05", "dfi=0.05", "tsi=0.05",
               "outdir=."], ["restart=chkpt.0001.h5", "tfinal=0.15"]),
    "sedov": (["nr=32", "tfinal=0.3", "cpi=0.15", "tsi=0.1", "dfi=0.3",
               "outdir=."], ["restart=chkpt.0001.h5", "tfinal=0.45"]),
    "boilerplate": (["N=64", "tfinal=0.05", "cpi=0.02"],
                    ["restart=chkpt.0002.h5", "tfinal=0.08"]),
}


def _tree(g):
    """{path: array} of every dataset under group g (h5py or stand-in)."""
    out = {}
    for k in g.keys():
        v = g[k]
        if hasattr(v, "keys"):
            out.update({f"{k}/{p}": a for p, a in _tree(v).items()})
        else:
            out[k] = np.asarray(v[()])
    return out


@pytest.mark.parametrize("name", sorted(RESTARTS))
def test_memory_store_matches_hdf5_through_restart(name, tmp_path,
                                                   monkeypatch):
    """A run plus a restart through the in-memory stand-in writes the same
    checkpoints, bit for bit, as the same run on real HDF5 files."""
    import h5py

    run, restart = RESTARTS[name]
    final = {}
    for store in ("disk", "memory"):
        d = tmp_path / store
        d.mkdir()
        monkeypatch.chdir(d)
        mod = h5py
        if store == "memory":
            mod = chip_smoke._memory_h5py()
            monkeypatch.setitem(sys.modules, "h5py", mod)
        assert subprogram.main(["mara", name] + run) == 0
        assert subprogram.main(["mara", name] + restart) == 0
        names = sorted(chip_smoke._listing(mod, d))
        chk = [n for n in names if n.startswith("chkpt")]
        with mod.File(str(d / chk[-1]), "r") as f:
            final[store] = (names, _tree(f["solution"]))
        monkeypatch.setitem(sys.modules, "h5py", h5py)

    (names_d, tree_d), (names_m, tree_m) = final["disk"], final["memory"]
    assert names_m == names_d
    assert sorted(tree_m) == sorted(tree_d)
    for k in tree_d:
        assert np.array_equal(tree_m[k], tree_d[k]), k
