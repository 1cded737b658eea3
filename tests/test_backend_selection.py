"""What the program picks from the platform it finds: the driver each
subprogram runs on an accelerator and the compile-cache location."""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import pytest

from mara3_tpu.app import subprogram

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny runs of every stepping subprogram through the CLI
RUNS = {
    "binary": ["depth=2", "block_size=8", "tfinal=1.0", "cpi=10.0",
               "dfi=10.0", "tsi=10.0"],
    "cloud": ["nr=16", "tfinal=1.0", "cpi=10.0", "dfi=10.0", "tsi=10.0"],
    "sedov": ["nr=16", "tfinal=0.5", "cpi=10.0", "dfi=10.0", "tsi=10.0"],
    "amrsand": ["depth=2", "block_size=8", "tfinal=0.1", "dfi=1.0"],
    "kh": ["N=16", "tfinal=0.1", "cpi=1.0", "dfi=1.0", "tsi=1.0",
           "outdir=."],
    "sand3d": ["depth=2", "block_size=4", "tfinal=0.05", "dfi=1.0",
               "outdir=."],
    "blast3d": ["depth=2", "block_size=4", "tfinal=0.02", "dfi=1.0",
                "outdir=."],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_accelerator_backend_runs_the_chunked_driver(name, tmp_path,
                                                     monkeypatch):
    """With the backend reported as a GPU and fast_step left at auto,
    every subprogram advances in device-resident chunks (fewer progress
    lines than steps) on the jnp path — no Pallas interpreter anywhere."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert subprogram.main(["mara", name] + RUNS[name]) == 0
    rows = re.findall(r"^\[(\d+)\]", buf.getvalue(), re.M)
    assert rows and len(rows) < int(rows[-1]), buf.getvalue()[-2000:]
    assert not [m for m in sys.modules if "pallas" in m]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache; otherwise the
    cache sits at a fixed .jax_cache directory in the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import mara3_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120,
        check=True).stdout.strip().splitlines()[-1]
    want = (str(tmp_path / "cache") if env_set
            else os.path.join(REPO, ".jax_cache"))
    assert out == want
