#!/usr/bin/env python3
"""Smoke run of mara3_tpu on one GPU: every subprogram's CLI path, plus the
GPU-against-CPU-float64 comparisons of the main schemes.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

One card:

- ``binary`` at the production mesh (depth=6 block_size=96, 136 blocks,
  1.25 M zones) through the CLI with checkpoints, diagnostics and the time
  series on, then a restart from the mid-run checkpoint that must land on
  the uninterrupted run's final checkpoint;
- ``kh`` at N=2048 and sedov, cloud, amrsand, sand3d, blast3d,
  boilerplate, partdom at the sizes their tests use, through the CLI;
- 4 binary steps at d6b96, 10 kh steps at 2048^2 and 10 cloud steps at
  its default nr, each run in float32 on the GPU and in float64 on the
  host CPU with the same jnp code, compared field by field.

Four cards: ``kh shards=4`` at N=4096 against the single-card advance, and
the block-sharded flagship advance (parallel/block_sharded.py) at d6b96
against the unsharded one.

Every phase prints one line. The card's name and power limit come from
nvidia-smi. The last line is one JSON object: ``{"ok": true, "device":
{...}}`` when every phase passed. Without a GPU, or when a phase fails,
the script prints ``{"ok": false, ...}`` and exits non-zero; it never
moves to the CPU in the GPU's place. The subprograms' own output goes to
chiprun_out/chip_smoke.log beside this script.

Where h5py is not installed, checkpoints, diagnostics and time series go
to an in-memory stand-in for h5py (below): the run, the schedule, the
restart and every read and write still execute, only the HDF5 encoding on
disk is skipped. The phase lines say which store was used.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import types

HERE = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(HERE, "chiprun_out")

# the float64 references run on the host CPU in this same process, so the
# CPU backend must come up beside the GPU one
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"


def _fail(reason: str, code: int = 1):
    print(json.dumps({"ok": False, "error": reason}))
    sys.exit(code)


# -----------------------------------------------------------------------------
# in-memory stand-in for h5py (used only when h5py is not installed)
# -----------------------------------------------------------------------------

def _memory_h5py():
    """A module with the slice of h5py's API this program uses: File,
    groups, datasets with resize and slice writes. Files live in a dict
    keyed by absolute path for the life of the process."""
    import numpy as np

    files = {}

    class Dataset:
        def __init__(self, data, maxshape=None):
            self._a = np.array(data)
            self.maxshape = maxshape

        shape = property(lambda self: self._a.shape)
        dtype = property(lambda self: self._a.dtype)

        def __len__(self):
            return len(self._a)

        def __getitem__(self, key):
            out = self._a[key]
            return out.copy() if isinstance(out, np.ndarray) else out

        def __setitem__(self, key, value):
            self._a[key] = value

        def resize(self, shape):
            grown = np.zeros(shape, self._a.dtype)
            n = tuple(slice(0, min(a, b)) for a, b in
                      zip(self._a.shape, shape))
            grown[n] = self._a[n]
            self._a = grown

    class Group:
        def __init__(self):
            self._items = {}

        def _walk(self, path, create):
            node = self
            for part in [p for p in path.split("/") if p]:
                if part not in node._items:
                    if not create:
                        raise KeyError(path)
                    node._items[part] = Group()
                node = node._items[part]
            return node

        def __getitem__(self, path):
            return self._walk(path, create=False)

        def __contains__(self, path):
            try:
                self._walk(path, create=False)
                return True
            except KeyError:
                return False

        def __iter__(self):
            return iter(sorted(self._items))

        def __len__(self):
            return len(self._items)

        def keys(self):
            return sorted(self._items)

        def items(self):
            return [(k, self._items[k]) for k in sorted(self._items)]

        def __delitem__(self, name):
            del self._items[name]

        def _parent(self, path):
            head, _, name = path.rstrip("/").rpartition("/")
            return self._walk(head, create=True), name

        def __setitem__(self, path, value):
            parent, name = self._parent(path)
            if name in parent._items:
                raise ValueError(f"name already exists: {path}")
            parent._items[name] = Dataset(value)

        def require_group(self, path):
            return self._walk(path, create=True)

        create_group = require_group

        def create_dataset(self, path, shape=None, dtype=None, data=None,
                           maxshape=None, chunks=None):
            parent, name = self._parent(path)
            if data is None:
                data = np.zeros(shape, dtype)
            parent._items[name] = Dataset(data, maxshape)
            return parent._items[name]

    class File(Group):
        def __init__(self, path, mode="r"):
            key = os.path.abspath(path)
            if mode == "w" or (mode == "a" and key not in files):
                files[key] = Group()
            elif key not in files:
                raise FileNotFoundError(path)
            self._items = files[key]._items

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def close(self):
            pass

    mod = types.ModuleType("h5py")
    mod.File, mod.Group, mod.Dataset = File, Group, Dataset
    mod._files = files
    return mod


def _h5py():
    try:
        import h5py
        return h5py, "hdf5 files"
    except ImportError:
        mod = _memory_h5py()
        sys.modules["h5py"] = mod
        return mod, "in-memory store (h5py not installed)"


# -----------------------------------------------------------------------------
# CLI phases
# -----------------------------------------------------------------------------

_ITER = re.compile(r"^\[(\d+)\].*kzps=([0-9.eE+-]+)", re.M)


def run_cli(log, argv, cwd):
    """Run `python -m mara3_tpu <argv>` in-process in `cwd`; returns
    (wall seconds, steps, progress lines, zone-updates/s of the last
    chunk, captured output)."""
    from mara3_tpu.app import subprogram

    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = subprogram.main(["mara"] + list(argv))
    finally:
        os.chdir(old)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    log.write(f"$ mara {' '.join(argv)}\n{out}\n")
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}")
    rows = _ITER.findall(out)
    steps = int(rows[-1][0]) if rows else 0
    rate = float(rows[-1][1]) * 1e3 if rows else float("nan")
    return wall, steps, len(rows), rate, out


def _cli_line(name, wall, steps, zones, rate, extra=""):
    return (f"phase {name}: {steps} steps x {zones} zones, wall "
            f"{wall:.2f} s (compile and output included), last chunk "
            f"{rate:.4g} zone-updates/s{extra}")


def _last_state(h5py, path, group):
    import numpy as np
    with h5py.File(path, "r") as f:
        g = f[group]
        if isinstance(g, h5py.Dataset):
            return np.asarray(g[()]), float(f["solution/time"][()])
        blocks = [np.asarray(g[k][()]) for k in g]
        return np.stack(blocks), float(f["solution/time"][()])


def phase_binary(log, h5py, tmp, depth=6, bs=96, tfinal=0.0024):
    """d6b96 through the CLI with every output on (dt ~ 6.0e-5 orbits at
    this mesh, so 0.0024 orbits is ~40 steps), then a restart from the
    mid-run checkpoint to the same tfinal."""
    import numpy as np
    args = ["binary", f"depth={depth}", f"block_size={bs}",
            f"tfinal={tfinal}", f"cpi={tfinal / 2}", f"dfi={tfinal / 2}",
            f"tsi={tfinal / 4}", "outdir=."]
    wall, steps, lines, rate, out = run_cli(log, args, tmp)
    B, bs = map(int, re.search(r"quadtree: (\d+) blocks of (\d+)x",
                               out).groups())
    zones = B * bs * bs
    if not 0 < lines < steps:
        raise RuntimeError(f"{steps} steps in {lines} progress lines: "
                           f"not the chunked scan driver")
    names = sorted(n for n in _listing(h5py, tmp) if "chkpt" in n)
    last = names[-1]
    u_a, t_a = _last_state(h5py, os.path.join(tmp, last),
                           "solution/conserved_u")
    if not np.isfinite(u_a).all():
        raise FloatingPointError("non-finite state in the final checkpoint")
    with h5py.File(os.path.join(tmp, last), "r") as f:
        n_ts = len(f["time_series"][()])
    print(_cli_line(f"binary d{depth}b{bs}", wall, steps, zones, rate,
                    f"; {len(names)} checkpoints, {n_ts} time-series rows"))

    # restart from the middle checkpoint: must reproduce the final one
    mid = names[-2]
    rwall, rsteps, _, rrate, _ = run_cli(
        log, ["binary", f"restart={mid}", f"tfinal={tfinal}"], tmp)
    u_b, t_b = _last_state(h5py, os.path.join(tmp, last),
                           "solution/conserved_u")
    err = float(np.max(np.abs(u_b - u_a)) / np.max(np.abs(u_a)))
    tol = 1e-5          # f32 time anchors differ across chunkings only
    print(f"phase binary restart from {mid}: ran to iteration {rsteps}, wall "
          f"{rwall:.2f} s, last chunk {rrate:.4g} zone-updates/s; final "
          f"state vs uninterrupted run max rel err {err:.3e} (tol {tol:g}),"
          f" time {t_b!r} vs {t_a!r}")
    # the time rides the state in f32 between the host's f64 re-anchors
    if not (err <= tol and abs(t_b - t_a) <= 1e-6 * abs(t_a)):
        raise AssertionError("restart does not reproduce the run")


def _listing(h5py, directory):
    """File names in `directory`, on disk or in the in-memory store."""
    memory = {os.path.basename(p) for p in getattr(h5py, "_files", ())
              if os.path.dirname(p) == os.path.abspath(directory)}
    return set(os.listdir(directory)) | memory


CLI_PHASES = [
    # (name, argv, zones)
    ("kh N=2048", ["kh", "N=2048", "tfinal=0.002", "cpi=0.001",
                   "dfi=0.002", "tsi=0.0005", "outdir=."], 2048 * 2048),
    ("sedov", ["sedov", "nr=128", "tfinal=0.3", "cpi=0.15", "tsi=0.1",
               "dfi=0.3"], None),
    ("cloud", ["cloud", "nr=32", "tfinal=0.1", "cpi=0.05", "dfi=0.05",
               "tsi=0.05"], 2 * 32 * 32),
    ("amrsand", ["amrsand", "depth=3", "block_size=16", "tfinal=0.25",
                 "dfi=0.1"], None),
    ("sand3d", ["sand3d", "depth=3", "block_size=8", "tfinal=0.1",
                "dfi=0.05", "outdir=."], None),
    ("blast3d", ["blast3d", "depth=3", "block_size=8", "tfinal=0.06",
                 "dfi=0.03", "outdir=."], None),
    ("boilerplate", ["boilerplate", "N=128", "tfinal=0.1", "cpi=0.1"], 128),
]


def _zones_from_output(out):
    m = re.search(r"(?:quad|oc)tree: (\d+) blocks of (\d+)(x\d+|\^3)", out)
    if m:
        b, bs = int(m.group(1)), int(m.group(2))
        return b * bs ** (3 if m.group(3) == "^3" else 2)
    return None


def phase_cli(log, name, argv, zones):
    with tempfile.TemporaryDirectory() as tmp:
        wall, steps, _, rate, out = run_cli(log, argv, tmp)
    if zones is None:
        zones = _zones_from_output(out)
    if zones is None and argv[0] == "sedov":
        from mara3_tpu.subprograms import sedov
        cfg = sedov.config_template().create().update(
            dict(a.split("=", 1) for a in argv[1:]))
        zones = int(sedov.new_solution(cfg).conserved.shape[0])
    if steps <= 0:
        raise RuntimeError(f"{name}: no steps taken")
    print(_cli_line(name, wall, steps, zones, rate))


def phase_partdom(log):
    with tempfile.TemporaryDirectory() as tmp:
        wall, _, _, _, out = run_cli(log, ["partdom"], tmp)
    if "wrote test.h5" not in out:
        raise RuntimeError("partdom wrote no output")
    print(f"phase partdom: 24^3 domain decomposed and written, wall "
          f"{wall:.2f} s")


# -----------------------------------------------------------------------------
# GPU float32 against CPU float64, same jnp code
# -----------------------------------------------------------------------------

def _on(device, x64):
    import jax
    stack = contextlib.ExitStack()
    stack.enter_context(jax.default_device(device))
    stack.enter_context(jax.enable_x64(x64))
    return stack


def _report(name, what, u_dev, u_ref, m_dev, m_ref, tol_field, tol_mass,
            wall_dev, zone_steps, groups):
    """Max relative error of each conserved field and the total-mass
    drift of both runs from their own initial mass. A field's error is
    normalized by the largest reference magnitude in its group: the
    momentum components share one scale, so a component that is nearly
    zero everywhere is not judged against its own round-off."""
    import numpy as np
    scale = {k: max(float(np.max(np.abs(u_ref[..., list(g)]))), 1e-300)
             for g in groups for k in g}
    errs = [float(np.max(np.abs(u_dev[..., k] - u_ref[..., k]))) / scale[k]
            for k in range(u_ref.shape[-1])]
    drift_dev = (m_dev[1] - m_dev[0]) / m_dev[0]
    drift_ref = (m_ref[1] - m_ref[0]) / m_ref[0]
    dd = abs(drift_dev - drift_ref)
    print(f"phase compare {name}: {what}, GPU f32 {wall_dev:.3f} s "
          f"({zone_steps / wall_dev:.4g} zone-updates/s incl. compile); "
          f"max rel err per field "
          f"[{', '.join(f'{e:.2e}' for e in errs)}] (tol {tol_field:g}); "
          f"mass drift GPU {drift_dev:.3e} ref {drift_ref:.3e} "
          f"|diff| {dd:.2e} (tol {tol_mass:g})")
    if not (max(errs) <= tol_field and dd <= tol_mass):
        raise AssertionError(f"{name}: GPU f32 differs from CPU f64")


def _binary_run(device, x64, depth, bs, n):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mara3_tpu.schemes import binary_step
    from mara3_tpu.subprograms import binary as B
    with _on(device, x64):
        cfg = B.create_config_template().create().update(
            {"depth": depth, "block_size": bs})
        sd = B.create_solver_data(cfg)
        sol = B.create_solution(cfg, sd)
        s0 = binary_step.solution_to_arrays(
            sol, jnp.float64 if x64 else jnp.float32)
        scan = binary_step.make_fast_scan(sd)
        t0 = time.perf_counter()
        s1, rows = scan(s0, n)
        jax.block_until_ready(s1)
        wall = time.perf_counter() - t0
        dA = np.asarray(sd.geometry[1], np.float64)
        u0 = np.asarray(s0["conserved"], np.float64)
        u1 = np.asarray(s1["conserved"], np.float64)
        if np.asarray(rows)[:, binary_step.INFO_INDEX["invalid"]].any():
            raise FloatingPointError("binary step faulted")
    mass = (float(np.sum(u0[..., 0] * dA)), float(np.sum(u1[..., 0] * dA)))
    return u1, mass, wall


def compare_binary(gpu, cpu, depth=6, bs=96, n=4):
    """f32 round-off over 4 RK2 steps, amplified where the PLM limiter and
    the HLLE wave-speed bounds switch branch, stays near 1e-6 relative;
    a TF32 contraction anywhere in the step would put ~1e-3 into the guard
    cells and fluxes."""
    u_d, m_d, wall = _binary_run(gpu, False, depth, bs, n)
    u_r, m_r, _ = _binary_run(cpu, True, depth, bs, n)
    _report(f"binary d{depth}b{bs}", f"{n} steps", u_d, u_r, m_d, m_r,
            2e-5, 1e-6, wall, n * u_r[..., 0].size, [(0,), (1, 2)])


def _kh_run(device, x64, N, n, dt):
    import jax
    import numpy as np
    from mara3_tpu.subprograms import kh
    with _on(device, x64):
        cfg = kh.config_template().create().update({"N": N})
        u0 = kh.initial_conserved(cfg)
        t0 = time.perf_counter()
        u1 = jax.block_until_ready(kh.advance_n(
            u0, n, cs2=1.0, dx=1.0 / N, dy=1.0 / N, dt=dt, theta=1.8))
        wall = time.perf_counter() - t0
    u0 = np.asarray(u0, np.float64)
    u1 = np.asarray(u1, np.float64)
    return u1, (float(u0[..., 0].sum()), float(u1[..., 0].sum())), wall


def compare_kh(gpu, cpu, N=2048, n=10):
    """Periodic box: mass is conserved to round-off by construction, so
    the drift itself must stay at f32 summation round-off."""
    from mara3_tpu.subprograms import kh
    cfg = kh.config_template().create().update({"N": N})
    with _on(cpu, True):
        dt = kh.fixed_timestep(cfg, kh.initial_conserved(cfg))
    u_d, m_d, wall = _kh_run(gpu, False, N, n, dt)
    u_r, m_r, _ = _kh_run(cpu, True, N, n, dt)
    _report(f"kh {N}^2", f"{n} steps", u_d, u_r, m_d, m_r, 2e-5, 1e-6,
            wall, n * N * N, [(0,), (1, 2)])
    drift = abs(m_d[1] - m_d[0]) / m_d[0]
    if drift > 1e-6:
        raise AssertionError(f"kh mass drift {drift:.2e} on the GPU")


def _cloud_run(device, x64, nr, n):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mara3_tpu.subprograms import cloud
    with _on(device, x64):
        cfg = cloud.config_template().create().update({"nr": nr})
        sol = cloud.new_solution(cfg)
        rv, qv = sol.radial_vertices, sol.polar_vertices
        dt = float(rv[1] - rv[0]) * cfg.get_double("cfl_number")
        units = cloud.make_reference_units(cfg)
        jet = cloud.make_jet_nozzle_model(cfg)
        jet_static = (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
                      units.mass_density, units.time)
        u = sol.conserved
        p = jnp.zeros(u.shape[:2], u.dtype)
        t = 0.0
        t0 = time.perf_counter()
        for _ in range(n):
            u, p = cloud._advance_rk_carry(
                u, p, t, rv, qv, jet_static, dt,
                cfg.get_double("plm_theta"),
                cfg.get_int("reconstruct_method"),
                cfg.get_double("temperature_floor"), cfg.get_int("rk_order"))
            t += dt
        jax.block_until_ready(u)
        wall = time.perf_counter() - t0
    u0 = np.asarray(sol.conserved, np.float64)
    u1 = np.asarray(u, np.float64)
    return u1, (float(u0[..., 0].sum()), float(u1[..., 0].sum())), wall


def compare_cloud(gpu, cpu, nr=256, n=10):
    """SRHD: the f32 Newton recovery stops at a dtype-aware tolerance
    (8 eps relative), so the f32 state carries that floor on top of the
    flux round-off; 1e-4 still sits an order below a TF32 leak."""
    u_d, m_d, wall = _cloud_run(gpu, False, nr, n)
    u_r, m_r, _ = _cloud_run(cpu, True, nr, n)
    _report(f"cloud nr={nr}", f"{n} steps", u_d, u_r, m_d, m_r, 1e-4,
            1e-6, wall, n * u_r[..., 0].size, [(0,), (1, 2, 3), (4,)])


# -----------------------------------------------------------------------------
# four cards
# -----------------------------------------------------------------------------

def phase_kh_shards(log, h5py, N=4096, shards=4):
    import jax
    import numpy as np
    from mara3_tpu.subprograms import kh
    with tempfile.TemporaryDirectory() as tmp:
        wall, steps, _, rate, _ = run_cli(
            log, ["kh", f"N={N}", "tfinal=0.0005", "cpi=0.0005", "dfi=1.0",
                  "tsi=1.0", "outdir=.", f"shards={shards}"], tmp)
        with h5py.File(os.path.join(tmp, "chkpt.0001.h5"), "r") as f:
            got = np.asarray(f["solution/conserved"][()], np.float64)
            iters = int(f["solution/iteration"][()])
            dt = float(f["solution/dt"][()])
    cfg = kh.config_template().create().update({"N": N})
    want = np.asarray(jax.block_until_ready(kh.advance_n(
        kh.initial_conserved(cfg), iters, cs2=1.0, dx=1.0 / N, dy=1.0 / N,
        dt=dt, theta=1.8)), np.float64)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    tol = 1e-5
    print(_cli_line(f"kh N={N} shards={shards}", wall, steps, N * N, rate,
                    f"; vs one card max rel err {err:.3e} (tol {tol:g})"))
    if err > tol:
        raise AssertionError("sharded kh differs from one card")


def phase_block_sharded(depth=6, bs=96, n_dev=4):
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from mara3_tpu.models import two_body
    from mara3_tpu.parallel.block_sharded import make_advance_block_sharded
    from mara3_tpu.subprograms import binary as B

    cfg = B.create_config_template().create().update(
        {"depth": depth, "block_size": bs})
    sd = B.create_solver_data(cfg)
    sol = B.create_solution(cfg, sd)
    bodies = B._bodies_array(two_body.compute_two_body_state(
        sol.orbital_elements, 0.0))
    dt = sd.recommended_time_step
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("blocks",))
    adv = make_advance_block_sharded(sd.cfg_scheme, sd.nt, sd.geometry,
                                     sd.initial_conserved, sd.buffer_rate,
                                     mesh)
    us = jax.device_put(sol.conserved, NamedSharding(mesh, P("blocks")))
    u_s, tot_s, bad_s = adv(us, bodies, dt, sd.plm_theta)
    jax.block_until_ready(u_s)
    t0 = time.perf_counter()
    for _ in range(5):
        u_s2, _, _ = adv(us, bodies, dt, sd.plm_theta)
    jax.block_until_ready(u_s2)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    u_1, tot_1, bad_1 = sd.advance(sol.conserved, bodies, dt, sd.plm_theta)
    a, b = np.asarray(u_s, np.float64), np.asarray(u_1, np.float64)
    err = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    # accreted mass is a sum of same-sign terms, so it is well conditioned;
    # the force and torque totals cancel to ~1e-4 of their terms and carry
    # the shard-order summation round-off at that level
    m_s = np.asarray(tot_s["mass_accreted_on"], np.float64)
    m_1 = np.asarray(tot_1["mass_accreted_on"], np.float64)
    terr = float(np.max(np.abs(m_s - m_1) / np.abs(m_1)))
    tol = 1e-5
    print(f"phase block_sharded d{depth}b{bs}: {len(sd.leaves)} blocks over "
          f"{n_dev} cards, {ms:.3f} ms/advance; vs unsharded max rel err "
          f"state {err:.3e}, accreted mass {terr:.3e} (tol {tol:g})")
    if bool(bad_s) or bool(bad_1) or err > tol or terr > tol:
        raise AssertionError("block-sharded advance differs from one card")


# -----------------------------------------------------------------------------

def main(argv) -> int:
    four = "--four-cards" in argv
    try:
        import jax
        import mara3_tpu  # noqa: F401
    except ImportError as e:
        _fail(f"cannot import the program: {e}", 2)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        _fail(f"no GPU visible to JAX (default backend: {dev.platform})")
    if four and len(devices) < 4:
        _fail(f"--four-cards needs 4 GPUs, JAX sees {len(devices)}")
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:
        _fail(f"no CPU backend for the float64 references: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    h5py, store = _h5py()
    print(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind}; "
          f"outputs to {store}")

    os.makedirs(LOG_DIR, exist_ok=True)
    failed = []
    with open(os.path.join(LOG_DIR, "chip_smoke.log"), "w") as log:
        def phase(name, fn, *args):
            t0 = time.perf_counter()
            try:
                fn(*args)
            except Exception as e:                 # noqa: BLE001
                failed.append(name)
                log.write(traceback.format_exc())
                print(f"phase {name}: FAILED after "
                      f"{time.perf_counter() - t0:.1f} s: "
                      f"{type(e).__name__}: {str(e)[:300]}")
            log.flush()
            sys.stdout.flush()

        if four:
            phase("kh shards", phase_kh_shards, log, h5py)
            phase("block_sharded", phase_block_sharded)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                phase("binary", phase_binary, log, h5py, tmp)
            for name, args, zones in CLI_PHASES:
                phase(name, phase_cli, log, name, args, zones)
            phase("partdom", phase_partdom, log)
            phase("compare binary", compare_binary, dev, cpu)
            phase("compare kh", compare_kh, dev, cpu)
            phase("compare cloud", compare_cloud, dev, cpu)

    for line in smi:
        print(f"card: {line}")
    if not smi:
        failed.append("nvidia-smi")
        print("card: nvidia-smi gave no answer")
    if failed:
        _fail(f"failed phases: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
