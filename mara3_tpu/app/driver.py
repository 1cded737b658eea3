"""Shared subprogram driver plumbing.

The reference repeats its run-loop/checkpoint/restart boilerplate in every
subprogram (by design — subprog_boilerplate.cpp is the template). Here the
common parts are factored once:

- restart precedence: template defaults <- checkpoint run_config <- CLI args
  (reference subprog_binary.cpp:155-164)
- numbered checkpoints with solution/schedule/run_config groups
  (reference subprog_boilerplate.cpp:201-210)
- the timed run loop printing ``[iter] t=... kzps=...`` per step
  (reference subprog_boilerplate.cpp:252-256 et al.)

Each subprogram supplies a jit-compiled ``next`` step; the driver loop
stays on the host and only synchronizes when printing or when a scheduled
task moves data to disk.
"""

from __future__ import annotations

import os

import jax

from mara3_tpu.app import serialize
from mara3_tpu.app.config import Config, ConfigTemplate, argv_to_string_map
from mara3_tpu.app.performance import PerfDiagnostics, time_execution
from mara3_tpu.app.schedule import Schedule


def create_run_config(template: ConfigTemplate, argv) -> Config:
    """argv -> config with checkpoint-restart merge semantics."""
    import h5py
    args = argv_to_string_map(argv)
    cfg = template.create()
    if "restart" in args and args["restart"]:
        with h5py.File(args["restart"], "r") as f:
            # our checkpoints use 'run_config'; reference-generated sedov/
            # cloud checkpoints use 'config' (subprog_sedov.cpp:487)
            group = f["run_config"] if "run_config" in f else f["config"]
            stored = serialize.read_config(group)
            # ignore keys the template doesn't declare (forward/backward
            # compatibility with reference-generated files)
            stored = {k: v for k, v in stored.items() if k in cfg}
            cfg = cfg.update(stored)
    return cfg.update(args)


def create_schedule(run_config: Config, task_names) -> Schedule:
    """Fresh schedule with every task initially due, or the checkpoint's."""
    import h5py
    restart = run_config.get_string("restart") if "restart" in run_config else ""
    if restart:
        with h5py.File(restart, "r") as f:
            return serialize.read_schedule(f["schedule"])
    s = Schedule.create(*task_names)
    for name in task_names:
        s = s.mark_as_due(name)
    return s


def use_fast_driver(run_config: Config) -> bool:
    """The ``fast_step`` option: 1 runs the device-resident chunked driver
    (one dispatch per chunk of steps), 0 the per-step host loop, -1 picks
    the chunked driver on any accelerator backend and the host loop on
    the CPU, where it stays the reference the chunked driver is tested
    against."""
    fast = run_config.get_int("fast_step")
    if fast < 0:
        return jax.default_backend() != "cpu"
    return fast != 0


def checkpoint_path(run_config: Config, count: int, prefix: str = "chkpt") -> str:
    outdir = (run_config.get_string("outdir")
              if "outdir" in run_config else ".")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    return serialize.create_numbered_filename(prefix, count, "h5", outdir)


def write_checkpoint_groups(path: str, run_config: Config,
                            schedule: Schedule, write_solution_fn):
    """Create chkpt file with the reference's three groups; the caller's
    write_solution_fn(group) fills the solution group."""
    import h5py
    with h5py.File(path, "w") as f:
        write_solution_fn(f.require_group("solution"))
        serialize.write_schedule(f.require_group("schedule"), schedule)
        serialize.write_config(f.require_group("run_config"), run_config)
    print(f"write checkpoint: {path}")


def print_run_loop_message(iteration: int, time: float,
                           total_zones: int, perf: PerfDiagnostics):
    rate = total_zones / max(perf.execution_time_ms, 1e-12)
    print(f"[{iteration:04d}] t={time:3.7f} kzps={rate:3.2f}")


def run_loop(state, should_continue, step, zones_of, iteration_of, time_of):
    """The reference's main loop shape (subprog_boilerplate.cpp:266-287):
    while should_continue: state = timed(step)(state); print kzps.
    With MARA3_PROFILE_DIR set, the whole loop runs under a jax.profiler
    trace (the tracer-span instrumentation the reference lacks)."""
    from mara3_tpu.app import profiling
    import contextlib

    log_dir = profiling.profile_dir()
    ctx = profiling.trace(log_dir) if log_dir else contextlib.nullcontext()
    with ctx:
        while should_continue(state):
            state, perf = time_execution(step, state)
            print_run_loop_message(iteration_of(state), time_of(state),
                                   zones_of(state), perf)
    return state
