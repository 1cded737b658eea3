"""Profiling hooks: jax.profiler traces alongside the kzps meter.

The reference's only performance instrumentation is wall-clock timing
(app_performance.hpp) and the per-step kzps print (SURVEY.md §5). The JAX
equivalent adds real tracer spans: wrap any region in ``trace`` to capture a
TensorBoard/Perfetto trace of the compiled programs, DMAs, and collectives.

Set MARA3_PROFILE_DIR to activate tracing of every subprogram's run loop
(driver.run_loop checks it), or use the context manager directly:

    from mara3_tpu.app.profiling import trace
    with trace("/tmp/mytrace"):
        state = step(state)
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler.trace context."""
    import jax
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named span inside a trace (TraceAnnotation)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


def profile_dir() -> str | None:
    return os.environ.get("MARA3_PROFILE_DIR") or None
