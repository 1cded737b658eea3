"""Test harness configuration.

Runs every test on CPU with 8 virtual XLA devices (so the multi-device
sharding paths are exercised without accelerator hardware, per SURVEY.md
§4) and with x64 enabled for round-off-level parity with the float64 C++
reference. Must run before jax initializes, hence the env mutation at
import time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
