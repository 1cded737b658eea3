"""Benchmark: zone-updates per second of the uniform-grid iso2d step.

Runs the jnp PLM + HLLE scheme (schemes/iso2d_grid.py, the kh subprogram's
advance) on a 2048^2 periodic grid in f32 and prints ONE JSON line naming
the device it ran on. It exits non-zero without a measurement when JAX
finds no accelerator: a rate taken on the CPU is not this benchmark's
number.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

N = 2048


def initial_state():
    x = jnp.linspace(-1, 1, N, dtype=jnp.float32)[:, None]
    y = jnp.linspace(-1, 1, N, dtype=jnp.float32)[None, :]
    sigma = 1.0 + 0.5 * jnp.exp(-(x ** 2 + y ** 2) / 0.1)
    vx = 0.1 * jnp.sin(2 * jnp.pi * y) * jnp.ones_like(sigma)
    vy = -0.1 * jnp.sin(2 * jnp.pi * x) * jnp.ones_like(sigma)
    return jnp.stack([sigma, sigma * vx, sigma * vy], axis=-1)


def measure(advance, n1: int, n2: int, pairs: int = 5):
    """Marginal step rate between two step counts (the difference cancels
    dispatch overhead): the median of `pairs` estimates and their
    relative spread. Each timing ends in block_until_ready."""
    out = np.asarray(advance(n1))              # compile + warm up
    if not np.isfinite(out).all():
        raise FloatingPointError("non-finite benchmark state")

    def once(n):
        t0 = time.perf_counter()
        jax.block_until_ready(advance(n))
        return time.perf_counter() - t0

    rates = []
    for _ in range(pairs):
        t1 = min(once(n1) for _ in range(2))
        t2 = min(once(n2) for _ in range(2))
        rates.append(N * N * (n2 - n1) / max(t2 - t1, 1e-9))
    rates.sort()
    median = rates[len(rates) // 2]
    return median, (rates[-1] - rates[0]) / median


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: no accelerator visible to JAX", file=sys.stderr)
        return 1
    from mara3_tpu.subprograms import kh

    u = initial_state()
    dx = 2.0 / N
    kw = dict(cs2=0.1, dx=dx, dy=dx, dt=0.4 * dx, theta=1.8)
    zps, spread = measure(lambda n: kh.advance_n(u, n, **kw), 20, 220)
    print(json.dumps({
        "metric": f"zone_updates_per_second_iso2d_{N}_jnp",
        "value": zps,
        "unit": "zones/s",
        "spread_pct": round(100.0 * spread, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
