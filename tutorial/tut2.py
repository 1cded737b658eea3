#!/usr/bin/env python3
"""Tutorial 2: array basics, the JAX way.

The reference's tutorial/tut2.cpp introduces its lazy array library
(ndarray-v2): arrays as shape + index->value mappings, composed with
`operator|` pipelines and evaluated on demand. Here the same ideas are
native jax:

- a traced jnp expression IS a lazy provider graph; jax.jit evaluates it
  once, fused, on the accelerator;
- immutability is the default; `.at[].set()` returns new arrays;
- the reference's nd:: one-liner operators live in mara3_tpu.core.ops.
"""

import jax
import jax.numpy as jnp

from mara3_tpu.core import ops

# --- create a simple array and loop over its values --------------------------
A = jnp.linspace(0.0, 1.0, 10)     # includes both end-points
print("A:", list(float(a) for a in A))

# --- lazy composition: nothing below computes anything yet inside jit --------
@jax.jit
def pipeline(x):
    # the reference writes: x | nd::map(f) | nd::difference_on_axis(0) | ...
    y = jnp.sin(2 * jnp.pi * x)
    dy = ops.difference_on_axis(y)          # adjacent differences
    mid = ops.midpoint_on_axis(y)           # adjacent midpoints
    return dy, mid

dy, mid = pipeline(A)
print("dy has", dy.shape[0], "entries; mid has", mid.shape[0])

# --- boundary extensions (guard zones) ---------------------------------------
u = jnp.array([1.0, 2.0, 3.0])
print("periodic:", ops.extend_periodic_on_axis(u, 1))
print("zero-gradient:", ops.extend_zero_gradient(u, 2))

# --- immutability / functional updates ---------------------------------------
B = jnp.zeros(5)
C = B.at[2].set(7.0)     # B is unchanged
assert float(B[2]) == 0.0 and float(C[2]) == 7.0

# --- evaluation happens when you ask for the numbers -------------------------
# (the analog of nd::to_shared(): pull to host / block on the result)
import numpy as np
print("materialized:", np.asarray(C))

print("tutorial 2 finished")
