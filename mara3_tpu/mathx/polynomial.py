"""Closed-form cubic/quartic roots and parabola vertex.

Re-design of src/math_polynomial.hpp:52-215. Vectorized over jnp arrays with
branchless `where` selection (jit-friendly: every branch is computed, the
mask picks). Returns the same root multiplicity conventions as the reference:
cubic -> (x1, x2, x3, num_roots), quartic -> (x1..x4, pair1_real, pair2_real).

The parabola vertex supplies sub-cell shock interpolation for the sedov
shock-tracking time series (reference subprog_sedov.cpp:276-308).
"""

from __future__ import annotations

import jax.numpy as jnp


def _cbrt_signed(x):
    return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)


def cubic_roots(c3, c2, c1, c0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0 (reference
    math_polynomial.hpp:72-120). Returns (x1, x2, x3, num_roots)."""
    a2 = c2 / c3
    a1 = c1 / c3
    a0 = c0 / c3
    q = a1 / 3.0 - a2 * a2 / 9.0
    r = (a1 * a2 - 3.0 * a0) / 6.0 - a2 ** 3 / 27.0
    delta = q ** 3 + r * r

    # delta > 0: one real root
    sq_dp = jnp.sqrt(jnp.maximum(delta, 0.0))
    s1 = _cbrt_signed(r + sq_dp)
    s2 = _cbrt_signed(r - sq_dp)
    x1_pos = (s1 + s2) - a2 / 3.0
    x2_pos = -0.5 * (s1 + s2) - a2 / 3.0

    # delta < 0: three distinct real roots (trigonometric form)
    mq = jnp.maximum(-q, 1e-300)
    arg = jnp.clip(r / jnp.sqrt(mq ** 3), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    costh, sinth = jnp.cos(theta), jnp.sin(theta)
    sq = jnp.sqrt(mq)
    x1_neg = 2.0 * sq * costh - a2 / 3.0
    x2_neg = -sq * costh - a2 / 3.0 - jnp.sqrt(3.0) * sq * sinth
    x3_neg = -sq * costh - a2 / 3.0 + jnp.sqrt(3.0) * sq * sinth

    # delta == 0: repeated real roots
    s = _cbrt_signed(r)
    x1_zero = 2.0 * s - a2 / 3.0
    x2_zero = -s - a2 / 3.0

    pos, neg = delta > 0.0, delta < 0.0
    x1 = jnp.where(pos, x1_pos, jnp.where(neg, x1_neg, x1_zero))
    x2 = jnp.where(pos, x2_pos, jnp.where(neg, x2_neg, x2_zero))
    x3 = jnp.where(pos, x2_pos, jnp.where(neg, x3_neg, x2_zero))
    num_roots = jnp.where(pos, 1, 3)
    return x1, x2, x3, num_roots


def quartic_roots(d4, d3, d2, d1, d0):
    """Real roots of a quartic via the resolvent cubic (reference
    math_polynomial.hpp:130-200). Returns (x1, x2, x3, x4, pair1_real,
    pair2_real)."""
    a3 = d3 / d4
    a2 = d2 / d4
    a1 = d1 / d4
    a0 = d0 / d4
    au2 = -a2
    au1 = (a1 * a3 - 4.0 * a0)
    au0 = 4.0 * a0 * a2 - a1 * a1 - a0 * a3 * a3

    x1c, _, x3c, nc = cubic_roots(jnp.ones_like(a3), au2, au1, au0)
    u1 = jnp.where(nc == 1, x1c, jnp.maximum(x1c, x3c))
    R2 = 0.25 * a3 * a3 + u1 - a2
    R = jnp.where(R2 > 0.0, jnp.sqrt(jnp.maximum(R2, 0.0)), 0.0)

    nonzero_R = R != 0.0
    f_r = 0.75 * a3 * a3 - R2 - 2.0 * a2
    g_r = 0.25 * (4.0 * a3 * a2 - 8.0 * a1 - a3 ** 3) / jnp.where(
        nonzero_R, R, 1.0)
    f_0 = 0.75 * a3 * a3 - 2.0 * a2
    g_0 = 2.0 * jnp.sqrt(jnp.maximum(u1 * u1 - 4.0 * a0, 0.0))
    D2 = jnp.where(nonzero_R, f_r + g_r, f_0 + g_0)
    E2 = jnp.where(nonzero_R, f_r - g_r, f_0 - g_0)

    D = jnp.sqrt(jnp.maximum(D2, 0.0))
    E = jnp.sqrt(jnp.maximum(E2, 0.0))
    pair1 = D2 >= 0.0
    pair2 = E2 >= 0.0
    x1 = jnp.where(pair1, -0.25 * a3 + 0.5 * R - 0.5 * D, -0.25 * a3 + 0.5 * R)
    x2 = jnp.where(pair1, -0.25 * a3 + 0.5 * R + 0.5 * D, -0.25 * a3 + 0.5 * R)
    x3 = jnp.where(pair2, -0.25 * a3 - 0.5 * R - 0.5 * E, -0.25 * a3 - 0.5 * R)
    x4 = jnp.where(pair2, -0.25 * a3 - 0.5 * R + 0.5 * E, -0.25 * a3 + 0.5 * R)
    return x1, x2, x3, x4, pair1, pair2


def parabola_vertex(x1, x2, x3, y1, y2, y3):
    """Vertex (x, y) of the parabola through three points (reference
    math_polynomial.hpp:208-215)."""
    d = (x1 - x2) * (x1 - x3) * (x2 - x3)
    A = (x3 * (y2 - y1) + x2 * (y1 - y3) + x1 * (y3 - y2)) / d
    B = (x3 * x3 * (y1 - y2) + x2 * x2 * (y3 - y1) + x1 * x1 * (y2 - y3)) / d
    C = (x2 * x3 * (x2 - x3) * y1 + x3 * x1 * (x3 - x1) * y2
         + x1 * x2 * (x1 - x2) * y3) / d
    return -B / (2.0 * A), C - B * B / (4.0 * A)
