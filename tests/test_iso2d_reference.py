"""The uniform-grid iso2d step (schemes/iso2d_grid.py) against an
independent NumPy float64 reference.

The reference below is written from the scheme's definition, not from the
jnp code: periodic neighbours by np.roll, the generalized-minmod PLM slope
(math_interpolation.hpp:85-97), the isothermal HLLE and HLLC fluxes
(physics_iso2d.hpp:488-712, Toro 3rd ed. sec 10.6), an unsplit flux
divergence, and Heun averaging for RK2 (subprog_binary.cpp:272-275). It is
the plain reference the accelerator path is held to on every backend.
"""

import numpy as np
import pytest

from mara3_tpu.schemes import iso2d_grid


def _sgn(x):
    return np.where(x >= 0.0, 1.0, -1.0)


def _slope(yl, y0, yr, theta):
    a = (y0 - yl) * theta
    b = (yr - yl) * 0.5
    c = (yr - y0) * theta
    m = np.minimum(np.minimum(np.abs(a), np.abs(b)), np.abs(c))
    return 0.25 * np.abs(_sgn(a) + _sgn(b)) * (_sgn(a) + _sgn(c)) * m


def _flux(s, vx, vy, cs2, n):
    vn = vx if n == 0 else vy
    p = s * cs2
    return np.stack([s * vn, s * vn * vx + p * (n == 0),
                     s * vn * vy + p * (n == 1)], axis=-1)


def _hlle(L, R, cs2, n):
    cs = np.sqrt(cs2)
    vl, vr = L[..., 1 + n], R[..., 1 + n]
    ap = np.maximum(0.0, np.maximum(vl + cs, vr + cs))[..., None]
    am = np.minimum(0.0, np.minimum(vl - cs, vr - cs))[..., None]
    Ul = np.stack([L[..., 0], L[..., 0] * L[..., 1], L[..., 0] * L[..., 2]],
                  axis=-1)
    Ur = np.stack([R[..., 0], R[..., 0] * R[..., 1], R[..., 0] * R[..., 2]],
                  axis=-1)
    Fl = _flux(L[..., 0], L[..., 1], L[..., 2], cs2, n)
    Fr = _flux(R[..., 0], R[..., 1], R[..., 2], cs2, n)
    return (Fl * ap - Fr * am - (Ul - Ur) * ap * am) / (ap - am)


def _hllc(L, R, cs2, n):
    a = np.sqrt(cs2)
    sl_, sr_ = L[..., 0], R[..., 0]
    ul, ur = L[..., 1 + n], R[..., 1 + n]
    pl, pr = sl_ * cs2, sr_ * cs2
    pstar = np.maximum(0.0, 0.5 * (pl + pr)
                       - 0.5 * (ur - ul) * 0.5 * (sl_ + sr_) * a)
    Sl = ul - a * np.maximum(1.0, np.sqrt(pstar / pl))
    Sr = ur + a * np.maximum(1.0, np.sqrt(pstar / pr))
    Ss = ((pr - pl + ul * sl_ * (Sl - ul) - ur * sr_ * (Sr - ur))
          / (sl_ * (Sl - ul) - sr_ * (Sr - ur)))

    def side(P, S, u):
        s = P[..., 0]
        U = np.stack([s, s * P[..., 1], s * P[..., 2]], axis=-1)
        F = _flux(s, P[..., 1], P[..., 2], cs2, n)
        d = s * (S - u) / (S - Ss)
        vt = P[..., 2 - n]                      # tangential velocity
        Us = np.empty_like(U)
        Us[..., 0] = d
        Us[..., 1 + n] = d * Ss
        Us[..., 2 - n] = d * vt
        return F, F + (Us - U) * S[..., None]

    Fl, Fls = side(L, Sl, ul)
    Fr, Frs = side(R, Sr, ur)
    return np.where((Sl >= 0.0)[..., None], Fl,
           np.where((Ss >= 0.0)[..., None], Fls,
           np.where((Sr >= 0.0)[..., None], Frs, Fr)))


def reference_step(u, cs2, dx, dy, dt, theta, riemann):
    P = np.stack([u[..., 0], u[..., 1] / u[..., 0], u[..., 2] / u[..., 0]],
                 axis=-1)
    solve = _hlle if riemann == "hlle" else _hllc
    du = np.zeros_like(u)
    for n, h in ((0, dx), (1, dy)):
        g = _slope(np.roll(P, 1, n), P, np.roll(P, -1, n), theta)
        L = P + 0.5 * g                           # left state of face i+1/2
        R = np.roll(P - 0.5 * g, -1, n)           # right state of face i+1/2
        F = solve(L, R, cs2, n)
        du -= (F - np.roll(F, 1, n)) / h
    return u + dt * du


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    s = 1.0 + 0.5 * rng.random(shape)
    vx = 0.6 * (rng.random(shape) - 0.5)
    vy = 0.6 * (rng.random(shape) - 0.5)
    return np.stack([s, s * vx, s * vy], axis=-1)


@pytest.mark.parametrize("shape", [(16, 12), (9, 20)])
@pytest.mark.parametrize("theta", [0.0, 1.5, 2.0])
@pytest.mark.parametrize("rk_order", [1, 2])
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
def test_step_matches_numpy_reference(riemann, rk_order, theta, shape):
    u0 = _state(shape, seed=shape[0] + 7 * shape[1])
    cs2, dx, dy = 0.7, 1.0 / shape[0], 1.0 / shape[1]
    dt = 0.2 * min(dx, dy) / (0.3 + np.sqrt(cs2))
    args = (cs2, dx, dy, dt, theta, riemann)

    if rk_order == 1:
        got = iso2d_grid.step_periodic_uniform(u0, *args)
        want = reference_step(u0, *args)
    else:
        got = iso2d_grid.step_periodic_uniform_rk2(u0, *args)
        want = 0.5 * (u0 + reference_step(reference_step(u0, *args), *args))
    got = np.asarray(got)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    # the update really moved the state: a wrong sign or a dropped axis
    # would not pass the comparison above by accident
    assert np.abs(want - u0).max() > 1e-4
