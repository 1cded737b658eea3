"""Circumbinary-disk scheme core: the flagship hot path, fully jit-compiled.

Re-design of src/subprog_binary_scheme.cpp over the dense AMR block layout
(mesh/block_layout.py). One call to the compiled advance covers what the
reference fans over a thread pool per tree leaf (advance_u/advance_q,
subprog_binary_scheme.cpp:790-1020):

  recover_primitive -> guard exchange (prims + gradients) -> PLM face
  extrapolation -> HLLE + viscous flux -> coarse-fine flux correction ->
  gravity/sink/buffer/floor (+ geometric for Q) sources -> update,
  with all source-term totals reduced to scalars in-graph.

Both conservation formulations are supported: linear momentum U and angular
momentum Q (physics_iso2d.hpp:56-97), selected statically. Faults (negative
density, the reference's thrown exception at subprog_binary_scheme.cpp:
726-784) surface as a value-level flag for the host's safe-mode retry.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from mara3_tpu.mathx.plm import plm_gradient
from mara3_tpu.mesh import block_layout
from mara3_tpu.physics import iso2d


@dataclass(frozen=True)
class SchemeConfig:
    """Static scheme parameters (hashable; jit-static)."""
    block_size: int
    domain_radius: float
    mach_number: float
    softening_radius: float
    sink_radius: float
    sink_rate: float
    gst_suppr_radius: float
    density_floor: float
    alpha: float
    alpha_cutoff_radius: float
    nu: float
    axisymmetric_cs2: bool
    conserve_linear_p: bool
    reconstruct_method: str   # 'plm' or 'pcm'
    buffer_damping_rate: float = 10.0
    riemann: str = "hlle"     # 'hlle' (the reference's pinned choice,
                              # subprog_binary_solver_data.cpp:109) or
                              # 'hllc' (physics_iso2d.hpp:704-712)


# -----------------------------------------------------------------------------
# fields of the binary potential (subprog_binary_scheme.cpp:62-126)
# -----------------------------------------------------------------------------

def grav_vdot_field(x, body_pos, body_mass, softening_radius):
    """Softened gravitational acceleration -G M dr / (dr^2 + rs^2)^(3/2);
    x [..., 2], body_pos [2]."""
    dr = x - body_pos
    dr2 = dr[..., 0] ** 2 + dr[..., 1] ** 2
    rs2 = softening_radius ** 2
    return -dr * (body_mass / (dr2 + rs2) ** 1.5)[..., None]


def grav_phi_field(x, body_pos, body_mass, softening_radius):
    dr = x - body_pos
    dr2 = dr[..., 0] ** 2 + dr[..., 1] ** 2
    return -body_mass / jnp.sqrt(dr2 + softening_radius ** 2)


def sink_rate_field(x, sink_pos, sink_radius, sink_rate):
    """Gaussian sink kernel (subprog_binary_scheme.cpp:117-126)."""
    dr = x - sink_pos
    a2 = (dr[..., 0] ** 2 + dr[..., 1] ** 2) / sink_radius ** 2 / 2.0
    return sink_rate * jnp.exp(-a2)


def cs2_at_position(x, bodies, cfg: SchemeConfig):
    """Locally isothermal sound speed squared from the binary potential
    (or axisymmetric GM/r), subprog_binary_scheme.cpp:160-175.
    bodies: [2, 5] rows (mass, x, y, vx, vy)."""
    M2 = cfg.mach_number ** 2
    if cfg.axisymmetric_cs2:
        r = jnp.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        return 1.0 / r / M2
    phi1 = grav_phi_field(x, bodies[0, 1:3], bodies[0, 0],
                          cfg.softening_radius)
    phi2 = grav_phi_field(x, bodies[1, 1:3], bodies[1, 0],
                          cfg.softening_radius)
    return -(phi1 + phi2) / M2


def nu_at_position(x, cs2, cfg: SchemeConfig):
    """Alpha- or constant-nu viscosity with optional inner cutoff
    (subprog_binary_scheme.cpp:177-193)."""
    r = jnp.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    if cfg.alpha_cutoff_radius > 0.0:
        profile = 0.5 * (1.0 + jnp.tanh(3.0 * (r - cfg.alpha_cutoff_radius)))
    else:
        profile = jnp.ones_like(r)
    if cfg.nu > 0.0:
        return profile * cfg.nu
    scale_height = r / cfg.mach_number
    return profile * cfg.alpha * jnp.sqrt(cs2) * scale_height


def viscous_flux(axis, gl, gr, hl, hr, mu):
    """Shear-stress flux (subprog_binary_scheme.cpp:220-262). gl/gr are the
    longitudinal velocity gradients at the two adjacent cells, hl/hr the
    transverse ones; mu the face dynamic viscosity."""
    if axis == 0:
        dx_ux = 0.5 * (gl[..., 1] + gr[..., 1])
        dx_uy = 0.5 * (gl[..., 2] + gr[..., 2])
        dy_ux = 0.5 * (hl[..., 1] + hr[..., 1])
        dy_uy = 0.5 * (hl[..., 2] + hr[..., 2])
        tauxx = mu * (dx_ux - dy_uy)
        tauxy = mu * (dx_uy + dy_ux)
        z = jnp.zeros_like(mu)
        return jnp.stack([z, -tauxx, -tauxy], axis=-1)
    dx_ux = 0.5 * (hl[..., 1] + hr[..., 1])
    dx_uy = 0.5 * (hl[..., 2] + hr[..., 2])
    dy_ux = 0.5 * (gl[..., 1] + gr[..., 1])
    dy_uy = 0.5 * (gl[..., 2] + gr[..., 2])
    tauyx = mu * (dx_uy + dy_ux)
    tauyy = -mu * (dx_ux - dy_uy)
    z = jnp.zeros_like(mu)
    return jnp.stack([z, -tauyx, -tauyy], axis=-1)


# -----------------------------------------------------------------------------
# fluxes over blocks
# -----------------------------------------------------------------------------

def _faces_along(a, axis):
    """(left, right) cell values at the bs+1 faces along `axis` of
    guard-extended arrays [B, bs+2, ..]."""
    n = a.shape[1 + axis]
    index_l = [slice(None)] * a.ndim
    index_r = [slice(None)] * a.ndim
    index_l[1 + axis] = slice(0, n - 1)
    index_r[1 + axis] = slice(1, n)
    return a[tuple(index_l)], a[tuple(index_r)]


def block_fluxes(axis, p_ext, g_long_ext, g_tran_ext, xf, face_len, spacing,
                 bodies, cfg: SchemeConfig):
    """fhat * face_length at all faces along `axis`
    (block_fluxes_u, subprog_binary_scheme.cpp:452-500). spacing [B]."""
    pl, pr = _faces_along(p_ext, axis)
    gl, gr = _faces_along(g_long_ext, axis)
    hl, hr = _faces_along(g_tran_ext, axis)

    s = spacing[:, None, None, None]
    pl_hat = pl + gl * 0.5 * s
    pr_hat = pr - gr * 0.5 * s

    cs2 = cs2_at_position(xf, bodies, cfg)
    nu = nu_at_position(xf, cs2, cfg)
    mu = 0.5 * nu * (pl_hat[..., 0] + pr_hat[..., 0])

    nhat = (1.0, 0.0) if axis == 0 else (0.0, 1.0)
    solver = (iso2d.riemann_hllc if cfg.riemann == "hllc"
              else iso2d.riemann_hlle)
    fhat = solver(pl_hat, pr_hat, cs2, cs2, nhat)
    fhat = fhat + viscous_flux(axis, gl, gr, hl, hr, mu)
    return fhat * face_len[..., None]


def to_angmom_fluxes(axis, fhat, xf, domain_radius):
    """Linear-momentum fluxes -> (sigma, Sr, Lz) fluxes, with Lz flux zeroed
    at the domain boundary faces (subprog_binary_scheme.cpp:196-214)."""
    x0, x1 = xf[..., 0], xf[..., 1]
    fs = fhat[..., 0]
    fsr = x0 * fhat[..., 1] + x1 * fhat[..., 2]
    flz = x0 * fhat[..., 2] - x1 * fhat[..., 1]
    coord = x0 if axis == 0 else x1
    at_boundary = jnp.isclose(jnp.abs(coord), domain_radius)
    flz = jnp.where(at_boundary, 0.0, flz)
    return jnp.stack([fs, fsr, flz], axis=-1)


def correct_coarse_fine_fluxes(fhat, nt: block_layout.NeighborTable, axis):
    """Replace boundary flux strips adjacent to *finer* neighbors with the
    pairwise-summed (restrict_extrinsic) fine fluxes through the shared face
    (correct_fluxes_{xl,xr,yl,yr}, subprog_binary_scheme.cpp:614-720).
    fhat: [B, bs+1, bs, C] for axis 0 / [B, bs, bs+1, C] for axis 1."""
    C = fhat.shape[-1]
    perp = 1 - axis

    def edge_col(Fg, side):
        # boundary flux strip of gathered blocks, keeping strip shape
        n = Fg.shape[1 + axis]
        index = [slice(None)] * Fg.ndim
        index[1 + axis] = 0 if side == 0 else n - 1
        return Fg[tuple(index)]   # [B, bs, C]

    out = fhat
    for side in (0, 1):
        f = 2 * axis + side
        fine0 = jnp.asarray(nt.fine_id[:, f, 0])
        fine1 = jnp.asarray(nt.fine_id[:, f, 1])
        # fine neighbors' flux through my face = their opposite-side strip
        c0 = edge_col(fhat[fine0], 1 - side)   # [B, bs, C]
        c1 = edge_col(fhat[fine1], 1 - side)
        stitched = jnp.concatenate([c0, c1], axis=1)      # [B, 2 bs, C]
        corrected = stitched[:, 0::2] + stitched[:, 1::2]  # restrict_extrinsic
        mask = jnp.asarray(nt.case[:, f] == 2)[:, None, None]
        n = fhat.shape[1 + axis]
        pos = 0 if side == 0 else n - 1
        index = [slice(None)] * fhat.ndim
        index[1 + axis] = pos
        current = out[tuple(index)]
        out = out.at[tuple(index)].set(jnp.where(mask, corrected, current))
    return out


# -----------------------------------------------------------------------------
# source terms (subprog_binary_scheme.cpp:337-450)
# -----------------------------------------------------------------------------

def _lz_of_u(u, xc):
    return xc[..., 0] * u[..., 2] - xc[..., 1] * u[..., 1]


def source_terms(u0, p0, xc, dA, br, initial_conserved, bodies, dt,
                 cfg: SchemeConfig):
    """Returns (s_total [B,bs,bs,3] with dt applied, totals dict of scalars).
    Covers both formulations (source_terms_u/_q)."""
    b1, b2 = bodies[0], bodies[1]
    sigma = u0[..., 0]

    fg1 = grav_vdot_field(xc, b1[1:3], b1[0], cfg.softening_radius) \
        * sigma[..., None]
    fg2 = grav_vdot_field(xc, b2[1:3], b2[0], cfg.softening_radius) \
        * sigma[..., None]

    if cfg.conserve_linear_p:
        def force_to_source(f):
            z = jnp.zeros_like(f[..., 0])
            return jnp.stack([z, f[..., 0], f[..., 1]], axis=-1)
    else:
        def force_to_source(f):
            z = jnp.zeros_like(f[..., 0])
            sr = xc[..., 0] * f[..., 0] + xc[..., 1] * f[..., 1]
            lz = xc[..., 0] * f[..., 1] - xc[..., 1] * f[..., 0]
            return jnp.stack([z, sr, lz], axis=-1)

    s_grav_1 = force_to_source(fg1) * dt
    s_grav_2 = force_to_source(fg2) * dt
    sink1 = sink_rate_field(xc, b1[1:3], cfg.sink_radius, cfg.sink_rate)
    sink2 = sink_rate_field(xc, b2[1:3], cfg.sink_radius, cfg.sink_rate)
    s_sink_1 = -u0 * sink1[..., None] * dt
    s_sink_2 = -u0 * sink2[..., None] * dt
    s_buffer = (initial_conserved - u0) * br[..., None] * dt
    s_floor = u0 * 1e-2 * (u0[..., 0] < cfg.density_floor)[..., None]

    def tot(a):
        return jnp.sum(a * dA)

    if cfg.conserve_linear_p:
        lz_sink_1 = _lz_of_u(s_sink_1, xc)
        lz_sink_2 = _lz_of_u(s_sink_2, xc)
        lz_grav_1 = _lz_of_u(s_grav_1, xc)
        lz_grav_2 = _lz_of_u(s_grav_2, xc)
        lz_buffer = _lz_of_u(s_buffer, xc)
        dp1 = s_sink_1[..., 1:3]
        dp2 = s_sink_2[..., 1:3]
    else:
        lz_sink_1 = s_sink_1[..., 2]
        lz_sink_2 = s_sink_2[..., 2]
        lz_grav_1 = s_grav_1[..., 2]
        lz_grav_2 = s_grav_2[..., 2]
        lz_buffer = s_buffer[..., 2]
        u_sink_1 = iso2d.to_conserved_per_area_from_angmom(s_sink_1, xc)
        u_sink_2 = iso2d.to_conserved_per_area_from_angmom(s_sink_2, xc)
        dp1 = u_sink_1[..., 1:3]
        dp2 = u_sink_2[..., 1:3]

    totals = {
        "mass_accreted_on": jnp.stack([-tot(s_sink_1[..., 0]),
                                       -tot(s_sink_2[..., 0])]),
        "angular_momentum_accreted_on": jnp.stack([-tot(lz_sink_1),
                                                   -tot(lz_sink_2)]),
        "integrated_torque_on": jnp.stack([-tot(lz_grav_1), -tot(lz_grav_2)]),
        "momentum_x_accreted_on": jnp.stack([-tot(dp1[..., 0]),
                                             -tot(dp2[..., 0])]),
        "momentum_y_accreted_on": jnp.stack([-tot(dp1[..., 1]),
                                             -tot(dp2[..., 1])]),
        "integrated_force_x_on": jnp.stack([-tot(fg1[..., 0] * dt),
                                            -tot(fg2[..., 0] * dt)]),
        "integrated_force_y_on": jnp.stack([-tot(fg1[..., 1] * dt),
                                            -tot(fg2[..., 1] * dt)]),
        "mass_ejected": -tot(s_buffer[..., 0]),
        "angular_momentum_ejected": -tot(lz_buffer),
    }

    s = s_grav_1 + s_grav_2 + s_sink_1 + s_sink_2 + s_buffer + s_floor

    if not cfg.conserve_linear_p:
        # geometric Sr source with near-origin ramp suppression
        # (source_terms_q, subprog_binary_scheme.cpp:421-431)
        sr2 = cfg.gst_suppr_radius ** 2
        r2 = xc[..., 0] ** 2 + xc[..., 1] ** 2
        ramp = 1.0 - jnp.exp(-r2 / sr2)
        cs2 = cs2_at_position(xc, bodies, cfg)
        s_geom = iso2d.source_terms_conserved_angmom(p0, cs2) \
            * (ramp * dt)[..., None]
        s = s + s_geom

    # work done by accretion (subprog_binary_scheme.cpp:394-409)
    for k, (b, dM, dpx, dpy) in enumerate([
            (b1, totals["mass_accreted_on"][0],
             totals["momentum_x_accreted_on"][0],
             totals["momentum_y_accreted_on"][0]),
            (b2, totals["mass_accreted_on"][1],
             totals["momentum_x_accreted_on"][1],
             totals["momentum_y_accreted_on"][1])]):
        M0 = b[0]
        px0, py0 = M0 * b[3], M0 * b[4]
        M1 = M0 + dM
        px1, py1 = px0 + dpx, py0 + dpy
        w = 0.5 * ((px1 ** 2 + py1 ** 2) / M1 - (px0 ** 2 + py0 ** 2) / M0)
        totals.setdefault("work_done_on_list", []).append(w)
    totals["work_done_on"] = jnp.stack(totals.pop("work_done_on_list"))

    return s, totals


# -----------------------------------------------------------------------------
# the advance core
# -----------------------------------------------------------------------------

def _work_done(totals, bodies):
    """Accretion work on each body from the accounting totals
    (subprog_binary_scheme.cpp:394-409)."""
    ws = []
    for k in range(2):
        M0 = bodies[k, 0]
        px0, py0 = M0 * bodies[k, 3], M0 * bodies[k, 4]
        dM = totals["mass_accreted_on"][k]
        dpx = totals["momentum_x_accreted_on"][k]
        dpy = totals["momentum_y_accreted_on"][k]
        M1 = M0 + dM
        px1, py1 = px0 + dpx, py0 + dpy
        ws.append(0.5 * ((px1 ** 2 + py1 ** 2) / M1
                         - (px0 ** 2 + py0 ** 2) / M0))
    return jnp.stack(ws)


def make_advance(cfg: SchemeConfig, nt: block_layout.NeighborTable,
                 geometry, initial_conserved, buffer_rate):
    """Build the jit-compiled advance. `geometry` is (xc [B,bs,bs,2],
    dA [B,bs,bs], spacing [B], xf [B,bs+1,bs,2], yf [B,bs,bs+1,2]).
    Returns advance(u, bodies, dt, plm_theta) -> (u1, totals, invalid);
    ``advance.traced`` is the un-jitted body for callers that compose it
    into a larger program (schemes/binary_step.py)."""
    xc, dA, spacing, xf, yf = (jnp.asarray(a) for a in geometry)
    initial_conserved = jnp.asarray(initial_conserved)
    buffer_rate = jnp.asarray(buffer_rate)
    dAp = dA[..., None]
    # face lengths (uniform square cells: the block spacing)
    face_len_x = jnp.broadcast_to(spacing[:, None, None], xf.shape[:-1])
    face_len_y = jnp.broadcast_to(spacing[:, None, None], yf.shape[:-1])
    # one-gather guard exchange tables (the masked-select path costs ~20
    # XLA ops per extend)
    gg = block_layout.build_guard_gather(nt, cfg.block_size)

    def advance_impl(u0, bodies, dt, plm_theta):
        # plm_theta may be a traced scalar (the in-graph safe-mode retry
        # passes 0.0, which zeroes the limited slopes — first order)
        if cfg.conserve_linear_p:
            p0 = iso2d.recover_primitive(u0)
        else:
            p0 = iso2d.recover_primitive_angmom(u0, xc)

        p0_ex = block_layout.extend_blocks_fast(p0, gg, axis=0)
        p0_ey = block_layout.extend_blocks_fast(p0, gg, axis=1)

        if cfg.reconstruct_method == "plm":
            sp = spacing[:, None, None, None]
            gx = plm_gradient(p0_ex[:, :-2], p0_ex[:, 1:-1], p0_ex[:, 2:],
                              plm_theta) / sp
            gy = plm_gradient(p0_ey[:, :, :-2], p0_ey[:, :, 1:-1],
                              p0_ey[:, :, 2:], plm_theta) / sp
        else:
            gx = jnp.zeros_like(p0)
            gy = jnp.zeros_like(p0)

        # both gradient fields extended with one gather per axis
        G = jnp.concatenate([gx, gy], axis=-1)
        G_ex = block_layout.extend_blocks_fast(G, gg, axis=0)
        G_ey = block_layout.extend_blocks_fast(G, gg, axis=1)
        nc = p0.shape[-1]
        gx_ex, gy_ex = G_ex[..., :nc], G_ex[..., nc:]
        gx_ey, gy_ey = G_ey[..., :nc], G_ey[..., nc:]

        fx = block_fluxes(0, p0_ex, gx_ex, gy_ex, xf, face_len_x,
                          spacing, bodies, cfg)
        fy = block_fluxes(1, p0_ey, gy_ey, gx_ey, yf, face_len_y,
                          spacing, bodies, cfg)
        if not cfg.conserve_linear_p:
            fx = to_angmom_fluxes(0, fx, xf, cfg.domain_radius)
            fy = to_angmom_fluxes(1, fy, yf, cfg.domain_radius)

        fx = correct_coarse_fine_fluxes(fx, nt, axis=0)
        fy = correct_coarse_fine_fluxes(fy, nt, axis=1)

        s, totals = source_terms(u0, p0, xc, dA, buffer_rate,
                                 initial_conserved, bodies, dt, cfg)

        lx = fx[:, 1:] - fx[:, :-1]
        ly = fy[:, :, 1:] - fy[:, :, :-1]
        u1 = u0 - (lx + ly) * dt / dAp + s

        invalid = jnp.any(jnp.logical_or(u1[..., 0] < 0.0,
                                         jnp.isnan(u1[..., 0])))
        return u1, totals, invalid

    jitted = jax.jit(advance_impl)

    def advance(u0, bodies, dt, plm_theta):
        return jitted(u0, bodies, dt, plm_theta)

    advance.traced = advance_impl
    return advance


def make_maximum_timestep(cfg: SchemeConfig, geometry):
    """Global min over blocks of spacing / max wavespeed
    (binary::maximum_timestep, subprog_binary_scheme.cpp:1107-1126)."""
    xc, dA, spacing, xf, yf = (jnp.asarray(a) for a in geometry)

    @jax.jit
    def maximum_timestep(u0, bodies):
        if cfg.conserve_linear_p:
            p0 = iso2d.recover_primitive(u0)
        else:
            p0 = iso2d.recover_primitive_angmom(u0, xc)
        cs2 = cs2_at_position(xc, bodies, cfg)
        a = iso2d.max_wavespeed(p0, cs2)
        block_dt = spacing / jnp.max(a, axis=(1, 2))
        return jnp.min(block_dt)

    return maximum_timestep
