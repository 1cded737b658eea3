"""Explicit-collective distributed flagship advance.

The circumbinary AMR advance under `shard_map` over a "blocks" mesh axis:
Hilbert-ordered leaf blocks are sharded contiguously, and only *thin* data
crosses shards —

  - the 4 candidate edge rows/columns of every block (for the guard
    exchange with on-the-fly prolong/restrict), and
  - the boundary flux strips (for the coarse-fine flux correction),

both via `jax.lax.all_gather` over the mesh axis (the collective analog
of the reference's per-rank guard messages, core_mpi.hpp:533-637, chosen
over pairwise ppermute because an AMR neighbor table addresses arbitrary
shards). Accounting totals reduce with psum; the fault flag with a global
max. Per-block arithmetic is identical to the unsharded edge-based
advance, so adding devices does not change bits (asserted by
__graft_entry__.dryrun_multichip phase 3 and tests/test_parallel.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from mara3_tpu.mesh import block_layout
from mara3_tpu.physics import iso2d
from mara3_tpu.mathx.plm import plm_gradient
from mara3_tpu.schemes.binary_scheme import (SchemeConfig, _work_done,
                                             block_fluxes, source_terms,
                                             to_angmom_fluxes)


@dataclass(frozen=True)
class _LocalTable:
    """This shard's rows of the neighbor table (ids stay global)."""
    case: jax.Array
    same_id: jax.Array
    coarse_id: jax.Array
    coarse_half: jax.Array
    fine_id: jax.Array


def _edges(a, axis):
    """[Bl, C, 4, bs] tensor of rows/cols (0, 1, bs-2, bs-1) along `axis`
    of component-last blocks [Bl, bs, bs, C] (the input shape
    guard_strips_from_edges consumes)."""
    bs = a.shape[1 + axis]
    if axis == 0:
        rows = [a[:, r] for r in (0, 1, bs - 2, bs - 1)]
    else:
        rows = [a[:, :, r] for r in (0, 1, bs - 2, bs - 1)]
    return jnp.stack(rows, axis=1).transpose(0, 3, 1, 2)


def _extend_from_strips(a, lo, hi, axis):
    """Extend [Bl, bs, bs, C] by the [Bl, C, bs] guard strips."""
    lo = lo.transpose(0, 2, 1)   # [Bl, bs, C]
    hi = hi.transpose(0, 2, 1)
    if axis == 0:
        return jnp.concatenate([lo[:, None], a, hi[:, None]], axis=1)
    return jnp.concatenate([lo[:, :, None], a, hi[:, :, None]], axis=2)


def make_advance_block_sharded(cfg: SchemeConfig, nt, geometry,
                               initial_conserved, buffer_rate, mesh,
                               axis_name: str = "blocks"):
    """advance(u_sharded, bodies, dt, plm_theta) -> (u1, totals, invalid)
    with u sharded [B, bs, bs, C] over `axis_name` of `mesh`."""
    xc, dA, spacing, xf, yf = (jnp.asarray(a) for a in geometry)
    initial_conserved = jnp.asarray(initial_conserved)
    buffer_rate = jnp.asarray(buffer_rate)
    bs = cfg.block_size
    B = xc.shape[0]
    n = mesh.shape[axis_name]
    assert B % n == 0, (B, n)
    Bl = B // n
    case = jnp.asarray(nt.case)
    same_id = jnp.asarray(nt.same_id)
    coarse_id = jnp.asarray(nt.coarse_id)
    coarse_half = jnp.asarray(nt.coarse_half)
    fine_id = jnp.asarray(nt.fine_id)

    def local_advance(u_loc, bodies, dt, plm_theta):
        idx = jax.lax.axis_index(axis_name)
        start = idx * Bl

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, start, Bl, axis=0)

        xc_l, dA_l, sp_l, xf_l, yf_l = sl(xc), sl(dA), sl(spacing), \
            sl(xf), sl(yf)
        ntl = _LocalTable(sl(case), sl(same_id), sl(coarse_id),
                          sl(coarse_half), sl(fine_id))

        if cfg.conserve_linear_p:
            p0 = iso2d.recover_primitive(u_loc)
        else:
            p0 = iso2d.recover_primitive_angmom(u_loc, xc_l)

        def extend(a, axis):
            e = jax.lax.all_gather(_edges(a, axis), axis_name, axis=0,
                                   tiled=True)
            lo, hi = block_layout.guard_strips_from_edges(e, ntl, axis)
            return _extend_from_strips(a, lo, hi, axis)

        p0_ex = extend(p0, 0)
        p0_ey = extend(p0, 1)

        if cfg.reconstruct_method == "plm":
            sp = sp_l[:, None, None, None]
            gx = plm_gradient(p0_ex[:, :-2], p0_ex[:, 1:-1], p0_ex[:, 2:],
                              plm_theta) / sp
            gy = plm_gradient(p0_ey[:, :, :-2], p0_ey[:, :, 1:-1],
                              p0_ey[:, :, 2:], plm_theta) / sp
        else:
            gx = jnp.zeros_like(p0)
            gy = jnp.zeros_like(p0)

        G = jnp.concatenate([gx, gy], axis=-1)
        G_ex = extend(G, 0)
        G_ey = extend(G, 1)
        nc = p0.shape[-1]
        gx_ex, gy_ex = G_ex[..., :nc], G_ex[..., nc:]
        gx_ey, gy_ey = G_ey[..., :nc], G_ey[..., nc:]

        face_len_x = jnp.broadcast_to(sp_l[:, None, None], xf_l.shape[:-1])
        face_len_y = jnp.broadcast_to(sp_l[:, None, None], yf_l.shape[:-1])
        fx = block_fluxes(0, p0_ex, gx_ex, gy_ex, xf_l, face_len_x, sp_l,
                          bodies, cfg)
        fy = block_fluxes(1, p0_ey, gy_ey, gx_ey, yf_l, face_len_y, sp_l,
                          bodies, cfg)
        if not cfg.conserve_linear_p:
            fx = to_angmom_fluxes(0, fx, xf_l, cfg.domain_radius)
            fy = to_angmom_fluxes(1, fy, yf_l, cfg.domain_radius)

        def correct(fhat, axis):
            # same math as schemes.binary_scheme.correct_coarse_fine_fluxes,
            # with the fine neighbors' boundary strips arriving by
            # all_gather instead of array adjacency
            nfaces = fhat.shape[1 + axis]

            def strip(pos):
                index = [slice(None)] * fhat.ndim
                index[1 + axis] = pos
                return fhat[tuple(index)]

            e_loc = jnp.stack([strip(0), strip(nfaces - 1)], axis=1)
            e_glob = jax.lax.all_gather(e_loc, axis_name, axis=0,
                                        tiled=True)   # [B, 2, bs, C]
            out = fhat
            for side in (0, 1):
                f = 2 * axis + side
                c0 = e_glob[ntl.fine_id[:, f, 0], 1 - side]
                c1 = e_glob[ntl.fine_id[:, f, 1], 1 - side]
                stitched = jnp.concatenate([c0, c1], axis=1)
                corrected = stitched[:, 0::2] + stitched[:, 1::2]
                mask = (ntl.case[:, f] == 2)[:, None, None]
                pos = 0 if side == 0 else nfaces - 1
                index = [slice(None)] * fhat.ndim
                index[1 + axis] = pos
                current = out[tuple(index)]
                out = out.at[tuple(index)].set(
                    jnp.where(mask, corrected, current))
            return out

        fx = correct(fx, 0)
        fy = correct(fy, 1)

        s, totals = source_terms(u_loc, p0, xc_l, dA_l, sl(buffer_rate),
                                 sl(initial_conserved), bodies, dt, cfg)
        # the accounting totals are linear sums -> psum across shards; the
        # accretion work is nonlinear in the totals, so recompute it from
        # the global sums (matches the unsharded _work_done exactly)
        totals.pop("work_done_on")
        totals = {k: jax.lax.psum(v, axis_name) for k, v in totals.items()}
        totals["work_done_on"] = _work_done(totals, bodies)

        lx = fx[:, 1:] - fx[:, :-1]
        ly = fy[:, :, 1:] - fy[:, :, :-1]
        u1 = u_loc - (lx + ly) * dt / dA_l[..., None] + s

        bad = jnp.any(jnp.logical_or(u1[..., 0] < 0.0,
                                     jnp.isnan(u1[..., 0])))
        invalid = jax.lax.pmax(bad.astype(jnp.int32), axis_name) > 0
        return u1, totals, invalid

    sharded = jax.shard_map(
        local_advance, mesh=mesh,
        in_specs=(P(axis_name), P(), P(), P()),
        out_specs=(P(axis_name), P(), P()),
        check_vma=False)
    return jax.jit(sharded)
