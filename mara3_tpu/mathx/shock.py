"""Post-shock locator diagnostics for 1d profiles.

Re-design of src/post_shock_locator.hpp:74-152. The reference walks indices
with data-dependent while loops; here each locator is a fixed-shape masked
scan so it stays jit-compatible (jit rule: no data-dependent Python control
flow). Semantics match the reference on the profiles it targets.
"""

from __future__ import annotations

import jax.numpy as jnp

from mara3_tpu.core.ops import difference_on_axis


def find_shock_index(specific_entropy_1d):
    """Index of the sharpest entropy drop: argmin of ds (reference
    find_shock_index, post_shock_locator.hpp:74-80, which takes the entropy
    from the primitive state; pass s = log(p / rho^gamma))."""
    ds = difference_on_axis(specific_entropy_1d, 0)
    return jnp.argmin(ds)


def find_index_of_maximum_behind(array_1d, index):
    """Walk left from `index` while values keep increasing leftward
    (reference post_shock_locator.hpp:100-118): returns the index of the
    local maximum at or behind `index`.

    Masked-scan formulation: a cell j <= index is a candidate stopping point
    if y[j-1] <= y[j]; the result is the largest such j reachable by a
    contiguous decreasing-leftward run ending at `index`.
    """
    y = array_1d
    n = y.shape[0]
    idx = jnp.arange(n)
    rising_left = jnp.concatenate(
        [jnp.array([False]), y[:-1] > y[1:]])  # y[j-1] > y[j]
    # positions j in (0, index] where the walk would continue (y[j-1] > y[j])
    cont = rising_left & (idx <= index) & (idx > 0)
    # the walk stops at the smallest j* such that cont[j] for all j* < j <= index
    # i.e. j* = index - (length of trailing True run of cont ending at index)
    run = jnp.cumsum(jnp.where(cont, 1, 0))
    # length of contiguous run ending at index: count backwards
    def trailing_run_length(c, upto):
        # number of consecutive True at positions upto, upto-1, ... :
        # = upto - max{j <= upto : not c[j]}  (0 if c[upto] False)
        blocked = jnp.where(~c & (idx <= upto), idx, -1)
        last_block = jnp.max(blocked)
        return upto - last_block
    return index - trailing_run_length(cont, index)


def find_index_of_maximum_pressure_behind(gas_pressure_1d, index):
    """Reference post_shock_locator.hpp:124-128."""
    return find_index_of_maximum_behind(gas_pressure_1d, index)


def find_index_of_pressure_plateau_ahead(gas_pressure_1d, index):
    """Walk right from `index` while d(log p)[i-1] < 0.5 * d(log p)[i-2]
    (reference post_shock_locator.hpp:134-152); returns the first cell where
    the condition fails. Returns 0 if the walk runs off the grid, matching
    the reference's bounds-check catch."""
    m = gas_pressure_1d.shape[0]
    dlogp = difference_on_axis(jnp.log(gas_pressure_1d), 0)  # length m-1
    i = jnp.arange(m)
    # d1[i] = dlogp[i-2] (valid i>=2); d2[i] = dlogp[i-1] (valid i>=1)
    d1 = jnp.concatenate([jnp.zeros(2, dlogp.dtype), dlogp[: m - 2]])
    d2 = jnp.concatenate([jnp.zeros(1, dlogp.dtype), dlogp])
    cont = (d2 < 0.5 * d1) & (i >= 2)
    stop = jnp.where(~cont & (i >= index), i, m)
    result = jnp.min(stop)
    return jnp.where(result == m, 0, result)
