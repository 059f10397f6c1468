"""Row-fetch strategies for small per-lane table lookups.

The premise is a cost model in which a divergent gather costs per ROW,
nearly regardless of row width, so

* fetch all of a record in ONE packed wide row rather than several narrow
  tables, and
* for tiny tables (a scene's 2 area lights, 5 materials) a branchless
  compare/select chain over the rows replaces the gather entirely.

Whether either still pays against a plain ``table[idx]`` on the GPU is not
measured (ROADMAP Speed 5).
"""

from __future__ import annotations

import jax.numpy as jnp

# Above this many rows the select chain's L*width ops are assumed to cost
# more than a divergent gather.
SMALL_TABLE_MAX_ROWS = 8

# Between the select-chain limit and this, an f32 gather is a ONE-HOT
# MATMUL: (idx == iota) [N, L] @ table [L, W], at ``precision="highest"`` so
# the result is the exact f32 row (no TF32 rounding).  Above this size the
# [N, L] one-hot construction is assumed to dominate.
ONEHOT_TABLE_MAX_ROWS = 256


def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx]`` for f32/i32 ``table [L, W]``, ``idx i32 [N]``.

    Strategy by table size: select chain (<=8 rows) -> one-hot matmul
    (f32 2D tables <=256 rows) -> real gather.

    Contract: out-of-range ``idx`` is clamped to [0, L-1] (matching XLA
    gather's clamp mode) on every path; the one-hot path additionally
    assumes a FINITE table (a non-finite row would poison results through
    0*inf = NaN).
    """
    n_rows = table.shape[0]
    idx = jnp.clip(idx, 0, n_rows - 1)
    if n_rows == 1:
        return jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    if n_rows <= SMALL_TABLE_MAX_ROWS:
        sel = idx[..., None] if table.ndim == 2 else idx
        out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
        for j in range(1, n_rows):
            out = jnp.where(sel == j, table[j], out)
        return out
    if (
        n_rows <= ONEHOT_TABLE_MAX_ROWS
        and table.ndim == 2
        and table.dtype == jnp.float32
        and idx.ndim == 1
    ):
        onehot = (
            idx[:, None] == jnp.arange(n_rows, dtype=idx.dtype)[None, :]
        ).astype(jnp.float32)
        return jnp.dot(onehot, table, precision="highest")
    return table[idx]
