"""Alias-method (Vose) discrete sampling.

Wavefront re-design of the reference's "binomial distribution" tables
(``/root/reference/src/sampler.h:76-214``): the table is built on the host
with numpy, and device-side sampling is two gathers + one compare —
branch-free and fully vectorized over a wavefront.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp


@dataclass
class AliasTable:
    """Host-built alias table; ``prob[i]`` is the acceptance probability of
    bucket i, ``alias[i]`` the fallback index.  ``total`` is the un-normalized
    sum of the input weights."""

    prob: np.ndarray  # float32 [n]
    alias: np.ndarray  # int32 [n]
    total: float

    @property
    def n(self) -> int:
        return int(self.prob.shape[0])


def build_alias_table(weights) -> AliasTable:
    """Build an alias table with Vose's algorithm (O(n)).

    Mirrors the semantics of ``DiscreteSampler1D`` (sampler.h:81-125) but
    with the standard numerically robust two-stack construction.
    """
    w = np.asarray(weights, dtype=np.float64).ravel()
    n = w.size
    if n == 0:
        return AliasTable(np.zeros(0, np.float32), np.zeros(0, np.int32), 0.0)
    total = float(w.sum())
    if total <= 0.0:
        # degenerate: uniform table
        return AliasTable(
            np.ones(n, np.float32), np.arange(n, dtype=np.int32), 0.0
        )
    scaled = w * (n / total)
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int32)

    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:  # numerical leftovers
        prob[i] = 1.0
    return AliasTable(prob.astype(np.float32), alias, total)


def alias_sample(prob: jnp.ndarray, alias: jnp.ndarray, r1, r2):
    """Vectorized O(1) sample — device-side counterpart of
    ``DevDiscreteSampler1D::sample`` (sampler.h:205-209).

    r1, r2: uniform [0,1) arrays of any shape; returns int32 indices of the
    same shape.
    """
    from ..utils.gather import take_rows

    n = prob.shape[0]
    idx = jnp.minimum((r1 * n).astype(jnp.int32), n - 1)
    p = take_rows(prob, idx)
    a = take_rows(alias, idx)
    return jnp.where(r2 < p, idx, a).astype(jnp.int32)


def alias_pmf(table: AliasTable) -> np.ndarray:
    """Exact pmf represented by the table (for testing)."""
    n = table.n
    pmf = np.zeros(n, dtype=np.float64)
    for i in range(n):
        pmf[i] += table.prob[i] / n
        pmf[table.alias[i]] += (1.0 - table.prob[i]) / n
    return pmf
