#!/usr/bin/env python
"""Microbenchmarks of the XLA primitives underlying the clustered
intersector design: wide-row gathers, dense slab+argmin passes, top_k.

NOTE: all device arrays are passed as explicit jit ARGUMENTS — arrays closed
over by a jitted function become embedded HLO constants.

Run: python -u tools/microbench.py
"""

from __future__ import annotations

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from radish_pt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

N = 640_000


def sync(out):
    return jax.block_until_ready(out)


def slope(name, fn, x0, *args, khi=6, n_iter=3):
    """fn(carry_f32[N], *args) -> f32[N]; prints marginal ms per repetition."""

    def rep(k):
        def f(x, *s):
            def body(i, c):
                out = fn(c, *s)
                return c + out * 1e-30
            return jax.lax.fori_loop(0, k, body, x)
        return jax.jit(f)

    def run(f):
        for _ in range(2):
            sync(f(x0, *args))
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = f(x0, *args)
        sync(out)
        return (time.perf_counter() - t0) / n_iter * 1e3

    try:
        t1 = run(rep(1))
        thi = run(rep(khi))
        print(f"  {name:46s} {(thi - t1) / (khi - 1):9.2f} ms", flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"  {name:46s} FAILED: {str(e)[:120]}", flush=True)


def main():
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros(N)

    for C, K in ((136, 32), (68, 64), (1024, 32)):
        table = jax.random.normal(key, (C, K * 9))
        idx = jax.random.randint(key, (N,), 0, C)

        def g_row(c, table, idx, C=C):
            i = (idx + (c * 1e30).astype(jnp.int32)) % C
            return table[i].sum(axis=-1)

        slope(f"gather [{C},{K*9}] one row/lane (divergent)", g_row, x0, table, idx)

    o = jax.random.normal(key, (N, 3))
    d = jax.random.normal(key, (N, 3))

    for C in (68, 136, 512):
        bmin = jax.random.normal(key, (C, 3))
        bmax = bmin + 1.0

        def slab(c, o, d, bmin, bmax):
            oo = o + c[:, None]
            inv = 1.0 / d
            t0 = (bmin[None] - oo[:, None]) * inv[:, None]
            t1 = (bmax[None] - oo[:, None]) * inv[:, None]
            tn = jnp.minimum(t0, t1).max(axis=-1)
            tf = jnp.maximum(t0, t1).min(axis=-1)
            entry = jnp.where((tf >= tn) & (tf > 0), tn, 1e30)  # [N, C]
            j = jnp.argmin(entry, axis=-1)
            best = jnp.take_along_axis(entry, j[:, None], axis=1)[:, 0]
            return jnp.where(best < 1e29, best, 0.0) + j

        slope(f"dense slab+argmin [{N}x{C}]", slab, x0, o, d, bmin, bmax)

    # iterative argmin extraction on a [N, C] matrix
    C = 136
    entry0 = jax.random.normal(key, (N, C))
    col = jnp.arange(C, dtype=jnp.int32)

    def extract(c, entry0):
        e = entry0 + c[:, None]
        j = jnp.argmin(e, axis=-1)
        e = jnp.where(col[None, :] == j[:, None], 1e30, e)
        return e.sum(axis=-1) + j

    slope(f"argmin + mask update [{N}x{C}]", extract, x0, entry0)

    def topk(c, entry0):
        e = entry0 + c[:, None]
        v, i = jax.lax.top_k(-e, 8)
        return v.sum(axis=-1) + i.sum(axis=-1)

    slope(f"top_k(8) over [{N}x{C}]", topk, x0, entry0)

    # 32-tri mini sweep per lane from pre-gathered [N, 32, 9]
    tris = jax.random.normal(key, (N, 32, 9))

    def sweep(c, tris, o, d):
        oo = (o + c[:, None])[:, None, :]
        dd = d[:, None, :]
        v0 = tris[..., 0:3]
        e1 = tris[..., 3:6]
        e2 = tris[..., 6:9]
        p = jnp.cross(dd, e2)
        det = (e1 * p).sum(-1)
        s = oo - v0
        bx = (s * p).sum(-1)
        q = jnp.cross(s, e1)
        by = (dd * q).sum(-1)
        t = (e2 * q).sum(-1) / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
        ok = (jnp.abs(det) > 1e-7) & (bx >= 0) & (by >= 0) & (bx + by <= det) & (t > 0)
        t = jnp.where(ok, t, 1e30)
        return t.min(axis=-1)

    slope("32-tri MT sweep from [N,32,9] (pre-gathered)", sweep, x0, tris, o, d)

    # gather + sweep fused (the real per-iteration cost)
    C, K = 136, 32
    ctris = jax.random.normal(key, (C, K * 9))
    idx = jax.random.randint(key, (N,), 0, C)

    def gather_sweep(c, ctris, idx, o, d):
        i = (idx + (c * 1e30).astype(jnp.int32)) % C
        tris = ctris[i].reshape(N, K, 9)
        return sweep(c, tris, o, d)

    slope(f"gather[{C},{K*9}] + {K}-tri sweep (per iter)", gather_sweep,
          x0, ctris, idx, o, d)

    # compaction: cumsum + scatter of a sparse mask
    mask = jax.random.uniform(key, (N,)) < 0.05

    def compact(c, mask):
        m = mask & (c < 1.0)
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        src = jnp.where(m, pos, N)
        out = jnp.full(N // 8, -1, jnp.int32)
        out = out.at[jnp.clip(src, 0, N // 8 - 1)].set(jnp.arange(N), mode="drop")
        return out.sum().astype(jnp.float32) + c * 0

    slope("compact 5% of lanes (cumsum+scatter)", compact, x0, mask)


if __name__ == "__main__":
    main()


def bench_sort():
    key = jax.random.PRNGKey(1)
    x0 = jnp.zeros(N)
    d = jax.random.normal(key, (N, 3))
    o = jax.random.normal(key, (N, 3))

    def keys_only(c, d):
        dd = d + c[:, None]
        k = ((dd[:, 0] > 0) * 4 + (dd[:, 1] > 0) * 2 + (dd[:, 2] > 0)).astype(jnp.int32)
        return k.astype(jnp.float32)

    slope("octant key compute", keys_only, x0, d)

    def argsort_oct(c, d):
        k = ((d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)).astype(jnp.int32)
        k = k + (c[:1] * 1e-30).astype(jnp.int32).sum()
        return jnp.argsort(k).astype(jnp.float32)

    slope("argsort 640k (3-bit keys)", argsort_oct, x0, d)

    def argsort_12(c, d, o):
        k = ((d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)).astype(jnp.int32)
        cell = (jnp.clip((o[:, 0] + 4) / 8, 0, 1) * 7).astype(jnp.int32)
        k = k * 8 + cell + (c[:1] * 1e-30).astype(jnp.int32).sum()
        return jnp.argsort(k).astype(jnp.float32)

    slope("argsort 640k (6-bit keys)", argsort_12, x0, d, o)

    # bucket-rank permutation: one-hot cumsum over 8 octants
    def bucket_rank(c, d):
        k = ((d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)).astype(jnp.int32)
        k = k + (c[:1] * 1e-30).astype(jnp.int32).sum()
        oh = jax.nn.one_hot(k, 8, dtype=jnp.int32)  # [N, 8]
        ranks = jnp.cumsum(oh, axis=0) - oh  # rank within bucket
        counts = oh.sum(axis=0)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
        pos = (ranks + starts[None, :])[jnp.arange(k.shape[0]), k]
        return pos.astype(jnp.float32)

    slope("bucket-rank permutation (8 buckets)", bucket_rank, x0, d)

    # permute + unpermute round trip of a packed [N, 10]
    perm = jax.random.permutation(key, N)
    data = jax.random.normal(key, (N, 10))

    def permute_rt(c, perm, data):
        p = (perm + (c * 1e30).astype(jnp.int32)) % N
        return data[p].sum(axis=-1)

    slope("permute packed [N,10] (1 gather)", permute_rt, x0, perm, data)


bench_sort()
