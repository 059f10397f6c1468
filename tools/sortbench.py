#!/usr/bin/env python
"""Microbench: wavefront reorder primitives at 640k lanes.

Decides how intersect_sorted / test_occlusion_sorted should move ray
state between pixel order and coherence order:

  A. lax.sort with p payload columns (current design: p=8 fwd, p=3 inv)
  B. lax.sort (key, lane) only + ONE divergent packed-row gather
  C. inverse permutation via scatter (out.at[lane_s].set(vals)) instead of
     a second sort

Run: timeout 1200 python -u tools/sortbench.py
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
        print(f"  {name:52s} {(thi - t1) / (khi - 1):9.2f} ms", flush=True)
    except Exception as e:  # noqa: BLE001
        print(f"  {name:52s} FAILED: {str(e)[:140]}", flush=True)


def main():
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros(N)
    k24 = jax.random.randint(key, (N,), 0, 1 << 24)
    lane = jnp.arange(N, dtype=jnp.int32)
    cols = jax.random.normal(key, (17, N))

    # A: sort with p payload columns
    for p in (1, 2, 3, 5, 8, 11, 17):
        def srt(c, k24, cols, p=p):
            kk = k24 + (c[:1] * 1e-30).astype(jnp.int32).sum()
            ops = (kk,) + tuple(cols[i] for i in range(p))
            s = jax.lax.sort(ops, num_keys=1)
            return s[1]

        slope(f"lax.sort key + {p} payload cols", srt, x0, k24, cols)

    # B: packed-row gather by a random permutation
    perm = jax.random.permutation(key, N).astype(jnp.int32)
    for w in (4, 8, 12, 16):
        data = jax.random.normal(key, (N, w))

        def gat(c, perm, data):
            pp = (perm + (c * 1e30).astype(jnp.int32)) % N
            return data[pp].sum(axis=-1)

        slope(f"divergent row gather packed [N,{w}]", gat, x0, perm, data)

    # C: inverse permutation via scatter, 1 and 2 value columns
    vals = jax.random.normal(key, (N,))
    vals2 = jax.random.normal(key, (N, 2))

    def scat1(c, perm, vals):
        pp = (perm + (c * 1e30).astype(jnp.int32)) % N
        out = jnp.zeros(N).at[pp].set(vals + c)
        return out

    slope("scatter inverse perm, 1 col", scat1, x0, perm, vals)

    def scat2(c, perm, vals2):
        pp = (perm + (c * 1e30).astype(jnp.int32)) % N
        out = jnp.zeros((N, 2)).at[pp].set(vals2 + c[:, None])
        return out.sum(axis=-1)

    slope("scatter inverse perm, 2 cols (packed row)", scat2, x0, perm, vals2)

    # D: full reorder round trips (what a bounce pass actually pays)
    o = jax.random.normal(key, (N, 3))
    d = jax.random.normal(key, (N, 3))
    act = jax.random.uniform(key, (N,)) < 0.7

    def cur_fwd_inv(c, k24, lane, o, d, act):
        kk = k24 + (c[:1] * 1e-30).astype(jnp.int32).sum()
        s = jax.lax.sort(
            (kk, lane, o[:, 0], o[:, 1], o[:, 2],
             d[:, 0], d[:, 1], d[:, 2], act),
            num_keys=1)
        prim = s[2] + s[5]
        dist = s[3] + s[6]
        u = jax.lax.sort((s[1], prim, dist), num_keys=1)
        return u[1] + u[2]

    slope("CURRENT: fwd sort 8 cols + inv sort 2 cols", cur_fwd_inv,
          x0, k24, lane, o, d, act)

    packed = jnp.concatenate([o, d, act[:, None].astype(jnp.float32)], axis=1)

    def alt_fwd_inv(c, k24, lane, packed):
        kk = k24 + (c[:1] * 1e-30).astype(jnp.int32).sum()
        s = jax.lax.sort((kk, lane), num_keys=1)
        lane_s = s[1]
        rows = packed[lane_s]  # one divergent gather, width 7
        prim = rows[:, 0] + rows[:, 3]
        dist = rows[:, 1] + rows[:, 4]
        out = jnp.zeros((N, 2)).at[lane_s].set(
            jnp.stack([prim, dist], axis=-1))
        return out[:, 0] + out[:, 1]

    slope("ALT: sort(key,lane) + row gather + scatter inv", alt_fwd_inv,
          x0, k24, lane, packed)


if __name__ == "__main__":
    main()
