#!/usr/bin/env python
"""Ablation timing of the ReSTIR frame (gbuffer + RIS + temporal + spatial).

Run: python -u tools/profile_restir.py [scene.txt]
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

from radish_pt_tpu.config import ReservoirReuse
from radish_pt_tpu.render import gbuffer as gb
from radish_pt_tpu.render import restir as rs
from radish_pt_tpu.scene import build as sbuild
from radish_pt_tpu.scene.parser import parse_scene


def sync(out):
    return jax.block_until_ready(out)


def t_ms(f, *args, n_warm=2, n_iter=4):
    for _ in range(n_warm):
        sync(f(*args))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = f(*args)
    sync(out)
    return (time.perf_counter() - t0) / n_iter * 1e3


def main():
    scene_path = sys.argv[1] if len(sys.argv) > 1 else "scenes/cornell_box.txt"
    desc = parse_scene(scene_path)
    ds, cam = sbuild.build_device_scene(desc)
    n = cam.width * cam.height

    gbuf_fn = jax.jit(gb.render_gbuffer)
    gbuf = gbuf_fn(ds, cam, cam)
    print(f"gbuffer: {t_ms(gbuf_fn, ds, cam, cam):8.1f} ms")

    # slope-timed gbuffer (cancels dispatch floor)
    def rep(k):
        def f(c):
            def body(i, carry):
                out = gb.render_gbuffer(
                    ds, cam_mod_shift(cam, carry), cam)
                return carry + out.albedo[:, 0].sum() * 1e-30
            import jax.lax as lax
            return lax.fori_loop(0, k, body, c)
        return jax.jit(f)

    from radish_pt_tpu.scene import camera as cam_mod

    def cam_mod_shift(cam, eps):
        return cam.replace(position=cam.position + eps * 1e-30)

    t1 = t_ms(rep(1), jnp.float32(0.0))
    t6 = t_ms(rep(6), jnp.float32(0.0))
    print(f"gbuffer slope: {(t6 - t1) / 5:8.1f} ms   (k1={t1:.1f} k6={t6:.1f})")

    last_res = rs.empty_reservoir(n)

    def mk(reuse, rsize):
        def f(looper, gbuf, lastf, lastr):
            return rs.restir_direct(
                ds, cam, looper, gbuf, lastf, lastr,
                jnp.asarray(False), reuse, reservoir_size=rsize,
            )
        return jax.jit(f)

    for name, reuse, rsize in (
        ("RIS only, size 1", ReservoirReuse.NONE, 1),
        ("RIS only, size 32", ReservoirReuse.NONE, 32),
        ("RIS32 + both", ReservoirReuse.TEMPORAL | ReservoirReuse.SPATIAL, 32),
    ):
        def rep(k, reuse=reuse, rsize=rsize):
            def g(c):
                def body(i, carry):
                    d, r = rs.restir_direct(
                        ds, cam, i, gbuf, gbuf.frame, last_res,
                        jnp.asarray(False), reuse, reservoir_size=rsize)
                    return carry + d[:, 0].sum() * 1e-30
                return jax.lax.fori_loop(0, k, body, c)
            return jax.jit(g)

        t1 = t_ms(rep(1), jnp.float32(0.0), n_warm=1, n_iter=2)
        t4 = t_ms(rep(4), jnp.float32(0.0), n_warm=1, n_iter=2)
        print(f"{name:24s} slope={(t4 - t1) / 3:7.1f} ms  (k1={t1:.1f})")


if __name__ == "__main__":
    main()
