#!/usr/bin/env python
"""Isolate the fixed (depth-independent) cost of a path_trace frame."""

from __future__ import annotations

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from radish_pt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from radish_pt_tpu.render import pathtrace as pt
from radish_pt_tpu.sampling import rng
from radish_pt_tpu.scene import build as sbuild
from radish_pt_tpu.scene import device_scene as dsc
from radish_pt_tpu.scene.parser import parse_scene


def sync(out):
    return jax.block_until_ready(out)


def t(name, f, *args, n_warm=2, n_iter=4):
    for _ in range(n_warm):
        sync(f(*args))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = f(*args)
    sync(out)
    ms = (time.perf_counter() - t0) / n_iter * 1e3
    print(f"  {name:44s} {ms:9.2f} ms")
    return ms


def main():
    scene_path = sys.argv[1] if len(sys.argv) > 1 else "scenes/teapot.txt"
    desc = parse_scene(scene_path)
    ds, cam = sbuild.build_device_scene(desc)
    n = cam.width * cam.height
    print(f"scene={scene_path} tris={ds.num_triangles} lanes={n}")

    for depth in (0, 1, 2, 5):
        t(f"path_trace depth {depth}",
          jax.jit(lambda lo, d=depth: pt.path_trace(ds, cam, lo, d)), 7)

    idx = jnp.arange(n, dtype=jnp.int32)
    sampler0 = rng.make_sampler(7, idx)
    ray_o, ray_d, _ = jax.jit(pt._gen_primary)(ds, cam, sampler0, idx)
    it = jax.jit(lambda o, d: dsc.intersect(ds, o, d))(ray_o, ray_d)
    pos = jnp.asarray(jax.device_get(it.pos))
    key = jax.random.PRNGKey(0)
    sec_d = jax.random.normal(key, (n, 3))
    sec_d = sec_d / jnp.linalg.norm(sec_d, axis=-1, keepdims=True)
    r4 = jax.random.uniform(key, (n, 4))

    t("gen_primary", jax.jit(lambda lo: pt._gen_primary(ds, cam,
                                                        rng.make_sampler(lo, idx), idx)), 7)
    t("intersect coherent", jax.jit(lambda o: dsc.intersect(ds, o, ray_d)), ray_o)
    t("intersect divergent (unsorted)",
      jax.jit(lambda o: dsc.intersect(ds, o, sec_d)), pos)
    t("intersect_sorted divergent",
      jax.jit(lambda o: dsc.intersect_sorted(ds, o, sec_d)), pos)
    t("argsort key", jax.jit(lambda o: jnp.argsort(dsc._sort_key(ds, o, sec_d))), pos)

    def perm_only(o):
        perm = jnp.argsort(dsc._sort_key(ds, o, sec_d))
        rays = jnp.concatenate([o, sec_d], axis=1)[perm]
        inv = jnp.zeros(n, jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))
        return rays[inv]

    t("argsort + permute + inverse-permute", jax.jit(perm_only), pos)
    t("sample_direct_light (w/ sorted occlusion)",
      jax.jit(lambda p: dsc.sample_direct_light(ds, p, r4)), pos)
    t("test_occlusion_sorted (random segments)",
      jax.jit(lambda p: dsc.test_occlusion_sorted(ds, p, p + sec_d * 2.0)), pos)
    t("test_occlusion plain (random segments)",
      jax.jit(lambda p: dsc.test_occlusion(ds, p, p + sec_d * 2.0)), pos)


if __name__ == "__main__":
    main()
