#!/usr/bin/env python
"""Quick whole-frame path-trace timing for one or more scenes.

Run: timeout 1800 python -u tools/frame_ms.py scenes/teapot.txt [more...]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from radish_pt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import jax  # noqa: E402

from radish_pt_tpu.render import pathtrace as pt  # noqa: E402
from radish_pt_tpu.scene import build as sbuild  # noqa: E402
from radish_pt_tpu.scene.parser import parse_scene  # noqa: E402


def _sync(out):
    return jax.block_until_ready(out)


def timeit(fn, *a, n_warm=2, n_iter=6):
    for i in range(n_warm):
        _sync(fn(i, *a))
    t0 = time.perf_counter()
    out = None
    for i in range(n_iter):
        out = fn(n_warm + i, *a)
    _sync(out)
    return (time.perf_counter() - t0) / n_iter * 1e3


def main():
    scenes = sys.argv[1:] or ["scenes/teapot.txt"]
    for path in scenes:
        desc = parse_scene(path)
        ds, cam = sbuild.build_device_scene(desc)
        depth = desc.settings.trace_depth
        f = jax.jit(lambda lo: pt.path_trace(ds, cam, lo, depth))
        ms = timeit(f)
        nrays = cam.width * cam.height * (2 * depth + 1)
        print(f"{path:28s} tris={ds.num_triangles:6d} depth={depth} "
              f"{ms:8.2f} ms  {nrays / ms / 1e3:6.1f} Mrays/s", flush=True)


if __name__ == "__main__":
    main()
