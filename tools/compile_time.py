#!/usr/bin/env python
"""Cold-compile timing for the frame jit (VERDICT r4 #4).

Times jit lowering+compilation of the closure-form frame function with the
persistent cache pointed at a THROWAWAY directory (a true cold compile),
then reports the warm (persistent-cache) reload time from a second
process-level compile against the real cache.

Usage: JAX_COMPILATION_CACHE_DIR=/tmp/cold_cache_$$ python tools/compile_time.py scenes/teapot.txt [depth]
(Without the variable the cache is the checkout's .jax_cache/ — do NOT use
that unless you want to seed it.)
"""

import os
import sys
import time

sys.path.insert(0, ".")

from radish_pt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import jax  # noqa: E402

from radish_pt_tpu.render import pathtrace as pt  # noqa: E402
from radish_pt_tpu.scene.build import load_scene  # noqa: E402


def main():
    scene = sys.argv[1] if len(sys.argv) > 1 else "scenes/teapot.txt"
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    ds, cam, _ = load_scene(scene)
    cam = cam.replace(width=800, height=800)
    fn = jax.jit(lambda looper: pt.path_trace(ds, cam, looper, depth))
    t0 = time.perf_counter()
    lowered = fn.lower(0)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    print(f"{scene} depth={depth} cache_dir="
          f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '.jax_cache')}")
    print(f"  trace+lower: {t1 - t0:7.1f} s")
    print(f"  compile:     {t2 - t1:7.1f} s")
    del compiled


if __name__ == "__main__":
    main()
