#!/usr/bin/env python
"""Multi-host render launcher — run ONE copy per host/process:

    python tools/multihost_render.py --coordinator 127.0.0.1:9911 \
        --num-processes 2 --process-id 0 scenes/cornell_box.txt --spp 8

Every process loads the same scene, joins the global (tile, sample) mesh,
and runs the sharded accumulate step (parallel/sharding.py::pt_step_sharded)
over all devices of all hosts; process 0 saves the gathered image.
CPU smoke test: set JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=4 in each process.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-device-ids", type=int, nargs="*", default=None,
                    help="cards of this host owned by this process (when "
                    "several processes share a host)")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--n-sample", type=int, default=1)
    ap.add_argument("--out", default="multihost.png")
    ap.add_argument("--out-npy", default=None)
    args = ap.parse_args()

    from radish_pt_tpu.parallel import multihost as mh

    mh.initialize(args.coordinator, args.num_processes, args.process_id,
                  args.local_device_ids)

    import jax

    from radish_pt_tpu.parallel import sharding as sh
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    me = jax.process_index()
    print(f"[proc {me}] {jax.process_count()} processes, "
          f"{len(jax.devices())} global devices", flush=True)

    ds, cam, desc = load_scene(args.scene)
    if args.res:
        cam = cam.replace(width=args.res[0], height=args.res[1])

    mesh = mh.make_global_mesh(n_sample=args.n_sample)
    n_tile = mesh.shape["tile"]
    n_pad = sh._padded_pixel_count(cam, n_tile)

    ds_g = mh.replicate_scene_global(mesh, ds)
    direct = mh.make_sharded_zeros(mesh, (n_pad, 3))

    step = jax.jit(partial(sh.pt_step_sharded, mesh, max_depth=args.depth))
    for i in range(args.spp):
        direct = step(ds_g, cam, direct, i, i)
    img = mh.gather_image(direct)[: cam.width * cam.height]
    img = img.reshape(cam.height, cam.width, 3)

    if me == 0:
        if args.out_npy:
            import numpy as np

            np.save(args.out_npy, img)
            print(f"[proc 0] saved {args.out_npy}", flush=True)
        else:
            from radish_pt_tpu.render import post
            from radish_pt_tpu.scene.image_io import save_image
            from radish_pt_tpu.utils import math as m

            import numpy as np
            import jax.numpy as jnp

            disp = m.gamma_correction(post.tonemap(jnp.asarray(img), 2))
            save_image(args.out, np.asarray(jnp.clip(disp, 0, 1))[:, ::-1])
            print(f"[proc 0] saved {args.out}", flush=True)


if __name__ == "__main__":
    main()
