"""Interactive rendering shell — the headless-host stand-in for the reference's
GLFW + ImGui preview (``/root/reference/src/preview.cpp``, ``main.cpp:204-284``).

There is no OpenGL interop on a headless host, so interaction is a terminal REPL:
each command mutates live settings or the camera (resetting accumulation,
like ``State::camChanged``), renders a burst of frames, writes ``preview.png``
and prints the live stats the reference shows in its ImGui panel (iteration,
ms/frame, tracer/denoiser modes, BVH size).

Run:  python -m radish_pt_tpu.viewer SCENE.txt [--res W H] [--spp-per-step N]

Commands (reference key bindings, keyboard-ized):
  w/s/a/d/q/e   move camera (forward/back/left/right/down/up)
  h/l           yaw left/right     j/k  pitch down/up
  t             cycle tracer (pt -> direct -> restir -> bvh -> gbuffer)
  n             cycle denoiser (none -> gaussian -> eaw -> svgf)
  m             cycle tonemap (none -> filmic -> aces)
  g             cycle g-buffer view (albedo/normal/depth/motion)
  v             cycle denoiser AOV preview (composed/input/output
                direct+indirect/moments/variance — preview.cpp:254-276)
  r             reset accumulation   o    toggle accumulate
  fov D | aperture R | focal D | depth N   live camera / depth params
  <enter>       render another burst
  p [path]      save PNG        c [path]  save checkpoint
  i             print stats     x         quit (saves like Esc in the ref)
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="radish_pt_tpu.viewer")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), default=None)
    ap.add_argument("--spp-per-step", type=int, default=4)
    ap.add_argument(
        "--spp-per-frame", type=int, default=4,
        help="frames advanced per displayed frame in --http mode (ReSTIR "
        "rides the batched path: one dispatch per display; 1 = classic "
        "per-frame loop)",
    )
    ap.add_argument(
        "--timing", action="store_true",
        help="per-pass ms table (forces a device sync per pass — off by "
        "default)",
    )
    ap.add_argument(
        "--tracer", default=None,
        choices=["pt", "direct", "restir", "bvh", "gbuffer"],
        help="initial tracer mode",
    )
    ap.add_argument("--preview", default="preview.png")
    ap.add_argument(
        "--http", type=int, default=0, metavar="PORT",
        help="serve a browser live preview (MJPEG stream + key/mouse "
        "commands) instead of the terminal REPL",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="TILE[xSAMPLE]",
        help="multi-chip device mesh (see radish_pt_tpu --mesh)",
    )
    args = ap.parse_args(argv)

    from .config import Denoiser, ToneMapping, Tracer
    from .render.renderer import Renderer
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()

    mesh = None
    if args.mesh:
        from .parallel.sharding import make_mesh

        parts = args.mesh.lower().split("x")
        mesh = make_mesh(n_tile=int(parts[0]),
                         n_sample=int(parts[1]) if len(parts) > 1 else 1)

    r = Renderer(scene_path=args.scene, timing=args.timing, mesh=mesh)
    if args.res:
        r = Renderer(ds=r.ds, cam=r.cam.replace(width=args.res[0], height=args.res[1]),
                     desc=r.desc, timing=args.timing, mesh=mesh)

    if args.tracer:
        r.settings.tracer = {
            "pt": Tracer.STREAMED, "direct": Tracer.DIRECT_LIGHT,
            "restir": Tracer.RESTIR_DI, "bvh": Tracer.BVH_VISUALIZE,
            "gbuffer": Tracer.GBUFFER_PREVIEW,
        }[args.tracer]
        if args.tracer == "restir":
            r.settings.use_reservoir = True

    if args.http:
        from .webviewer import serve

        return serve(r, port=args.http, spp_per_frame=args.spp_per_frame)

    move_step = float(np.linalg.norm(np.asarray(r.ds.bounds_max[0] - r.ds.bounds_min[0]))) * 0.02 + 0.1
    if mesh is not None:
        # mesh mode shards only the pt/restir tracers (renderer._step_sharded)
        tracers = [Tracer.STREAMED, Tracer.RESTIR_DI]
        tracer_names = ["pt", "restir"]
    else:
        tracers = [Tracer.STREAMED, Tracer.DIRECT_LIGHT, Tracer.RESTIR_DI,
                   Tracer.BVH_VISUALIZE, Tracer.GBUFFER_PREVIEW]
        tracer_names = ["pt", "direct", "restir", "bvh", "gbuffer"]
    denoisers = [Denoiser.NONE, Denoiser.GAUSSIAN, Denoiser.EA_WAVELET, Denoiser.SVGF]
    denoiser_names = ["none", "gaussian", "eaw", "svgf"]
    tonemaps = [ToneMapping.NONE, ToneMapping.FILMIC, ToneMapping.ACES]
    tonemap_names = ["none", "filmic", "aces"]
    gviews = ["albedo", "normal", "depth", "motion"]

    def stats():
        s = r.settings
        print(
            f"  [iter {r.state.iteration} | tracer {tracer_names[tracers.index(s.tracer)]}"
            f" | denoiser {denoiser_names[denoisers.index(s.denoiser)]}"
            f" | tonemap {tonemap_names[tonemaps.index(s.tone_mapping)]}"
            f" | {r.ds.num_triangles} tris, BVH {r.ds.bvh_packed.shape[0] // 6} nodes"
            f" | intersector {r.ds.intersector}]"
        )
        if r.timer.times:
            print(r.timer.table(last_n=8))

    def burst(n=None):
        n = n or args.spp_per_step
        t0 = time.time()
        for _ in range(n):
            r.step()
        img = r.save(args.preview)
        dt = (time.time() - t0) / n * 1e3
        print(f"  [{n} frames, {dt:.1f} ms/frame -> {img}]")

    def move(dx=0.0, dy=0.0, dz=0.0):
        cam = r.cam
        pos = (np.asarray(cam.position)
               + np.asarray(cam.right) * dx
               + np.asarray(cam.up) * dy
               + np.asarray(cam.view) * dz)
        r.update_camera(position=pos)

    def rotate(dyaw=0.0, dpitch=0.0):
        rot = np.asarray(r.cam.rotation) + np.array([dyaw, dpitch, 0.0])
        r.update_camera(rotation=rot)

    print(__doc__.split("Commands")[1])
    stats()
    burst()

    def handle(cmd, arg):
        """Dispatch one REPL command; returns "quit", "continue" or None
        (None -> render another burst)."""
        s = r.settings
        if cmd == "x":
            path = r.save()
            print(f"[saved {path}]")
            return "quit"
        elif cmd == "w":
            move(dz=move_step)
        elif cmd == "s" and not arg:
            move(dz=-move_step)
        elif cmd == "a":
            move(dx=-move_step)
        elif cmd == "d":
            move(dx=move_step)
        elif cmd == "q":
            move(dy=-move_step)
        elif cmd == "e":
            move(dy=move_step)
        elif cmd == "h":
            rotate(dyaw=-5.0)
        elif cmd == "l":
            rotate(dyaw=5.0)
        elif cmd == "j":
            rotate(dpitch=-5.0)
        elif cmd == "k":
            rotate(dpitch=5.0)
        elif cmd == "t":
            s.tracer = tracers[(tracers.index(s.tracer) + 1) % len(tracers)]
            r.reset_accumulation()
        elif cmd == "n":
            s.denoiser = denoisers[(denoisers.index(s.denoiser) + 1) % len(denoisers)]
        elif cmd == "m":
            s.tone_mapping = tonemaps[(tonemaps.index(s.tone_mapping) + 1) % len(tonemaps)]
        elif cmd == "g":
            s.gbuffer_view = gviews[(gviews.index(s.gbuffer_view) + 1) % len(gviews)]
        elif cmd == "v":
            aovs = type(r).PREVIEW_AOVS
            s.preview_aov = aovs[(aovs.index(s.preview_aov) + 1) % len(aovs)]
            print(f"  [preview aov: {s.preview_aov}]")
        elif cmd == "r":
            r.reset_accumulation()
        elif cmd == "o":
            s.accumulate = not s.accumulate
            print(f"  [accumulate: {s.accumulate}]")
        elif cmd == "fov" and arg:
            # reference FOV slider (preview.cpp:321-323); update_camera
            # recomputes tan_fov_y from fov_y
            r.update_camera(fov_y=float(arg))
        elif cmd == "aperture" and arg:
            # reference Aperture drag (preview.cpp:325-327)
            r.update_camera(lens_radius=float(arg))
        elif cmd == "focal" and arg:
            # reference Focal drag (preview.cpp:328)
            r.update_camera(focal_dist=float(arg))
        elif cmd == "depth" and arg:
            # reference Max Depth input (preview.cpp:294-296)
            s.trace_depth = int(arg)
            r.reset_accumulation()
        elif cmd == "p":
            print(f"[saved {r.save(arg or None)}]")
            return "continue"
        elif cmd == "c":
            print(f"[checkpoint {r.save_checkpoint(arg or 'render.ckpt.npz')}]")
            return "continue"
        elif cmd == "i":
            stats()
            return "continue"
        elif cmd not in ("", None):
            print("  unknown command; see header for keys")
            return "continue"
        return None

    while True:
        try:
            line = input("radish> ").strip()
        except (EOFError, KeyboardInterrupt):
            line = "x"
        cmd, _, arg = line.partition(" ")
        try:
            action = handle(cmd, arg)
        except ValueError as e:
            # a malformed numeric argument (e.g. "fov sixty") must not kill
            # the session — the accumulated render would be lost
            print(f"  [bad argument: {e}]")
            continue
        if action == "quit":
            return 0
        if action == "continue":
            continue
        burst()
        stats()


if __name__ == "__main__":
    raise SystemExit(main())
