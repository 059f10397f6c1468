"""Command-line entry point.

Counterpart of the reference app driver (``/root/reference/src/main.cpp:71-107``):
``python -m radish_pt_tpu SCENEFILE.txt`` loads the scene, renders the number
of samples given by the scene's ``Sample`` line (or ``--spp``), and saves the
image.  There is no OpenGL preview on a headless host; ``--preview-every N``
dumps intermediate PNGs instead.
"""

from __future__ import annotations

import argparse
import os
import time

from .scene.build import INTERSECTORS


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radish_pt_tpu",
        description="JAX wavefront path tracer (Radish_PT capability set)",
    )
    p.add_argument("scene", help="scene file (reference text grammar)")
    p.add_argument("--spp", type=int, default=None, help="override Sample count")
    p.add_argument("--depth", type=int, default=None, help="override trace depth")
    p.add_argument(
        "--tracer",
        choices=["pt", "direct", "restir", "bvh", "gbuffer"],
        default="pt",
        help="tracer mode (reference Tracer enum)",
    )
    p.add_argument(
        "--denoiser",
        choices=["none", "gaussian", "eaw", "svgf"],
        default="none",
    )
    p.add_argument(
        "--encode-normal",
        action="store_true",
        help="store G-buffer normals hemi-oct encoded as 2 floats "
        "(DENOISER_ENCODE_NORMAL, gBuffer.h:7-13)",
    )
    p.add_argument(
        "--no-denoiser-split",
        action="store_true",
        help="filter the combined image instead of denoising direct and "
        "indirect illumination separately (DENOISER_SPLIT_DIRECT_INDIRECT)",
    )
    p.add_argument(
        "--reuse",
        choices=["none", "temporal", "spatial", "both"],
        default="both",
        help="ReSTIR reservoir reuse mode",
    )
    p.add_argument(
        "--sigmas", type=float, nargs=3, metavar=("DEPTH", "NORMAL", "LUM"),
        default=None,
        help="filter sigmas for the active denoiser (the reference GUI's "
        "live sliders, preview.cpp:261-267)",
    )
    p.add_argument(
        "--tonemap", choices=["none", "filmic", "aces"], default="aces"
    )
    p.add_argument("--out", default=None, help="output image path")
    p.add_argument(
        "--res",
        type=int,
        nargs=2,
        metavar=("W", "H"),
        default=None,
        help="override scene resolution",
    )
    p.add_argument("--timing", action="store_true", help="print per-pass ms table")
    p.add_argument("--preview-every", type=int, default=0)
    p.add_argument("--animate-camera", action="store_true")
    p.add_argument(
        "--gbuffer-view",
        choices=["albedo", "normal", "depth", "motion"],
        default="albedo",
        help="debug channel for --tracer gbuffer",
    )
    p.add_argument("--batch-spp", type=int, default=0,
                   help="samples per device dispatch (pt/restir tracers; "
                   "amortizes dispatch latency)")
    p.add_argument(
        "--mesh", default=None, metavar="TILE[xSAMPLE]",
        help="multi-chip device mesh, e.g. '8' (8-way pixel tiles) or '4x2' "
        "(4 tiles x 2 decorrelated sample streams); pt/restir tracers",
    )
    p.add_argument("--checkpoint", default=None,
                   help="write render-state checkpoint here when done")
    p.add_argument("--resume", default=None, help="resume from a checkpoint")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (traps NaNs in kernels)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render loop "
                   "after its first (compiling) frame; summarize with "
                   "tools/trace_summary.py or view with xprof/tensorboard")
    p.add_argument(
        "--intersector", default=None, choices=list(INTERSECTORS),
        help="force the intersection engine (default: auto by scene size; "
        "also settable via RADISH_INTERSECTOR)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.intersector:
        # the scene build reads this before its auto-selection
        os.environ["RADISH_INTERSECTOR"] = args.intersector

    from .config import Denoiser, ReservoirReuse, ToneMapping, Tracer
    from .render.renderer import Renderer
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)

    mesh = None
    if args.mesh:
        from .parallel.sharding import make_mesh

        parts = args.mesh.lower().split("x")
        n_tile = int(parts[0])
        n_sample = int(parts[1]) if len(parts) > 1 else 1
        mesh = make_mesh(n_tile=n_tile, n_sample=n_sample)
        print(f"[mesh: {n_tile} tile x {n_sample} sample over "
              f"{mesh.devices.ravel()[0].platform} devices]")

    t0 = time.time()
    r = Renderer(scene_path=args.scene, timing=args.timing, mesh=mesh)
    if args.res is not None:
        r = Renderer(
            ds=r.ds,
            cam=r.cam.replace(width=args.res[0], height=args.res[1]),
            desc=r.desc,
            timing=args.timing,
            mesh=mesh,
        )
    print(
        f"[scene loaded in {time.time() - t0:.1f}s: "
        f"{r.ds.num_triangles} tris, BVH size {r.ds.bounds_min.shape[0]}, "
        f"{r.ds.n_area_lights} area lights, "
        f"{'env map, ' if r.ds.has_env else ''}"
        f"{r.cam.width}x{r.cam.height}]"
    )

    s = r.settings
    s.tracer = {
        "pt": Tracer.STREAMED,
        "direct": Tracer.DIRECT_LIGHT,
        "restir": Tracer.RESTIR_DI,
        "bvh": Tracer.BVH_VISUALIZE,
        "gbuffer": Tracer.GBUFFER_PREVIEW,
    }[args.tracer]
    s.denoiser = {
        "none": Denoiser.NONE,
        "gaussian": Denoiser.GAUSSIAN,
        "eaw": Denoiser.EA_WAVELET,
        "svgf": Denoiser.SVGF,
    }[args.denoiser]
    s.reservoir_reuse = {
        "none": ReservoirReuse.NONE,
        "temporal": ReservoirReuse.TEMPORAL,
        "spatial": ReservoirReuse.SPATIAL,
        "both": ReservoirReuse.TEMPORAL_SPATIAL,
    }[args.reuse]
    s.tone_mapping = {
        "none": ToneMapping.NONE,
        "filmic": ToneMapping.FILMIC,
        "aces": ToneMapping.ACES,
    }[args.tonemap]
    s.animate_camera = args.animate_camera
    s.gbuffer_view = args.gbuffer_view
    s.denoiser_split = not args.no_denoiser_split
    s.encode_normal = args.encode_normal
    if args.sigmas:
        if s.denoiser == Denoiser.EA_WAVELET:
            s.eaw_sig_depth, s.eaw_sig_normal, s.eaw_sig_luminance = args.sigmas
        else:
            s.svgf_sig_depth, s.svgf_sig_normal, s.svgf_sig_luminance = args.sigmas
    if args.depth is not None:
        s.trace_depth = args.depth
    if args.resume:
        r.load_checkpoint(args.resume)
        print(f"[resumed from {args.resume}: {r.state.iteration} spp accumulated]")

    spp = args.spp or r.state.iterations
    print(f"[rendering {spp} spp, tracer={args.tracer}, depth={s.trace_depth}]")

    import contextlib

    profile_cm = contextlib.nullcontext()
    if args.profile:
        import jax

        profile_cm = jax.profiler.trace(args.profile)
        print(f"[profiling -> {args.profile}]")

    t0 = time.time()
    if args.batch_spp > 1 and args.denoiser != "none":
        print("[--batch-spp renders without the denoiser; using the "
              "per-frame loop so denoising applies]")
        args.batch_spp = 0
    batched = args.batch_spp > 1 and args.tracer in ("pt", "restir")
    first = 0
    if args.profile and not batched and spp > 1:
        r.step()  # compile outside the trace window
        first = 1
    with profile_cm:
        if batched:
            r.render_batched(spp, block=args.batch_spp)
        else:
            for i in range(first, spp):
                r.step()
                if args.preview_every and (i + 1) % args.preview_every == 0:
                    p = r.save(f"{r.state.image_name}_preview_{i + 1}.png")
                    print(f"  [{i + 1}/{spp}] preview -> {p}")
                elif (i + 1) % 16 == 0 or i == 0:
                    dt = time.time() - t0
                    print(f"  [{i + 1}/{spp} spp, {dt / (i + 1) * 1e3:.1f} ms/frame avg]")
    total = time.time() - t0
    print(f"[done: {total:.2f}s total, {total / spp * 1e3:.2f} ms/frame]")
    if args.checkpoint:
        cp = r.save_checkpoint(args.checkpoint)
        print(f"[checkpoint -> {cp}]")
    if args.timing:
        print(r.timer.table())
    path = r.save(args.out)
    print(f"[saved {path}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
