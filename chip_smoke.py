#!/usr/bin/env python
"""Smoke run of the renderer on one NVIDIA GPU, checked against its plain
references.  The quickest proof that the system still starts on the card.

    python chip_smoke.py                 # one card: device, render, reference
    python chip_smoke.py --cards 4       # only the sharded path on 4 cards

Phases (one process; it exits non-zero and prints no result line when any
check fails, or when JAX finds no GPU).  Everything that compiles runs
first, concurrently on threads (XLA compiles outside the GIL, and a cold
run is mostly compiles); the timings run after it, one at a time.

* ``device``: JAX must report a ``gpu`` platform; prints the card's name and
  power limit as ``nvidia-smi`` gives them.
* ``render``: the normal entry points at the scenes' full 800x800 size —
  ``radish_pt_tpu.cli.main`` (Cornell, full PT + split SVGF, PNG saved and
  read back) and ``Renderer`` per scene and mode, each with the engine the
  scene build picks.  One line each: engine, median ms/frame of 5 frames
  after the first (timed with ``block_until_ready``), the first frame's
  seconds (compiles included, alongside the other cases' compiles), the
  seconds of the case's own XLA compiles (or persistent-cache loads), the
  footprint of its largest program by XLA's memory analysis, and the
  single-frame mean radiance beside ``bench.py``'s ``MEAN_GOLDEN``.  Every
  image must be finite and non-black.
* ``reference``:
  1. the ``bvh`` engine against the XLA ``brute`` sweep on 640k primary
     rays plus one bounce wavefront (teapot, teapot_hires): triangle ids
     equal on >= 99.99% of lanes, every other lane a distance tie within
     1e-5 relative;
  2. the Pallas-Triton brute kernel (the GPU's engine for cornell, 36
     triangles, and many_light, 76) against ``trv.intersect_brute`` at
     640k rays, same rule, then the sweep alone and the whole 800x800
     depth-5 frame timed for both engines in ``N_PAIRS`` pairs, the side
     that runs first alternating;
  3. the same 256x256 depth-5 frames (fixed looper) on the GPU and on this
     process's CPU backend with the XLA engines (cornell, teapot, glass);
  4. the sliced bounce loop against the dense masked loop on the GPU
     (teapot; the scene without its cull clusters runs the dense loop).

  Tolerance of 3 and 4: mean radiance within 1e-3 relative, and >= 99% of
  pixels within 1e-3 absolute + 1e-3 relative.  The per-lane math is the
  same on both sides, but the compilers order and fuse float operations
  differently; a last-bit difference can flip a discrete choice (a BSDF
  lobe, a Fresnel branch, a hit near an edge), after which that pixel's
  path diverges and its value is a different sample of the same estimate.
  Those pixels are the remainder.

Precision: the renderer's only matrix product is the one-hot row fetch in
``radish_pt_tpu/utils/gather.py``, pinned to ``precision="highest"``, so
TF32 never enters the results compared here.

``--cards 4`` runs only the sharded path and what it is compared with
(cornell, 256x256): full PT on meshes 4x1 and 2x2 against one card, the
ReSTIR seam rule, and SVGF partitioned over 4 cards; each sharded output
must hold one shard on each of 4 distinct cards.

The last line of standard output is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
``N`` being the number of cards the run used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

SCENE_FILES = {
    "cornell": "cornell_box.txt",
    "many_light": "many_light.txt",
    "teapot": "teapot.txt",
    "env_teapot": "env_teapot.txt",
    "textured": "textured.txt",
    "glass": "glass.txt",
    "teapot_hires": "teapot_hires.txt",
}

# (scene, mode, trace depth) for the render phase
RENDER_CASES = (
    ("cornell", "pt", 5),
    ("many_light", "pt", 5),
    ("teapot", "pt", 5),
    ("env_teapot", "pt", 5),
    ("textured", "pt", 5),
    ("glass", "pt", 8),
    ("teapot", "direct+eaw", 5),
    ("cornell", "restir+svgf", 5),
    ("teapot_hires", "pt", 5),
)

N_FRAMES = 5  # timed frames per case, after the first (compiling) one
N_PAIRS = 10  # alternated XLA / Triton pairs of the brute-engine timing
REL_TIE = 1e-5  # distance-tie tolerance of the engine comparisons
ID_MATCH_MIN = 0.9999  # share of lanes with equal triangle ids
PIX_TOL = 1e-3  # abs + rel per-pixel tolerance of the frame comparisons
PIX_MATCH_MIN = 0.99
MEAN_REL_TOL = 1e-3


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def process_peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0))


def load(name: str):
    from radish_pt_tpu.scene.build import load_scene

    return load_scene(os.path.join(REPO, "scenes", SCENE_FILES[name]))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


_task = threading.local()


def record_compiles() -> None:
    """Charge each XLA program to the task whose thread compiled it (or
    loaded it from the persistent cache): the seconds that took, and the
    program's footprint by XLA's memory analysis (arguments + outputs -
    aliased + temporaries).  It wraps JAX's one compile entry point, a
    private one; where that has moved, the figures read "not measured"."""
    try:
        from jax._src import compiler
        compile_or_get_cached = compiler.compile_or_get_cached
    except (ImportError, AttributeError):
        return

    def compile_and_record(*args, **kw):
        t0 = time.perf_counter()
        exe = compile_or_get_cached(*args, **kw)
        rec = getattr(_task, "compiled", None)
        if rec is not None:
            rec["s"] += time.perf_counter() - t0
            rec["programs"] += 1
            try:
                st = exe.get_compiled_memory_stats()
                rec["bytes"] = max(rec["bytes"] or 0, (
                    st.argument_size_in_bytes + st.output_size_in_bytes
                    - st.alias_size_in_bytes + st.temp_size_in_bytes))
            except Exception:  # noqa: BLE001 - stats are optional
                pass
        return exe

    compiler.compile_or_get_cached = compile_and_record


def compiled_note(rec: dict) -> str:
    if not rec["programs"]:
        return "own compiles not measured"
    big = ("not measured" if rec["bytes"] is None
           else f"{rec['bytes'] / 2**20:.1f} MiB")
    return (f"own XLA compiles {rec['s']:.1f} s over {rec['programs']} "
            f"programs, largest program {big}")


def run_concurrently(tasks):
    """Run ``(key, fn)`` pairs on threads and return ``{key: (result,
    seconds, compiled)}``, ``compiled`` being what :func:`record_compiles`
    charged to the task.  XLA compiles outside the GIL, so the cold
    compiles of many programs overlap instead of queueing; nothing timed as
    a result runs here.  The first failure is re-raised after all tasks
    end."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        _task.compiled = rec = {"s": 0.0, "programs": 0, "bytes": None}
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, rec

    with ThreadPoolExecutor(max_workers=max(1, len(tasks))) as ex:
        futs = [(k, ex.submit(timed, fn)) for k, fn in tasks]
        return {k: f.result() for k, f in futs}


def _image_ok(img, what: str) -> float:
    import numpy as np

    img = np.asarray(img)
    check(bool(np.isfinite(img).all()), f"{what}: non-finite pixels")
    mean = float(img.mean())
    check(mean > 1e-3, f"{what}: black image (mean {mean})")
    return mean


def make_renderer(name: str, mode: str, depth: int, engine=None):
    from radish_pt_tpu.config import (Denoiser, ReservoirReuse, Settings,
                                      Tracer)
    from radish_pt_tpu.render.renderer import Renderer

    ds, cam, desc = load(name)
    if engine is not None:
        ds = ds.replace(intersector=engine)
    s = Settings(**vars(desc.settings))
    s.trace_depth = depth
    if mode == "pt":
        s.tracer, s.denoiser = Tracer.STREAMED, Denoiser.NONE
    elif mode == "direct+eaw":
        s.tracer, s.denoiser = Tracer.DIRECT_LIGHT, Denoiser.EA_WAVELET
    elif mode == "restir+svgf":
        s.tracer, s.denoiser = Tracer.RESTIR_DI, Denoiser.SVGF
        s.reservoir_reuse = ReservoirReuse.TEMPORAL_SPATIAL
    r = Renderer(ds=ds, cam=cam, desc=desc, settings=s)
    r.state.looper, r.state.iteration = 7, 0
    return r


def frame(r) -> None:
    """One ``Renderer.step``, finished on the device."""
    import jax

    disp = r.step(return_device=True)
    jax.block_until_ready((disp, r.direct, r.indirect, r.reservoir))


def warm_renderer(*args, **kw):
    r = make_renderer(*args, **kw)
    frame(r)  # compiles every pass; frame 0 renders looper 7
    return r


def timed_frames(r, n: int) -> list:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        frame(r)
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


# ---------------------------------------------------------------------------
# render phase
# ---------------------------------------------------------------------------


def render_cli(out_dir: str):
    """Cornell through ``cli.main``: full PT + split SVGF, 4 spp, PNG."""
    from radish_pt_tpu import cli
    from radish_pt_tpu.scene.image_io import read_png

    png = os.path.join(out_dir, "cornell_svgf.png")
    rc = cli.main([os.path.join(REPO, "scenes", "cornell_box.txt"),
                   "--spp", "4", "--depth", "5", "--denoiser", "svgf",
                   "--out", png])
    check(rc == 0, f"cli.main returned {rc}")
    img = read_png(png)
    check(img.shape == (800, 800, 3), f"saved PNG has shape {img.shape}")
    check(img.mean() > 1.0, "saved PNG is black")
    return png, img


def report_render(key: str, r, first_s: float, compiled: dict,
                  n_frames: int) -> None:
    import numpy as np

    from bench import MEAN_GOLDEN
    from radish_pt_tpu.utils import math as m

    name, mode = key.split(":")
    depth = r.settings.trace_depth
    golden = ""
    if mode == "pt":
        # frame 0 holds compress(d) + compress(ind) of looper 7: undo the
        # range compression to get bench.py's raw single-frame mean
        raw = m.ldr_to_hdr(r.direct) + m.ldr_to_hdr(r.indirect)
        mean7 = float(np.asarray(raw).mean())
        gold = MEAN_GOLDEN.get(name) if depth == 5 else None
        golden = (f", frame-7 mean {mean7:.5f} vs golden {gold} "
                  f"({(mean7 - gold) / gold:+.2e} rel)"
                  if gold else f", frame-7 mean {mean7:.5f} (no golden)")
    times = timed_frames(r, n_frames)
    mean = _image_ok(r.current_image(), key)
    log(f"[render] {name} {mode} depth {depth} {r.cam.width}x{r.cam.height} "
        f"engine={r.ds.intersector} tris={r.ds.num_triangles}: median "
        f"{statistics.median(times):.2f} ms/frame over {n_frames} "
        f"(min {min(times):.2f} max {max(times):.2f}); first frame "
        f"{first_s:.1f} s (compiles concurrent with other cases), "
        f"{compiled_note(compiled)}; accumulated mean {mean:.4f}{golden}")


def render_tasks(out_dir: str):
    tasks = [("cli", lambda: render_cli(out_dir))]
    for name, mode, depth in RENDER_CASES:
        tasks.append((f"{name}:{mode}",
                      lambda a=(name, mode, depth): warm_renderer(*a)))
    return tasks


# ---------------------------------------------------------------------------
# reference phase
# ---------------------------------------------------------------------------


def _compare_hits(what, prim_a, dist_a, prim_b, dist_b) -> None:
    import numpy as np

    prim_a, prim_b = np.asarray(prim_a), np.asarray(prim_b)
    dist_a, dist_b = np.asarray(dist_a), np.asarray(dist_b)
    same = prim_a == prim_b
    diff = ~same
    both_hit = (prim_a >= 0) & (prim_b >= 0)
    tie = diff & both_hit & (
        np.abs(dist_a - dist_b) <= REL_TIE * np.maximum(np.abs(dist_b), 1e-30))
    share = float(same.mean())
    log(f"[reference] {what}: {prim_a.size} lanes, ids equal on "
        f"{share * 100:.4f}%, {int(diff.sum())} differ ({int(tie.sum())} "
        f"distance ties), hit rate {float((prim_b >= 0).mean()):.3f}")
    check(share >= ID_MATCH_MIN, f"{what}: ids equal on only {share:.6f}")
    check(bool((same | tie).all()),
          f"{what}: {int((diff & ~tie).sum())} lanes differ beyond a tie")


def _brute_batched(tri_packed, o, d, batch=131072):
    """XLA dense sweep over ray batches (bounded temporaries)."""
    import jax
    import jax.numpy as jnp

    from radish_pt_tpu.accel import traverse as trv

    fn = jax.jit(trv.intersect_brute)
    outs = [fn(tri_packed, o[i:i + batch], d[i:i + batch])
            for i in range(0, o.shape[0], batch)]
    return (jnp.concatenate([x[0] for x in outs]),
            jnp.concatenate([x[1] for x in outs]),
            jnp.concatenate([x[2] for x in outs]))


def _wavefronts(ds, cam):
    """640k primary rays and one cosine-sampled bounce wavefront from their
    hits (misses keep their primary ray)."""
    import jax
    import jax.numpy as jnp

    from radish_pt_tpu.scene import camera as cam_mod
    from radish_pt_tpu.scene import device_scene as dsc
    from radish_pt_tpu.utils import math as m

    @jax.jit
    def make(ds, cam):
        idx = jnp.arange(cam.width * cam.height, dtype=jnp.int32)
        o, d = cam_mod.pinhole_rays(cam, idx % cam.width, idx // cam.width)
        it = dsc.intersect(ds, o, d)
        u = jax.random.uniform(jax.random.PRNGKey(0), (idx.shape[0], 2))
        n = jnp.where((m.dot(it.norm, d) > 0)[:, None], -it.norm, it.norm)
        bd = m.cosine_sample_hemisphere(n, u[:, 0], u[:, 1])
        hit = (it.prim_id >= 0)[:, None]
        return o, d, jnp.where(hit, it.pos + bd * 1e-4, o), jnp.where(hit, bd, d)

    return make(ds, cam)


def ref_bvh_vs_brute(name: str) -> None:
    """The bvh walk against the XLA sweep, primary + one bounce."""
    import jax

    from radish_pt_tpu.scene import device_scene as dsc

    ds, cam, _ = load(name)
    check(ds.intersector == "bvh", f"{name} runs {ds.intersector}")
    o, d, bo, bd = _wavefronts(ds, cam)
    bvh = jax.jit(lambda ds, o, d: dsc._closest_hit(ds, o, d)[:2])
    for what, ro, rd in (("primary", o, d), ("bounce", bo, bd)):
        pa, ta = bvh(ds, ro, rd)
        pb, tb, _ = _brute_batched(ds.tri_packed, ro, rd)
        _compare_hits(f"{name} {what} bvh vs brute", pa, ta, pb, tb)


def ref_triton_brute(name: str):
    """The Triton sweep against the XLA sweep; returns the bounce
    wavefront for the timing that follows."""
    import jax
    import numpy as np

    from radish_pt_tpu.accel import brute_triton as bt
    from radish_pt_tpu.accel import traverse as trv

    ds, cam, _ = load(name)
    check(ds.intersector == "pallas_brute", f"{name} runs {ds.intersector}")
    o, d, bo, bd = _wavefronts(ds.replace(intersector="brute"), cam)
    xla = jax.jit(trv.intersect_brute)
    tri = jax.jit(bt.intersect_brute_triton)
    for what, ro, rd in (("primary", o, d), ("bounce", bo, bd)):
        pa, ta, _ = tri(ds.tri_packed, ro, rd)
        pb, tb, _ = xla(ds.tri_packed, ro, rd)
        _compare_hits(f"{name} {what} triton vs xla brute", pa, ta, pb, tb)
    y = bo + bd * 3.0
    occ_t = np.asarray(jax.jit(bt.occlusion_brute_triton)(ds.tri_packed, bo, y))
    occ_x = np.asarray(jax.jit(trv.occlusion_brute)(ds.tri_packed, bo, y))
    agree = float((occ_t == occ_x).mean())
    log(f"[reference] {name} occlusion triton vs xla: agree on "
        f"{agree * 100:.4f}% of {occ_t.size} segments")
    check(agree >= ID_MATCH_MIN, f"{name} occlusion agrees on {agree}")
    return ds.tri_packed, bo, bd


def _pairs_summary(t: dict) -> str:
    """Triton against XLA over paired samples: medians, quartiles, wins,
    and whether the gain clears the XLA side's own spread."""
    def stats(xs):
        q1, q2, q3 = statistics.quantiles(xs, n=4)
        return q1, q2, q3, f"median {q2:.3f} (quartiles {q1:.3f}-{q3:.3f})"

    x1, xm, x3, xla = stats(t["xla"])
    _, tm, _, tri = stats(t["triton"])
    wins = sum(a < b for a, b in zip(t["triton"], t["xla"]))
    holds = wins >= 0.9 * len(t["xla"]) and xm - tm > x3 - x1
    return (f"xla {xla}, triton {tri}, triton faster in {wins}/"
            f"{len(t['xla'])} pairs, gain {'holds' if holds else 'not shown'}"
            f"; xla {t['xla']}, triton {t['triton']}")


def time_triton_brute(name, tri_packed, bo, bd, r_xla, r_tri, n_frames):
    """Sweep alone and whole Renderer frame, XLA vs Triton: ``N_PAIRS``
    pairs, each side the median of ``n_frames`` runs, the side that runs
    first alternating from pair to pair."""
    import jax

    from radish_pt_tpu.accel import brute_triton as bt
    from radish_pt_tpu.accel import traverse as trv

    fns = {"xla": jax.jit(trv.intersect_brute),
           "triton": jax.jit(bt.intersect_brute_triton)}
    rend = {"xla": r_xla, "triton": r_tri}
    sweep = {"xla": [], "triton": []}
    whole = {"xla": [], "triton": []}

    def sweep_ms(k):
        ts = []
        for _ in range(n_frames):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[k](tri_packed, bo, bd))
            ts.append((time.perf_counter() - t0) * 1e3)
        return round(statistics.median(ts), 3)

    for k in fns:
        jax.block_until_ready(fns[k](tri_packed, bo, bd))
    for i in range(N_PAIRS):
        for k in (("xla", "triton") if i % 2 == 0 else ("triton", "xla")):
            sweep[k].append(sweep_ms(k))
            whole[k].append(round(statistics.median(
                timed_frames(rend[k], n_frames)), 3))
    log(f"[reference] {name} brute engines, sweep alone over "
        f"{bo.shape[0]} bounce rays, ms: {_pairs_summary(sweep)}")
    log(f"[reference] {name} brute engines, {r_xla.cam.width}x"
        f"{r_xla.cam.height} depth-5 Renderer frame, ms: "
        f"{_pairs_summary(whole)}")


def _frames_agree(what: str, a, b) -> None:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(bool(np.isfinite(a).all() and np.isfinite(b).all()),
          f"{what}: non-finite")
    ma, mb = a.mean(), b.mean()
    close = (np.abs(a - b) <= PIX_TOL + PIX_TOL * np.abs(b)).all(axis=-1)
    share = float(close.mean())
    rel = abs(ma - mb) / max(abs(mb), 1e-12)
    log(f"[reference] {what}: mean {ma:.6f} vs {mb:.6f} ({rel:.2e} rel), "
        f"{share * 100:.3f}% of pixels within tolerance")
    check(rel <= MEAN_REL_TOL, f"{what}: mean differs by {rel:.2e} rel")
    check(share >= PIX_MATCH_MIN, f"{what}: only {share:.4f} pixels agree")


FRAME_RES, FRAME_LOOPER, FRAME_DEPTH = 256, 3, 5


def ref_frame(name: str, where: str):
    """One fixed frame (d + ind) at 256x256: ``gpu`` (the scene's own
    engines), ``cpu`` (this process's CPU backend, XLA engines) or
    ``dense`` (GPU, no clusters: the dense masked loop, no sorts)."""
    import jax

    from radish_pt_tpu.render import pathtrace as pt

    ds, cam, _ = load(name)
    cam = cam.replace(width=FRAME_RES, height=FRAME_RES)
    if where == "cpu":
        cpu = jax.devices("cpu")[0]
        if ds.intersector == "pallas_brute":
            ds = ds.replace(intersector="brute")
        ds, cam = jax.device_put(ds, cpu), jax.device_put(cam, cpu)
    elif where == "dense":
        check(ds.cluster_bounds is not None, f"{name} has no clusters")
        ds = ds.replace(cluster_bounds=None)

    def run(ds, cam):
        d, ind = pt.path_trace(ds, cam, FRAME_LOOPER, FRAME_DEPTH)
        return d + ind

    img = jax.block_until_ready(jax.jit(run)(ds, cam))
    plat = list(img.devices())[0].platform
    want = "cpu" if where == "cpu" else jax.default_backend()
    check(plat == want, f"{name} {where} frame ran on {plat}, not {want}")
    return img


def reference_tasks():
    tasks = [(f"bvh:{name}", lambda n=name: ref_bvh_vs_brute(n))
             for name in ("teapot", "teapot_hires")]
    for name in ("cornell", "many_light"):
        # the Triton side of the timing is the render phase's renderer
        tasks.append((f"triton:{name}", lambda n=name: ref_triton_brute(n)))
        tasks.append((f"xla-brute:{name}", lambda n=name: warm_renderer(
            n, "pt", 5, engine="brute")))
    for name in ("cornell", "teapot", "glass"):
        for where in ("gpu", "cpu"):
            tasks.append((f"frames-{where}:{name}",
                          lambda n=name, w=where: ref_frame(n, w)))
    tasks.append(("frames-dense:teapot", lambda: ref_frame("teapot", "dense")))
    return tasks


def report_reference(done: dict, n_frames: int) -> None:
    for name in ("cornell", "many_light"):
        tri_packed, bo, bd = done[f"triton:{name}"][0]
        r_tri = done[f"{name}:pt"][0]
        check(r_tri.ds.intersector == "pallas_brute",
              f"{name} renders with {r_tri.ds.intersector}")
        time_triton_brute(name, tri_packed, bo, bd,
                          done[f"xla-brute:{name}"][0], r_tri, n_frames)
    for name in ("cornell", "teapot", "glass"):
        g, c = done[f"frames-gpu:{name}"][0], done[f"frames-cpu:{name}"][0]
        _frames_agree(f"{name} {FRAME_RES}x{FRAME_RES} depth "
                      f"{FRAME_DEPTH} GPU vs CPU", g, c)
    _frames_agree(f"teapot {FRAME_RES}x{FRAME_RES} sliced vs dense loop "
                  "(GPU)", done["frames-gpu:teapot"][0],
                  done["frames-dense:teapot"][0])


def phase_one_card(out_dir: str, n_frames: int) -> None:
    """Compile and check everything concurrently, then time one thing at
    a time."""
    from radish_pt_tpu.native import load_library
    from radish_pt_tpu.sampling.sobol import load_sobol_table

    load_library()  # build the native library once, before the threads
    load_sobol_table()  # and the Sobol table's disk cache
    record_compiles()
    tasks = render_tasks(out_dir) + reference_tasks()
    t0 = time.perf_counter()
    done = run_concurrently(tasks)
    log(f"[chip_smoke] {len(tasks)} tasks compiled, run and checked "
        f"concurrently in {time.perf_counter() - t0:.0f} s, process peak "
        f"{process_peak_bytes() / 2**30:.2f} GiB of device memory with all "
        "of them live; slowest: " + ", ".join(
            f"{k} {s:.0f} s" for k, (_, s, _) in sorted(
                done.items(), key=lambda kv: -kv[1][1])[:4]))
    (png, img), s, compiled = done["cli"]
    log(f"[render] cli cornell pt+svgf 800x800 4spp: {s:.1f} s wall incl. "
        f"compile, {compiled_note(compiled)}; PNG {img.shape} mean "
        f"{img.mean():.2f}/255 -> {png}")
    for name, mode, _ in RENDER_CASES:
        key = f"{name}:{mode}"
        r, first_s, compiled = done[key]
        report_render(key, r, first_s, compiled, n_frames)
    report_reference(done, n_frames)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _on_distinct_devices(what: str, arr, n: int) -> None:
    devs = {s.device for s in arr.addressable_shards}
    check(len(devs) == n, f"{what}: shards on {len(devs)} devices, want {n}")


def phase_cards4(res: int = 256) -> None:
    """The sharded path on 4 cards against one card (cornell)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radish_pt_tpu.config import ReservoirReuse
    from radish_pt_tpu.parallel import sharding as sh
    from radish_pt_tpu.render import denoise as dn
    from radish_pt_tpu.render import gbuffer as gb
    from radish_pt_tpu.render import pathtrace as pt
    from radish_pt_tpu.render import restir as rs

    devs = jax.devices()
    check(len(devs) >= 4, f"--cards 4 needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    depth, n_r = 5, res * res
    ds, cam, _ = load("cornell")
    cam = cam.replace(width=res, height=res)
    tile4 = sh.make_mesh(n_tile=4, n_sample=1, devices=devs)
    reuse = ReservoirReuse.TEMPORAL_SPATIAL

    def pt_mesh(n_tile, n_sample):
        mesh = sh.make_mesh(n_tile=n_tile, n_sample=n_sample, devices=devs)
        fn = jax.jit(partial(sh.render_frame_sharded, mesh, max_depth=depth))
        return jax.block_until_ready(fn(sh.replicate_scene(mesh, ds), cam, 3))

    def pt_one():
        one = jax.jit(lambda ds, cam, lp: sum(pt.path_trace(ds, cam, lp,
                                                            depth)))
        return one(ds, cam, 3), one(ds, cam, 3 + 37)

    res0, gbuf0 = rs.empty_reservoir(n_r), gb.empty_frame(n_r)
    direct0 = jnp.zeros((n_r, 3), jnp.float32)

    def restir_sharded():
        step = jax.jit(partial(sh.restir_step_sharded, tile4, reuse=reuse))
        put = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda x: sh.shard_image(tile4, x, cam), t)
        ds_m = sh.replicate_scene(tile4, ds)
        d, r, g = step(ds_m, cam, cam, 0, put(gbuf0), put(res0),
                       jnp.asarray(True), put(direct0), 0)
        d, r, g = step(ds_m, cam, cam, 1, g.frame, r, jnp.asarray(False), d, 1)
        return jax.block_until_ready(d)

    def restir_one():
        gfn = jax.jit(gb.render_gbuffer)
        rfn = jax.jit(lambda ds, cam, i, g, lf, r, first: rs.restir_direct(
            ds, cam, i, g, lf, r, first, reuse, 32, 20))
        res_, last_f, acc, first = res0, gbuf0, direct0, True
        for i in range(2):
            g = gfn(ds, cam, cam)
            d1, res_ = rfn(ds, cam, i, g, last_f, res_, jnp.asarray(first))
            acc = pt.accumulate(acc, pt.scrub_and_compress(d1), i)
            last_f, first = g.frame, False
        return acc

    color = jnp.asarray(np.random.default_rng(3).uniform(
        0, 2, (n_r, 3)).astype(np.float32))
    fn_dn = jax.jit(dn.svgf_filter, static_argnames=("levels",))

    def svgf(sharded):
        g = jax.jit(gb.render_gbuffer)(ds, cam, cam)
        args = (color, dn.empty_svgf_state(n_r), g, g.frame)
        if sharded:
            shard = NamedSharding(tile4, P("tile"))
            args = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, shard), args)
        out, _ = fn_dn(*args, cam, jnp.asarray(False), levels=5)
        return jax.block_until_ready(out)

    done = run_concurrently([
        ("pt 4x1", lambda: pt_mesh(4, 1)), ("pt 2x2", lambda: pt_mesh(2, 2)),
        ("pt one", pt_one), ("restir 4", restir_sharded),
        ("restir one", restir_one), ("svgf 4", lambda: svgf(True)),
        ("svgf one", lambda: svgf(False)),
    ])
    for k, (_, s, _) in done.items():
        log(f"[cards4] {k}: {s:.1f} s incl. compile (concurrent)")

    one3, one40 = done["pt one"][0]
    for k, ref in (("pt 4x1", one3), ("pt 2x2", (one3 + one40) / 2)):
        _on_distinct_devices(f"cornell PT mesh {k}", done[k][0], 4)
        _frames_agree(f"cornell PT mesh {k[3:]} vs one card", done[k][0], ref)

    d_sh = done["restir 4"][0]
    _on_distinct_devices("ReSTIR sharded accumulation", d_sh, 4)
    d_sh = np.asarray(d_sh)[:n_r].reshape(res, res, 3)
    d_ref = np.asarray(done["restir one"][0]).reshape(res, res, 3)
    band = np.zeros(res, bool)
    for k in (1, 2, 3):
        band[res // 4 * k - 5:res // 4 * k + 5] = True
    interior = float(np.abs(d_sh[~band] - d_ref[~band]).max())
    n_rej = int((np.abs(d_sh[band] - d_ref[band]).max(axis=-1) > 1e-6).sum())
    log(f"[cards4] ReSTIR 4 tiles {res}x{res}: interior max |diff| "
        f"{interior:.2e}, {n_rej} seam-band pixels differ (cross-card "
        f"rejections)")
    check(interior <= 1e-5 + 1e-5 * float(np.abs(d_ref).max()),
          "ReSTIR interior rows differ from one card")
    check(n_rej > 0, "no cross-card spatial rejections at the seams")

    out_s, out_ref = done["svgf 4"][0], done["svgf one"][0]
    _on_distinct_devices("sharded SVGF", out_s, 4)
    err = float(np.abs(np.asarray(out_s) - np.asarray(out_ref)).max())
    log(f"[cards4] SVGF over 4 cards vs one card: max |diff| {err:.2e}")
    check(err <= 1e-4, f"sharded SVGF differs by {err}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path on four cards")
    ap.add_argument("--out-dir", default=None,
                    help="keep the saved PNG here (default: a temp dir)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "radish_pt_tpu")):
        print("chip_smoke.py runs from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[device] JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    log(f"[device] {gpu_card()}")
    log(f"[device] jax {jax.__version__}: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}")

    from radish_pt_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    t_start = time.perf_counter()
    try:
        if args.cards == 4:
            phase_cards4()
            count = 4
        else:
            with tempfile.TemporaryDirectory() as tmp:
                out_dir = args.out_dir or tmp
                os.makedirs(out_dir, exist_ok=True)
                phase_one_card(out_dir, N_FRAMES)
            count = 1  # every one-card phase runs on jax.devices()[0]
    except CheckFailed as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[chip_smoke] all checks passed in "
        f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
