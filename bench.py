#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line for the driver.

Metric: "Mrays/s + ms/frame at 800x800 1spp (Cornell, teapot); ReSTIR frame
time".  The reference publishes no numbers, so vs_baseline is measured
against an interactive-rendering target of 33.3 ms/frame (30 fps) at 800x800
— the bar the reference's ImGui-driven interactive loop implicitly sets.

It measures the GPU only: with no GPU it exits non-zero.  Every line names
the device (platform, ``device_kind``, count) and the card's name and power
limit from ``nvidia-smi``.

INCREMENTAL EMISSION: the running JSON line is re-printed after every
completed measurement, so a timeout mid-run still leaves the last printed
line parseable with every finished number.

Run: python bench.py [--quick] [--json-only] [--scenes ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_TARGET_MS = 33.33  # 30 fps interactive target

# Image-regression guard (the 800^2 analogue of the tiny CPU goldens): mean
# radiance of frame looper=7 per scene, pinned before the GPU port; re-pin
# them on the H100 only with the reason written down (ROADMAP Speed 2).
# Engine changes that corrupt results show up here as drift even when they
# keep prim-id parity on the small CPU fixtures.
MEAN_GOLDEN = {
    "cornell": 1.00752,
    "teapot": 0.43335,
    "glass": 0.35154,
    "teapot_hires": 0.43550,
    "many_light": 0.17366,
}

# the slowest scenes first: a timeout then still captures the claims that
# most need confirmation
SCENE_ORDER = ("glass", "teapot_hires", "many_light", "teapot", "cornell")


def _time_frames(step_fn, n_warmup: int = 2, n_iter: int = 8, reps: int = 3):
    """Median of ``reps`` timed blocks (each ``n_iter`` frames, one
    ``block_until_ready`` at the end), after ``n_warmup`` frames.
    Returns (median_ms, min_ms, max_ms)."""
    import jax

    for i in range(n_warmup):
        jax.block_until_ready(step_fn(i))
    samples = []
    k = n_warmup
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(n_iter):
            out = step_fn(k)
            k += 1
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / n_iter * 1e3)
    samples.sort()
    return samples[len(samples) // 2], samples[0], samples[-1]


def gpu_card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench(quick: bool = False, verbose: bool = True, only: list | None = None,
          emit=None):
    import jax

    from radish_pt_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    from radish_pt_tpu.config import ReservoirReuse
    from radish_pt_tpu.render import gbuffer as gb
    from radish_pt_tpu.render import pathtrace as pt
    from radish_pt_tpu.render import restir as rs
    from radish_pt_tpu.scene.build import load_scene

    res = 256 if quick else 800
    depth = 5
    results = {}

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr)

    def checkpoint():
        """Re-print the running JSON line (see module docstring)."""
        if emit is not None:
            emit(results, res)

    scenes = []
    for nm in SCENE_ORDER:
        fname = "cornell_box.txt" if nm == "cornell" else f"{nm}.txt"
        path = os.path.join(REPO, "scenes", fname)
        if os.path.exists(path):
            scenes.append((nm, path))
    if quick:
        scenes = [(n, p) for n, p in scenes if n in ("cornell", "teapot")]
    if only:
        scenes = [(n, p) for n, p in scenes if n in only]

    for name, path in scenes:
        t_scene = time.perf_counter()
        # one failing config must not zero the whole bench (the driver
        # records this output verbatim)
        try:
            ds, cam, desc = load_scene(path)
            cam = cam.replace(width=res, height=res)
            n_rays_primary = res * res

            # CLOSURE-form jit: scene/camera as baked constants, looper as
            # the only argument (ROADMAP Speed 6 compares the argument form)
            fn = jax.jit(lambda looper: pt.path_trace(ds, cam, looper, depth))
            big = name == "teapot_hires"
            ms, ms_lo, ms_hi = _time_frames(
                lambda i: fn(i),
                n_warmup=1 if big else 2,
                n_iter=2 if big else 8,
                reps=2 if big else 3,
            )
        except Exception as e:  # noqa: BLE001
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            results[f"{name}_error"] = f"{type(e).__name__}: {e}"[:200]
            checkpoint()
            continue
        # rays per frame: primary + per-bounce (extension + shadow) upper bound
        # count the *primary* figure like the reference's per-frame quote
        mrays = n_rays_primary * (1 + 2 * depth) / (ms * 1e-3) / 1e6
        results[f"{name}_pt_ms"] = round(ms, 3)
        results[f"{name}_pt_ms_spread"] = [round(ms_lo, 3), round(ms_hi, 3)]
        results[f"{name}_pt_mrays"] = round(mrays, 2)
        log(f"[{name}] full PT {res}x{res} depth={depth}: {ms:.2f} ms/frame "
            f"(min {ms_lo:.2f} / max {ms_hi:.2f}), {mrays:.1f} Mrays/s")
        checkpoint()

        if not quick and res == 800:
            try:
                import numpy as np

                d7, i7 = fn(7)
                mean = float((np.asarray(d7) + np.asarray(i7)).mean())
                results[f"{name}_mean"] = round(mean, 5)
                gold = MEAN_GOLDEN.get(name)
                if gold is not None and abs(mean - gold) > 2e-3 * gold:
                    results[f"{name}_mean_drift_from"] = gold
                    log(f"[{name}] WARNING: mean radiance {mean:.5f} "
                        f"drifted from golden {gold:.5f}")
            except Exception as e:  # noqa: BLE001
                log(f"[{name} mean] skipped: {type(e).__name__}: {e}")
            checkpoint()

        # batched steady state: block spp per dispatch (fori_loop in one
        # jit) — the per-frame cost without per-dispatch overhead
        try:
            from radish_pt_tpu.render.renderer import _pt_batch

            block = 2 if name == "teapot_hires" else 4
            # closure-form like the single frame; the mutable accumulation
            # buffers stay arguments for donation
            bfn = jax.jit(
                lambda looper, d, ind, it: _pt_batch(
                    ds, cam, looper, d, ind, it,
                    max_depth=depth, block=block,
                ),
                donate_argnums=(1, 2),
            )
            n = res * res

            def run_batched():
                pstate = {
                    "direct": jnp.zeros((n, 3), jnp.float32),
                    "indirect": jnp.zeros((n, 3), jnp.float32),
                }

                def pt_batched_step(i):
                    d, ind = bfn(i * block, pstate["direct"],
                                 pstate["indirect"], i * block)
                    pstate.update(direct=d, indirect=ind)
                    return d

                return _time_frames(
                    pt_batched_step, n_warmup=1,
                    n_iter=2 if (quick or name == "teapot_hires") else 4,
                )

            ms_pb, pb_lo, pb_hi = run_batched()
            ms_pb, pb_lo, pb_hi = ms_pb / block, pb_lo / block, pb_hi / block
            results[f"{name}_pt_batched_ms"] = round(ms_pb, 3)
            results[f"{name}_pt_batched_ms_spread"] = [
                round(pb_lo, 3), round(pb_hi, 3)
            ]
            log(f"[{name}] full PT steady-state (batched x{block}): "
                f"{ms_pb:.2f} ms/spp (min {pb_lo:.2f} / max {pb_hi:.2f})")
        except Exception as e:  # noqa: BLE001
            log(f"[{name} batched] FAILED: {type(e).__name__}: {e}")
            results[f"{name}_batched_error"] = f"{type(e).__name__}: {e}"[:200]
        checkpoint()

        # ReSTIR frame (gbuffer + restir kernel), cornell only
        if name == "cornell":
          try:
            gfn = jax.jit(gb.render_gbuffer)
            gbuf = gfn(ds, cam, cam)
            jax.block_until_ready(gbuf)
            n = res * res
            reservoir = rs.empty_reservoir(n)

            rfn = jax.jit(
                lambda ds, cam, looper, gbuf, lastf, lastr, first: rs.restir_direct(
                    ds, cam, looper, gbuf, lastf, lastr, first,
                    ReservoirReuse.TEMPORAL_SPATIAL, 32, 20,
                )
            )

            state = {"res": reservoir, "first": True}

            def restir_step(i):
                gbuf_i = gfn(ds, cam, cam)
                d, r = rfn(
                    ds, cam, i, gbuf_i, gbuf_i.frame, state["res"],
                    jnp.asarray(state["first"]),
                )
                state["res"] = r
                state["first"] = False
                return d

            ms_r, _, _ = _time_frames(
                restir_step, n_warmup=2, n_iter=4 if quick else 8
            )
            results["restir_frame_ms"] = round(ms_r, 3)
            log(f"[cornell] ReSTIR frame (gbuffer + 32-candidate RIS + T+S reuse): {ms_r:.2f} ms")
            checkpoint()

            # steady-state batched ReSTIR: 8 frames per dispatch with carried
            # reservoir state (render/renderer.py::_restir_batch)
            from functools import partial

            from radish_pt_tpu.render.renderer import _restir_batch

            block = 8
            bfn = jax.jit(
                partial(
                    _restir_batch,
                    reuse=ReservoirReuse.TEMPORAL_SPATIAL,
                    reservoir_size=32, clamp=20, encode_normal=False,
                    block=block,
                ),
                donate_argnums=(7,),
            )

            def run_restir_batched():
                bstate = {
                    "res": rs.empty_reservoir(n),
                    "direct": jnp.zeros((n, 3), jnp.float32),
                    "last": gbuf.frame,
                    "first": True,
                }

                def restir_batched_step(i):
                    d, r, g = bfn(
                        ds, cam, cam, i * block, bstate["last"],
                        bstate["res"], jnp.asarray(bstate["first"]),
                        bstate["direct"], i * block,
                    )
                    bstate.update(res=r, direct=d, last=g.frame, first=False)
                    return d

                return _time_frames(
                    restir_batched_step, n_warmup=2, n_iter=2 if quick else 4
                )

            ms_b, _, _ = run_restir_batched()
            ms_b = ms_b / block
            results["restir_batched_ms"] = round(ms_b, 3)
            log(f"[cornell] ReSTIR steady-state (batched x{block}): {ms_b:.2f} ms/frame")
          except Exception as e:  # noqa: BLE001
            log(f"[cornell restir] FAILED: {type(e).__name__}: {e}")
            results["restir_error"] = f"{type(e).__name__}: {e}"[:200]
          checkpoint()
        log(f"[{name}] scene total {time.perf_counter() - t_scene:.0f} s")

    return results, res


def _pack(results, res, device):
    """Assemble the driver JSON from the running results dict."""
    primary = 0.0
    for k in ("teapot_pt_ms", "glass_pt_ms", "cornell_pt_ms",
              "teapot_hires_pt_ms", "many_light_pt_ms"):
        if results.get(k):
            primary = results[k]
            break
    return {
        "metric": "ms/frame full-MIS PT 800x800 1spp depth5 (teapot if present else glass/cornell)",
        "value": primary,
        "unit": "ms",
        "vs_baseline": round(BASELINE_TARGET_MS / primary, 3) if primary else 0.0,
        "detail": dict(results),
        "resolution": res,
        "device": device,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="256x256, fewer iters")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="bench only these scene names (timeout-window runs)")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(1)
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": gpu_card(),
    }

    def emit(results, res):
        print(json.dumps(_pack(results, res, device)), flush=True)

    results, res = bench(quick=args.quick, verbose=not args.json_only,
                         only=args.scenes, emit=emit)
    emit(results, res)


if __name__ == "__main__":
    main()
