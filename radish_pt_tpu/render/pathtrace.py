"""Wavefront path tracer with MIS next-event estimation.

Wavefront re-design of the reference megakernels
(``singleKernelPT`` /root/reference/src/pathtrace.cu:149-291 and
``PTDirectKernel`` pathtrace.cu:293-345).  The per-thread bounce loop becomes
a lockstep masked wavefront over all pixels: every bounce runs ray-gen /
intersect / NEE / BSDF-sample stages on [N]-shaped SoA state, with dead lanes
masked out, and the two BVH walks per bounce (closest-hit + shadow) are
lockstep ``while_loop``s over dense device arrays.

Deviations from the reference (documented, intentional):
* Primary-ray miss shades from the env map (or black), not the debug
  ``vec3(1)`` placeholder at pathtrace.cu:169-171.
* Primary-visible lights shade their radiance like ``PTDirectKernel``
  (pathtrace.cu:318-321), not ``vec3(1)``.
* Light/env pdfs use the consistent power-proportional formulas (see
  scene/device_scene.py docstring).
* Depth-of-field aperture sampling is wired in (the reference fixes
  pAperture = 0; sceneStructs.h:81).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..bsdf import materials as bsdf
from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..sampling import rng
from ..utils import math as m

NULL_PRIMITIVE = -1


def _pixel_grid(cam: cam_mod.Camera, pixel_idx=None):
    """Pixel lane indices; pass an explicit shard of flat indices to render a
    subset of the image (multi-chip tile parallelism, parallel/sharding.py)."""
    if pixel_idx is None:
        pixel_idx = jnp.arange(cam.width * cam.height, dtype=jnp.int32)
    x = pixel_idx % cam.width
    y = pixel_idx // cam.width
    return pixel_idx, x, y


def sample_aperture(ds: dsc.DeviceScene, r2):
    """Sample a lens point in [-1,1]^2: custom aperture mask (alias table over
    mask luminance, scene.cpp:171-188) or uniform concentric disk."""
    if not ds.has_aperture:
        return m.concentric_sample_disk(r2[..., 0], r2[..., 1])
    from ..sampling.alias import alias_sample

    pix = alias_sample(
        ds.aperture_alias_prob, ds.aperture_alias_idx, r2[..., 0], r2[..., 1]
    )
    w = ds.tex_width[ds.aperture_tex]
    h = ds.tex_height[ds.aperture_tex]
    y = pix // w
    x = pix - y * w
    u = (x.astype(jnp.float32) + 0.5) / w.astype(jnp.float32)
    v = (y.astype(jnp.float32) + 0.5) / h.astype(jnp.float32)
    return jnp.stack([u * 2.0 - 1.0, v * 2.0 - 1.0], axis=-1)


def _gen_primary(ds, cam, sampler, pixel_idx=None):
    """Primary ray generation with jitter + aperture."""
    _, x, y = _pixel_grid(cam, pixel_idx)
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    p_ap = sample_aperture(ds, r4[..., 2:4])
    ray_o, ray_d = cam_mod.sample_rays(cam, x, y, r4, p_aperture=p_ap)
    return ray_o, ray_d, sampler


def _light_visible_side(ds, norm, ray_d):
    """Single-sided emission test for a ray hitting a light: front side is
    the geometric-normal side (consistent convention; see device_scene)."""
    if not ds.single_sided:
        return jnp.ones(norm.shape[:-1], bool)
    return m.dot(norm, ray_d) < 0.0


def _compact_mode():
    """Wavefront-compaction mode from ``RADISH_COMPACT``:

    * unset      -> ``("slices", 4)`` — the sliced bounce loop
      (:func:`_sliced_bounce_loop`); the slice count is not tuned on the
      GPU yet (ROADMAP Speed 4).
    * ``"0"``    -> ``None`` (dense masked loop).
    * ``"<m>"``  -> ``("slices", m)``.
    * ``"a,b"``  -> ``("tiers", (a, b, ...))`` — the round-4 tiered loop
      (:func:`_compact_bounce_loop`), kept for A/B and regression tests.
    """
    env = os.environ.get("RADISH_COMPACT", "")
    if env == "0":
        return None
    if "," in env:
        return ("tiers", tuple(int(x) for x in env.split(",")))
    if env:
        return ("slices", int(env))
    return ("slices", 4)


def path_trace(
    ds: dsc.DeviceScene,
    cam: cam_mod.Camera,
    looper,
    max_depth: int,
    pixel_idx=None,
):
    """Full-MIS path trace, one sample per pixel.

    Returns (direct [N,3], indirect [N,3]) — the same split as the reference:
    ``direct`` holds primary-visible emission + first-vertex NEE, everything
    else lands in ``indirect`` (pathtrace.cu:203,244,269).
    """
    idx, _, _ = _pixel_grid(cam, pixel_idx)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    # derive from ray state so the buffers inherit shard_map varying axes
    # (plain zeros would be replicated constants and fail the fori carry check)
    direct = ray_d * 0.0
    indirect = ray_d * 0.0

    it = dsc.intersect(ds, ray_o, ray_d)

    hit = it.prim_id != NULL_PRIMITIVE
    direct += jnp.where(hit[..., None], 0.0, dsc.env_radiance(ds, ray_d))

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm, ray_d)
    direct += jnp.where(
        (is_light & light_vis)[..., None], mat.base_color, 0.0
    )

    active = hit & ~is_light
    throughput = ray_d * 0.0 + 1.0
    pos = it.pos

    mode = _compact_mode()
    # compaction pays only when the sweeps it shrinks dominate the sorts it
    # adds, so small scenes keep the dense masked loop (the threshold is
    # not measured on the GPU yet, ROADMAP Speed 4).
    # RADISH_COMPACT_MIN_TRIS overrides the 2000-triangle threshold.
    min_tris = int(os.environ.get("RADISH_COMPACT_MIN_TRIS", "2000"))
    if (mode is not None and ds.cluster_bounds is not None
            and max_depth >= 1 and ds.num_triangles >= min_tris):
        kind, arg = mode
        loop = (_compact_bounce_loop if kind == "tiers"
                else _sliced_bounce_loop)
        return loop(
            ds, sampler, active, throughput, direct, indirect,
            pos, norm, ray_d, mat, max_depth, arg,
        )

    wo = -ray_d

    def bounce(depth, carry):
        """One bounce of the reference loop (pathtrace.cu:187-272).  A
        ``fori_loop`` body instead of an unrolled chain keeps the compiled
        graph (and compile time) independent of trace depth."""
        (sampler, active, throughput, direct, indirect,
         pos, norm, ray_d, mat) = carry
        wo = -ray_d

        is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
        # two-sided shading for non-delta materials (pathtrace.cu:190-193)
        flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
        norm = jnp.where(flip[..., None], -norm, norm)

        # ---- NEE with MIS (pathtrace.cu:195-207) ----
        r4, sampler = rng.sample_4d(ds.sobol, sampler)
        li, wi, light_pdf = dsc.sample_direct_light(
            ds, pos, r4, mask=active & ~is_delta_bsdf, shade_normal=norm
        )
        nee_ok = active & (~is_delta_bsdf) & (light_pdf > 0.0)
        f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
        b_pdf = bsdf.bsdf_pdf(mat, norm, wo, wi, types=ds.mat_types)
        mis_w = m.power_heuristic(light_pdf, b_pdf)
        contrib = (
            throughput
            * f
            * li
            * (m.sat_dot(norm, wi) / jnp.maximum(light_pdf, 1e-12) * mis_w)[..., None]
        )
        contrib = jnp.where(nee_ok[..., None], contrib, 0.0)
        # first-vertex NEE -> direct, the rest -> indirect (pathtrace.cu:203)
        is_first = depth == 1
        direct = direct + jnp.where(is_first, contrib, 0.0)
        indirect = indirect + jnp.where(is_first, 0.0, contrib)

        # ---- BSDF sample (pathtrace.cu:210-223) ----
        r3, sampler = rng.sample_3d(ds.sobol, sampler)
        samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
        bad = bsdf.is_invalid(samp.type) | (samp.pdf < 1e-8)
        active = active & ~bad
        delta_sample = bsdf.is_delta(samp.type)
        cos_term = jnp.where(delta_sample, 1.0, m.abs_dot(norm, samp.dir))
        throughput = throughput * samp.bsdf * (
            cos_term / jnp.maximum(samp.pdf, 1e-12)
        )[..., None]

        # ---- extend ray (pathtrace.cu:225-228); bounce rays are divergent,
        # so sort them by (octant, origin cell) to keep block culling alive
        prev_pos = pos
        ray_d = samp.dir
        ray_o = prev_pos + ray_d * 1e-5
        it = dsc.intersect_sorted(ds, ray_o, ray_d, active=active)
        pos = it.pos

        miss = active & (it.prim_id == NULL_PRIMITIVE)
        if ds.has_env:
            env_pdf = dsc.env_map_pdf(ds, ray_d)
            w_env = jnp.where(
                delta_sample, 1.0, m.power_heuristic(samp.pdf, env_pdf)
            )
            indirect = indirect + jnp.where(
                miss[..., None],
                dsc.env_radiance(ds, ray_d) * throughput * w_env[..., None],
                0.0,
            )
        active = active & ~miss

        mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
        hit_light = active & (mat.mtype == dsc.MAT_LIGHT)
        light_vis = _light_visible_side(ds, norm, ray_d)
        light_pdf_hit = dsc.area_light_hit_pdf(
            ds, mat.base_color, prev_pos, pos, norm
        )
        w_light = jnp.where(
            delta_sample, 1.0, m.power_heuristic(samp.pdf, light_pdf_hit)
        )
        indirect = indirect + jnp.where(
            (hit_light & light_vis)[..., None],
            mat.base_color * throughput * w_light[..., None],
            0.0,
        )
        active = active & ~hit_light
        return (sampler, active, throughput, direct, indirect,
                pos, norm, ray_d, mat)

    carry = (sampler, active, throughput, direct, indirect,
             pos, norm, ray_d, mat)
    carry = jax.lax.fori_loop(1, max_depth + 1, bounce, carry)
    return carry[3], carry[4]


def _nee_contrib(ds, sampler, active, mat, norm, wo, pos, throughput):
    """Next-event estimation with MIS at the current vertex; returns
    (contrib [K,3] — zero on masked lanes, sampler).

    ``RADISH_NEE_SORT=0`` (trace-time env, A/B knob) skips the shadow-ray
    signature sort — candidate saving inside the compact loop, whose lanes
    arrive extension-sorted and mostly live.  Results are bitwise
    identical either way (sorting only reorders independent per-lane
    math)."""
    if os.environ.get("RADISH_PROBE_NONEE"):  # timing attribution ONLY:
        return throughput * 0.0, sampler      # wrong image, NEE-free frame
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, light_pdf = dsc.sample_direct_light(
        ds, pos, r4, mask=active & ~is_delta, shade_normal=norm,
        sort=os.environ.get("RADISH_NEE_SORT", "1") != "0",
    )
    nee_ok = active & (~is_delta) & (light_pdf > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    b_pdf = bsdf.bsdf_pdf(mat, norm, wo, wi, types=ds.mat_types)
    mis_w = m.power_heuristic(light_pdf, b_pdf)
    contrib = (
        throughput * f * li
        * (m.sat_dot(norm, wi) / jnp.maximum(light_pdf, 1e-12) * mis_w)[
            ..., None]
    )
    return jnp.where(nee_ok[..., None], contrib, 0.0), sampler


def _bsdf_advance(ds, sampler, active, mat, norm, wo, throughput):
    """BSDF importance sample + throughput update; returns
    (sampler, active, throughput, new_dir, pdf, delta_sample)."""
    r3, sampler = rng.sample_3d(ds.sobol, sampler)
    samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
    bad = bsdf.is_invalid(samp.type) | (samp.pdf < 1e-8)
    active = active & ~bad
    delta_sample = bsdf.is_delta(samp.type)
    cos_term = jnp.where(delta_sample, 1.0, m.abs_dot(norm, samp.dir))
    throughput = throughput * samp.bsdf * (
        cos_term / jnp.maximum(samp.pdf, 1e-12)
    )[..., None]
    return sampler, active, throughput, samp.dir, samp.pdf, delta_sample


def _ext_and_fetch(ds, pos, new_dir, pdf, delta_sample, active,
                   throughput, scramble, lane, acc):
    """Extension segment of one bounce in COMPACT space: signature-sort the
    rays (dead lanes to the back — the compaction), sweep, recover the hit
    surface, and account env-miss / emissive-hit MIS into the per-lane
    accumulator.  Everything returns in the new sorted order; there is no
    inverse permutation (the caller's whole carry lives in this order).

    ``acc`` None means "all zero" (the peeled first bounce) — the columns
    then skip the forward sort entirely.

    Returns the next-bounce carry slice:
    ``(lane, scramble, active, throughput, acc, pos, norm, dir, mat)``.
    """
    ray_o = pos + new_dir * 1e-5
    # NOTE (measured dead end): pre-shading "sure miss" rays whose
    # signature flags no cluster catches 0.0% of real misses — every
    # bounce ray starts inside its origin cluster's AABB, so the slab
    # test always flags at least one cluster.
    # lane ids are non-negative: pack the delta-BSDF flag in bit 0 so the
    # flag rides the sort without its own payload column
    lane_pk = (lane << 1) | delta_sample.astype(jnp.int32)
    extras = (lane_pk, scramble,
              throughput[:, 0], throughput[:, 1], throughput[:, 2], pdf)
    if acc is not None:
        extras = extras + (acc[:, 0], acc[:, 1], acc[:, 2])
    it, o_s, d_s, act_s, ex = dsc.intersect_compact(
        ds, ray_o, new_dir, active, extras
    )
    lane_pk_s, scr_s = ex[0], ex[1]
    thr_s = jnp.stack(ex[2:5], axis=-1)
    pdf_s = ex[5]
    acc_s = jnp.stack(ex[6:9], axis=-1) if acc is not None else d_s * 0.0
    delta_s = (lane_pk_s & 1) != 0
    lane_s = lane_pk_s >> 1

    miss = act_s & (it.prim_id == NULL_PRIMITIVE)
    if ds.has_env:
        env_pdf = dsc.env_map_pdf(ds, d_s)
        w_env = jnp.where(delta_s, 1.0, m.power_heuristic(pdf_s, env_pdf))
        acc_s = acc_s + jnp.where(
            miss[..., None],
            dsc.env_radiance(ds, d_s) * thr_s * w_env[..., None],
            0.0,
        )
    act_s = act_s & ~miss

    mat_new, norm_new = dsc.get_textured_material(ds, it.mat_id, it.uv,
                                                  it.norm)
    hit_light = act_s & (mat_new.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm_new, d_s)
    # prev_pos for the area->solid-angle pdf: undo the origin inset instead
    # of sorting 3 more payload columns (the ~1e-12 residual is far below
    # the pdf's own conditioning)
    lp_hit = dsc.area_light_hit_pdf(
        ds, mat_new.base_color, o_s - d_s * 1e-5, it.pos, norm_new
    )
    w_light = jnp.where(delta_s, 1.0, m.power_heuristic(pdf_s, lp_hit))
    acc_s = acc_s + jnp.where(
        (hit_light & light_vis)[..., None],
        mat_new.base_color * thr_s * w_light[..., None],
        0.0,
    )
    act_s = act_s & ~hit_light
    return (lane_s, scr_s, act_s, thr_s, acc_s, it.pos, norm_new, d_s,
            mat_new)


def _compact_bounce_loop(ds, sampler, active, throughput, direct, indirect,
                         pos, norm, ray_d, mat, max_depth, divs):
    """Bounces with WAVEFRONT COMPACTION: the extension pass's signature
    sort (which already packs dead lanes to the back) doubles as a stream
    compactor, and each subsequent bounce processes only a static
    live-prefix capacity chosen at runtime from ``_compact_divs()`` tiers
    via ``lax.switch``.

    Measured motivation (800^2 depth-5 wavefronts, this repo's scenes):
    liveness entering bounces 2..5 is 36%/16%/8%/4% on teapot(+hires),
    21%/13%/3%/1% on glass — but sorts, cull prepasses, surface gathers and
    shading all previously paid full-wavefront cost every bounce.  The
    carry rides in sorted order (no inverse permutes at all); per-lane
    radiance accumulates in a compact ``acc`` column and is delivered to
    the pixel-order image by ONE final inverse sort, exploiting that the
    carried lane column is always a permutation of 0..N-1 (tier slicing
    only freezes the dead tail, it never drops or duplicates a lane).

    Invariants:
    * live lanes always occupy ``[0:valid]`` of the carry, where ``valid``
      is the live count at the previous extension sort;
    * ``valid`` (and so the tier) is non-increasing across bounces;
    * RNG parity with the dense loop is exact for every live lane — the
      shared scalar ``ptr`` advances in lockstep in every tier branch and
      each lane's scramble chain rides the sorts.
    """
    n = pos.shape[0]
    ks = sorted({min(n, -(-n // d)) for d in divs})
    if ks[-1] != n:
        ks.append(n)

    # ---- peel bounce 1 (full wavefront; its NEE lands in `direct`) ----
    wo = -ray_d
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta) & (m.dot(norm, wo) < 0.0)
    norm = jnp.where(flip[..., None], -norm, norm)
    contrib, sampler = _nee_contrib(ds, sampler, active, mat, norm, wo,
                                    pos, throughput)
    direct = direct + contrib
    sampler, active, throughput, new_dir, pdf, delta_sample = _bsdf_advance(
        ds, sampler, active, mat, norm, wo, throughput
    )
    lane = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.sum(active).astype(jnp.int32)
    (lane, scr, active, throughput, acc, pos, norm, ray_d, mat) = (
        _ext_and_fetch(ds, pos, new_dir, pdf, delta_sample, active,
                       throughput, sampler.scramble, lane, acc=None)
    )

    # ---- bounces 2..max_depth at tiered capacity ----
    def make_branch(k):
        def branch(carry):
            (ptr, scr, lane, active, thr, acc, pos, norm, rd, mat,
             valid) = carry
            sl = lambda a: a[:k]  # noqa: E731
            scr_, lane_, act_, thr_, acc_, pos_, norm_, rd_ = map(
                sl, (scr, lane, active, thr, acc, pos, norm, rd)
            )
            mat_ = jax.tree_util.tree_map(sl, mat)
            smp = rng.SamplerState(scramble=scr_, ptr=ptr)
            wo = -rd_
            is_delta = mat_.mtype == dsc.MAT_DIELECTRIC
            flip = (~is_delta) & (m.dot(norm_, wo) < 0.0)
            norm_ = jnp.where(flip[..., None], -norm_, norm_)
            contrib, smp = _nee_contrib(ds, smp, act_, mat_, norm_, wo,
                                        pos_, thr_)
            acc_ = acc_ + contrib
            smp, act_, thr_, new_dir, pdf, delta_sample = _bsdf_advance(
                ds, smp, act_, mat_, norm_, wo, thr_
            )
            new_valid = jnp.sum(act_).astype(jnp.int32)
            (lane_, scr_, act_, thr_, acc_, pos_, norm_, rd_, mat_) = (
                _ext_and_fetch(ds, pos_, new_dir, pdf, delta_sample, act_,
                               thr_, smp.scramble, lane_, acc_)
            )
            wr = lambda full, part: full.at[:k].set(part)  # noqa: E731
            return (
                smp.ptr,
                wr(scr, scr_), wr(lane, lane_), wr(active, act_),
                wr(thr, thr_), wr(acc, acc_), wr(pos, pos_),
                wr(norm, norm_), wr(rd, rd_),
                jax.tree_util.tree_map(wr, mat, mat_),
                new_valid,
            )
        return branch

    branches = [make_branch(k) for k in ks]
    k_bounds = jnp.asarray(ks[:-1], jnp.int32)

    def body(_d, carry):
        tier = jnp.sum(k_bounds < carry[-1]).astype(jnp.int32)
        return jax.lax.switch(tier, branches, carry)

    carry = (sampler.ptr, scr, lane, active, throughput, acc, pos, norm,
             ray_d, mat, valid)
    carry = jax.lax.fori_loop(2, max_depth + 1, body, carry)
    lane, acc = carry[2], carry[5]

    # ---- deliver the compact accumulators to pixel order: the lane column
    # is a permutation of 0..n-1, so one 4-column sort is the exact inverse
    u = jax.lax.sort((lane, acc[:, 0], acc[:, 1], acc[:, 2]), num_keys=1)
    indirect = indirect + jnp.stack(u[1:4], axis=-1)
    return direct, indirect


def _sliced_bounce_loop(ds, sampler, active, throughput, direct, indirect,
                        pos, norm, ray_d, mat, max_depth, n_slices):
    """Wavefront compaction via ONE global (dead | signature) sort per
    bounce + a dynamic-trip-count loop over fixed-size slices — the
    round-5 successor to the tiered :func:`_compact_bounce_loop`.

    Per bounce, a single ``lax.sort`` both compacts (dead lanes carry the
    high key bit and sink to the back) and signature-orders the PENDING
    extension rays; the live prefix is then processed in ``ceil(valid/S)``
    slices of ``S = ceil(n / n_slices)`` lanes by a ``while_loop`` whose
    body does sweep -> env/emissive-hit accounting -> surface refetch ->
    NEE -> BSDF-sample -> next sort key.  Versus the tiered loop this

    * kills the TIER LAG: the sort runs at the start of the next bounce,
      so post-sweep deaths (misses, emissive hits) are compacted before
      any capacity decision — the round-4 design's tier was bounded by the
      PRE-sweep live count, costing every scene one full-capacity bounce;
    * compiles ONE advance body (shape [S], :func:`advance` inside) instead
      of one per ``lax.switch`` tier — only the cheap sort branches still
      switch over whole-slice capacities;
    * quantizes capacity at S (n / n_slices) instead of powers of two.

    The winner id never crosses a sort: sweep and surface refetch happen
    in the same slice, so the carry is 16 flat columns
    ``(key, lane<<1|delta, scramble, throughput*3, acc*3, o*3, d*3,
    bsdf_pdf)`` — the same 15 payload columns the tiered loop's extension
    sort carried, now at post-sweep capacity.

    Bitwise identical to the dense loop for every live lane: the scalar
    RNG ptr advances 7/bounce in lockstep, each lane's scramble chain
    rides the sorts, and slicing only freezes dead lanes (the lane column
    stays a permutation of 0..n-1 for the final delivery sort).
    """
    n = pos.shape[0]
    S = -(-n // n_slices)
    n_slices = -(-n // S)
    caps = []
    c = 1
    while c < n_slices:
        caps.append(c * S)
        c *= 2
    caps.append(n)

    # ---- peel bounce 1 (full wavefront; its NEE lands in `direct`) ----
    wo = -ray_d
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta) & (m.dot(norm, wo) < 0.0)
    norm = jnp.where(flip[..., None], -norm, norm)
    contrib, sampler = _nee_contrib(ds, sampler, active, mat, norm, wo,
                                    pos, throughput)
    direct = direct + contrib
    sampler, active, throughput, new_dir, pdf, delta = _bsdf_advance(
        ds, sampler, active, mat, norm, wo, throughput
    )
    lane = jnp.arange(n, dtype=jnp.int32)
    ray_o = pos + new_dir * 1e-5
    key = dsc._sort_key(ds, ray_o, new_dir) + jnp.where(
        active, 0, dsc._DEAD_KEY_BIT
    )
    # derive zeros from ray state so the fori carry inherits shard_map
    # varying axes (fresh constants would be replicated and fail the
    # carry variance check — same pattern as accel/traverse.py)
    zero = throughput[:, 0] * 0.0
    # scramble seeds from the pixel id only (tile-varying); XOR in a zero
    # derived from the key so it matches the loop's (tile, sample) output
    scr0 = sampler.scramble ^ (key * 0).astype(jnp.uint32)
    cols = (
        key, (lane << 1) | delta.astype(jnp.int32), scr0,
        throughput[:, 0], throughput[:, 1], throughput[:, 2],
        zero, zero, zero,  # acc
        ray_o[:, 0], ray_o[:, 1], ray_o[:, 2],
        new_dir[:, 0], new_dir[:, 1], new_dir[:, 2],
        pdf,
    )

    cap_bounds = jnp.asarray(caps[:-1], jnp.int32)

    def make_sort(cap):
        def do_sort(cols):
            s = jax.lax.sort(tuple(col[:cap] for col in cols), num_keys=1)
            return tuple(f.at[:cap].set(p) for f, p in zip(cols, s))
        return do_sort

    sort_branches = [make_sort(c) for c in caps]

    def sort_phase(m_prev, cols):
        """Compact+order the live set (bounded by the previous bounce's
        slice extent m_prev * S); returns (slice count, sorted cols)."""
        tier = jnp.sum(cap_bounds < m_prev * S).astype(jnp.int32)
        cols = jax.lax.switch(tier, sort_branches, cols)
        valid = jnp.sum(cols[0] < dsc._DEAD_KEY_BIT).astype(jnp.int32)
        return (valid + S - 1) // S, cols

    def advance(base_ptr, slice_cols, with_nee, sweep_result=None):
        """One bounce step on a tuple of width-W columns (W = S for the
        slice loop, W = n for the bounce-level shading path): extension
        sweep -> env/emissive MIS accounting -> surface refetch -> NEE ->
        BSDF sample -> next sort key.  Pure per-lane math — the same
        columns produce the same values at any width, which is what keeps
        the bounce-level path bitwise identical to the slice loop.

        ``sweep_result``: optional precomputed ``(prim, bary)`` from
        :func:`sweep_slices` — the bounce-level mode sweeps in slices but
        shades once at full width."""
        (key_s, lpk_s, scr_s, t0, t1, t2, a0, a1, a2,
         o0, o1, o2, d0, d1, d2, pdf_s) = slice_cols
        act = key_s < dsc._DEAD_KEY_BIT
        delta_s = (lpk_s & 1) != 0
        o_s = jnp.stack([o0, o1, o2], axis=-1)
        d_s = jnp.stack([d0, d1, d2], axis=-1)
        thr = jnp.stack([t0, t1, t2], axis=-1)
        acc = jnp.stack([a0, a1, a2], axis=-1)

        # extension sweep (rays arrive globally signature-sorted)
        if sweep_result is None:
            prim, bary = dsc.intersect_ids(ds, o_s, d_s, act)
        else:
            prim, bary = sweep_result
            # lanes beyond the swept live slices hold stale winners
            prim = jnp.where(act, prim, NULL_PRIMITIVE)
        miss = act & (prim == NULL_PRIMITIVE)
        if ds.has_env:
            env_pdf = dsc.env_map_pdf(ds, d_s)
            w_env = jnp.where(
                delta_s, 1.0, m.power_heuristic(pdf_s, env_pdf)
            )
            acc = acc + jnp.where(
                miss[..., None],
                dsc.env_radiance(ds, d_s) * thr * w_env[..., None],
                0.0,
            )
        act = act & ~miss

        pos_s, nrm, uvi, mat_id = dsc.surface_info(ds, prim, bary)
        mat_s, nrm = dsc.get_textured_material(ds, mat_id, uvi, nrm)
        hit_light = act & (mat_s.mtype == dsc.MAT_LIGHT)
        light_vis = _light_visible_side(ds, nrm, d_s)
        # prev_pos for the area->solid-angle pdf: undo the origin inset
        # (~1e-12 residual, far below the pdf's own conditioning; the
        # dense-parity claim is exact-to-ulp on light-hit MIS lanes)
        lp_hit = dsc.area_light_hit_pdf(
            ds, mat_s.base_color, o_s - d_s * 1e-5, pos_s, nrm
        )
        w_light = jnp.where(
            delta_s, 1.0, m.power_heuristic(pdf_s, lp_hit)
        )
        acc = acc + jnp.where(
            (hit_light & light_vis)[..., None],
            mat_s.base_color * thr * w_light[..., None],
            0.0,
        )
        act = act & ~hit_light

        if not with_nee:
            # tail (last bounce's extension): only the accumulator
            # advances; no further sort reads the other columns
            return (acc[:, 0], acc[:, 1], acc[:, 2])

        wo = -d_s
        is_delta = mat_s.mtype == dsc.MAT_DIELECTRIC
        flip = (~is_delta) & (m.dot(nrm, wo) < 0.0)
        nrm = jnp.where(flip[..., None], -nrm, nrm)
        smp = rng.SamplerState(scramble=scr_s, ptr=base_ptr)
        contrib, smp = _nee_contrib(
            ds, smp, act, mat_s, nrm, wo, pos_s, thr
        )
        acc = acc + contrib
        smp, act, thr, nd, npdf, ndelta = _bsdf_advance(
            ds, smp, act, mat_s, nrm, wo, thr
        )
        no = pos_s + nd * 1e-5
        nkey = dsc._sort_key(ds, no, nd) + jnp.where(
            act, 0, dsc._DEAD_KEY_BIT
        )
        return (
            nkey,
            ((lpk_s >> 1) << 1) | ndelta.astype(jnp.int32),
            smp.scramble,
            thr[:, 0], thr[:, 1], thr[:, 2],
            acc[:, 0], acc[:, 1], acc[:, 2],
            no[:, 0], no[:, 1], no[:, 2],
            nd[:, 0], nd[:, 1], nd[:, 2],
            npdf,
        )

    def run_slices(base_ptr, n_live_slices, cols, with_nee):
        def body(st):
            j, cols = st
            off = j * S
            sl = tuple(
                jax.lax.dynamic_slice_in_dim(col, off, S) for col in cols
            )
            upd = advance(base_ptr, sl, with_nee)
            if with_nee:
                cols = tuple(
                    jax.lax.dynamic_update_slice_in_dim(c, u, off, 0)
                    for c, u in zip(cols, upd)
                )
            else:
                out = list(cols)
                for idx, u in zip((6, 7, 8), upd):
                    out[idx] = jax.lax.dynamic_update_slice_in_dim(
                        out[idx], u, off, 0
                    )
                cols = tuple(out)
            return j + 1, cols

        _, cols = jax.lax.while_loop(
            lambda st: st[0] < n_live_slices, body, (jnp.int32(0), cols)
        )
        return cols

    def sweep_slices(n_live_slices, cols, prim_buf, bx_buf, by_buf):
        """Slice loop in SWEEP-ONLY mode (``RADISH_NEE_LEVEL=bounce``):
        each slice runs just the extension sweep and records the winner;
        accounting / surface refetch / NEE / BSDF happen once per bounce
        at full width in :func:`advance` via ``sweep_result``."""
        def body(st):
            j, prim_buf, bx_buf, by_buf = st
            off = j * S
            key_s = jax.lax.dynamic_slice_in_dim(cols[0], off, S)
            o_s = jnp.stack(
                [jax.lax.dynamic_slice_in_dim(cols[9 + k], off, S)
                 for k in range(3)], axis=-1)
            d_s = jnp.stack(
                [jax.lax.dynamic_slice_in_dim(cols[12 + k], off, S)
                 for k in range(3)], axis=-1)
            act = key_s < dsc._DEAD_KEY_BIT
            prim, bary = dsc.intersect_ids(ds, o_s, d_s, act)
            # the exact barycentrics ride out of the slice loop too, for
            # bitwise parity with the in-slice path
            prim_buf = jax.lax.dynamic_update_slice_in_dim(
                prim_buf, prim, off, 0)
            bx_buf = jax.lax.dynamic_update_slice_in_dim(
                bx_buf, bary[:, 0], off, 0)
            by_buf = jax.lax.dynamic_update_slice_in_dim(
                by_buf, bary[:, 1], off, 0)
            return j + 1, prim_buf, bx_buf, by_buf

        _, prim_buf, bx_buf, by_buf = jax.lax.while_loop(
            lambda st: st[0] < n_live_slices, body,
            (jnp.int32(0), prim_buf, bx_buf, by_buf),
        )
        return prim_buf, jnp.stack([bx_buf, by_buf], axis=-1)

    nee_level = os.environ.get("RADISH_NEE_LEVEL", "slice")

    def bounce_body(_i, carry):
        ptr, m_prev = carry[0], carry[1]
        m_new, cols = sort_phase(m_prev, carry[2:])
        if nee_level == "bounce":
            prim0 = cols[0] * 0 + NULL_PRIMITIVE
            z = cols[3] * 0.0
            sweep = sweep_slices(m_new, cols, prim0, z, z)
            cols = advance(ptr, cols, True, sweep_result=sweep)
        else:
            cols = run_slices(ptr, m_new, cols, with_nee=True)
        # NEE consumes a 4D draw + the BSDF sample a 3D draw: the scalar
        # ptr advances 7/bounce in lockstep with the dense loop (the
        # parity test pins this against the dense sampler chain)
        return (ptr + 7, m_new) + cols

    # m_prev derives from (varying) key data: sort_phase returns a varying
    # slice count, so the carry slot must start varying too
    m0 = jnp.sum(key * 0) + n_slices
    carry = (sampler.ptr, m0) + cols
    carry = jax.lax.fori_loop(1, max_depth, bounce_body, carry)

    # ---- tail: the final bounce's extension sweep + accounting ----
    m_tail, cols = sort_phase(carry[1], carry[2:])
    if nee_level == "bounce":
        prim0 = cols[0] * 0 + NULL_PRIMITIVE
        z = cols[3] * 0.0
        sweep = sweep_slices(m_tail, cols, prim0, z, z)
        acc3 = advance(carry[0], cols, False, sweep_result=sweep)
        out = list(cols)
        out[6], out[7], out[8] = acc3
        cols = tuple(out)
    else:
        cols = run_slices(carry[0], m_tail, cols, with_nee=False)

    # ---- deliver the compact accumulators to pixel order: the lane
    # column is a permutation of 0..n-1, so one 4-col sort is the inverse
    u = jax.lax.sort((cols[1] >> 1, cols[6], cols[7], cols[8]), num_keys=1)
    indirect = indirect + jnp.stack(u[1:4], axis=-1)
    return direct, indirect


def path_trace_direct(
    ds: dsc.DeviceScene, cam: cam_mod.Camera, looper, pixel_idx=None
):
    """One-bounce direct lighting — ``PTDirectKernel`` (pathtrace.cu:293-345).
    Returns direct [N, 3]."""
    idx, _, _ = _pixel_grid(cam, pixel_idx)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    it = dsc.intersect(ds, ray_o, ray_d)
    hit = it.prim_id != NULL_PRIMITIVE

    direct = jnp.where(hit[..., None], 0.0, dsc.env_radiance(ds, ray_d))

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm, ray_d)
    direct += jnp.where((is_light & light_vis)[..., None], mat.base_color, 0.0)

    wo = -ray_d
    is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
    norm = jnp.where(flip[..., None], -norm, norm)

    shade = hit & ~is_light & ~is_delta_bsdf
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, light_pdf = dsc.sample_direct_light(ds, it.pos, r4, mask=shade,
                                                shade_normal=norm)
    ok = shade & (light_pdf > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    contrib = f * li * (m.sat_dot(norm, wi) / jnp.maximum(light_pdf, 1e-12))[..., None]
    direct += jnp.where(ok[..., None], contrib, 0.0)
    return direct


def scrub_and_compress(img):
    """NaN/Inf guard + HDR->LDR range compression before accumulation
    (pathtrace.cu:279-286)."""
    bad = jnp.any(~jnp.isfinite(img), axis=-1, keepdims=True)
    img = jnp.where(bad, 0.0, img)
    return m.hdr_to_ldr(img)


def accumulate(prev, new, iteration):
    """Running mean: (prev * iter + new) / (iter + 1) (pathtrace.cu:287-290)."""
    it = jnp.asarray(iteration, jnp.float32)
    return (prev * it + new) / (it + 1.0)
