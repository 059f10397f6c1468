"""Denoisers: edge-avoiding à-trous wavelet (EAW) and SVGF.

Wavefront re-design of ``/root/reference/src/denoiser.cu``:
* ``waveletFilter`` (EAW, :17-85) and the variance-guided SVGF variant (:92-173)
* ``temporalAccumulate`` (:208-262), ``estimateVariance`` (:264-299),
  ``filterVariance`` (:301-328)
* level drivers ``LeveledEAWFilter::filter`` (:419-434) and
  ``SpatioTemporalFilter::filter`` (:525-558)

Every stencil is expressed as 25 statically shifted views (shift + boundary
mask), which XLA fuses into a single loop.  Layout is PLANAR [3, H, W]
(channels leading), so no size-3 channel axis ends up minor-most.  The
public API keeps flat [N, 3] arrays; conversion is two cheap transposes.
"""

from __future__ import annotations

import numpy as np
from ..utils import struct

import jax.numpy as jnp

from ..scene import camera as cam_mod
from ..utils import math as m
from .gbuffer import (NULL_PRIMITIVE, GBufferFrame, GBufferOut,
                      camera_get_position, decoded_normal)

GAUSSIAN_3X3 = np.array(
    [[0.075, 0.124, 0.075], [0.124, 0.204, 0.124], [0.075, 0.124, 0.075]],
    dtype=np.float32,
)

GAUSSIAN_5X5 = np.array(
    [
        [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
        [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
        [0.0219, 0.0983, 0.1621, 0.0983, 0.0219],
        [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
        [0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
    ],
    dtype=np.float32,
)


def _planar(flat, h: int, w: int):
    """[N, C] -> [C, H, W] (or [N] -> [H, W])."""
    if flat.ndim == 1:
        return flat.reshape(h, w)
    return flat.T.reshape(flat.shape[1], h, w)


def _flat(img):
    """[C, H, W] -> [N, C] (or [H, W] -> [N])."""
    if img.ndim == 2:
        return img.reshape(-1)
    return img.reshape(img.shape[0], -1).T


def _shift(img, dy: int, dx: int):
    """out[..., y, x] = img[..., y + dy, x + dx]; wrapped values must be
    masked with :func:`_shift_mask`.  Shifts the LAST TWO axes, so it works
    for [H, W] planes and [C, H, W] planar stacks alike."""
    return jnp.roll(img, (-dy, -dx), axis=(-2, -1))


def _shift_mask(h: int, w: int, dy: int, dx: int):
    yy = jnp.arange(h)[:, None] + dy
    xx = jnp.arange(w)[None, :] + dx
    return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)


def _lum(color):
    """Luminance of a planar [3, H, W] stack -> [H, W]."""
    return 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]


# ---------------------------------------------------------------------------
# EAW à-trous wavelet (denoiser.cu:17-85)
# ---------------------------------------------------------------------------


def eaw_level(
    color,  # [3, H, W]
    normal,  # [3, H, W]
    prim_id,  # [H, W] int32
    pos,  # [3, H, W] world positions
    step: int,
    sig_depth: float,
    sig_normal: float,
    sig_luminance: float,
):
    h, w = color.shape[-2:]
    acc = jnp.zeros_like(color)
    wsum = jnp.zeros((h, w), jnp.float32)
    for i in range(-2, 3):
        for j in range(-2, 3):
            dy, dx = i * step, j * step
            valid = _shift_mask(h, w, dy, dx)
            cq = _shift(color, dy, dx)
            nq = _shift(normal, dy, dx)
            pq = _shift(pos, dy, dx)
            iq = _shift(prim_id, dy, dx)
            valid = valid & (iq == prim_id)

            dc2 = jnp.sum((color - cq) ** 2, axis=0)
            dn2 = jnp.sum((normal - nq) ** 2, axis=0)
            dp2 = jnp.sum((pos - pq) ** 2, axis=0)
            # one exp for all three edge-stopping terms: each distance is
            # >= 0 so every min(1, exp(-x)) was a no-op, and
            # exp(a)exp(b)exp(c) == exp(a+b+c) — ~2 fewer transcendentals
            # per tap at identical math
            wt = jnp.exp(
                -(dc2 / sig_luminance + dn2 / sig_normal + dp2 / sig_depth)
            ) * GAUSSIAN_5X5[i + 2, j + 2]
            wt = jnp.where(valid, wt, 0.0)
            acc = acc + cq * wt[None]
            wsum = wsum + wt
    out = jnp.where(wsum[None] > 0.0, acc / jnp.maximum(wsum, 1e-12)[None], color)
    # background pixels pass through (denoiser.cu:31-34)
    return jnp.where(prim_id[None] <= NULL_PRIMITIVE, color, out)


def leveled_eaw_filter(
    color_flat,
    frame: GBufferFrame,
    cam: cam_mod.Camera,
    levels: int = 5,
    sig_depth: float = 64.0,
    sig_normal: float = 0.2,
    sig_luminance: float = 1.0,
):
    """5-level ping-pong EAW chain — LeveledEAWFilter (denoiser.cu:411-434,
    sigmas from :413)."""
    h, w = cam.height, cam.width
    idx = jnp.arange(h * w, dtype=jnp.int32)
    pos = _planar(camera_get_position(cam, idx % w, idx // w, frame.depth), h, w)
    color = _planar(color_flat, h, w)
    normal = _planar(decoded_normal(frame), h, w)
    prim = frame.prim_id.reshape(h, w)
    for level in range(levels):
        color = eaw_level(
            color, normal, prim, pos, 1 << level, sig_depth, sig_normal, sig_luminance
        )
    return _flat(color)


def gaussian_filter(color_flat, width: int, height: int):
    """Plain 5x5 Gaussian blur (the reference GUI's ``Denoiser::Gaussian``
    option, common.h:38)."""
    color = _planar(color_flat, height, width)
    acc = jnp.zeros_like(color)
    wsum = jnp.zeros((height, width), jnp.float32)
    for i in range(-2, 3):
        for j in range(-2, 3):
            valid = _shift_mask(height, width, i, j)
            cq = _shift(color, i, j)
            wt = jnp.where(valid, GAUSSIAN_5X5[i + 2, j + 2], 0.0)
            acc += cq * wt[None]
            wsum += wt
    return _flat(acc / wsum[None])


# ---------------------------------------------------------------------------
# SVGF (denoiser.cu:92-173, 208-328, 436-558)
# ---------------------------------------------------------------------------


@struct.dataclass
class SVGFState:
    """Temporal history — accumColor/accumMoment double buffer, functional."""

    accum_color: jnp.ndarray  # f32 [N, 3]
    accum_moment: jnp.ndarray  # f32 [N, 3] (mean, mean^2, history length)


def empty_svgf_state(n: int) -> SVGFState:
    return SVGFState(
        accum_color=jnp.zeros((n, 3), jnp.float32),
        accum_moment=jnp.zeros((n, 3), jnp.float32),
    )


def temporal_accumulate(
    color_in,
    state: SVGFState,
    gbuf: GBufferOut,
    last_frame: GBufferFrame,
    first_time: bool,
):
    """Exponential history blend with disocclusion reset, alpha = 0.2
    (temporalAccumulate, denoiser.cu:208-262)."""
    alpha = 0.2
    cur = gbuf.frame
    last_idx = jnp.maximum(gbuf.motion, 0)

    # one packed [N, 10] row per motion gather (gather cost is per row)
    packed = jnp.concatenate(
        [
            state.accum_color,
            state.accum_moment,
            decoded_normal(last_frame),
            last_frame.prim_id.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )[last_idx]
    last_color = packed[:, 0:3]
    last_moment = packed[:, 3:6]

    diff = jnp.broadcast_to(jnp.asarray(first_time, bool), color_in.shape[:1])
    diff = diff | (gbuf.motion < 0)
    diff |= cur.prim_id <= NULL_PRIMITIVE
    diff |= packed[:, 9].astype(jnp.int32) != cur.prim_id
    diff |= m.abs_dot(decoded_normal(cur), packed[:, 6:9]) < 0.1

    lum = m.luminance(color_in)

    blend_color = last_color + (color_in - last_color) * alpha
    blend_m1 = last_moment[..., 0] * (1 - alpha) + lum * alpha
    blend_m2 = last_moment[..., 1] * (1 - alpha) + lum * lum * alpha
    hist = last_moment[..., 2] + 1.0

    color_accum = jnp.where(diff[..., None], color_in, blend_color)
    moment_accum = jnp.where(
        diff[..., None],
        jnp.stack([lum, lum * lum, jnp.zeros_like(lum)], axis=-1),
        jnp.stack([blend_m1, blend_m2, hist], axis=-1),
    )
    return color_accum, moment_accum


def estimate_variance(moment_flat, width: int, height: int):
    """Temporal variance when history > 3.5 frames, else 3x3 spatial moments
    (estimateVariance, denoiser.cu:264-299)."""
    moment = _planar(moment_flat, height, width)  # [3, H, W]
    temporal_var = moment[1] - moment[0] ** 2

    msum = jnp.zeros((2, height, width), jnp.float32)
    count = jnp.zeros((height, width), jnp.float32)
    for i in range(-1, 2):
        for j in range(-1, 2):
            valid = _shift_mask(height, width, i, j)
            mq = _shift(moment[:2], i, j)
            msum += jnp.where(valid[None], mq, 0.0)
            count += valid.astype(jnp.float32)
    msum = msum / count[None]
    spatial_var = msum[1] - msum[0] ** 2

    var = jnp.where(moment[2] > 3.5, temporal_var, spatial_var)
    return var.reshape(-1)


def filter_variance(var_flat, width: int, height: int):
    """3x3 Gaussian variance prefilter (filterVariance, denoiser.cu:301-328)."""
    var = var_flat.reshape(height, width)
    acc = jnp.zeros_like(var)
    wsum = jnp.zeros_like(var)
    for i in range(-1, 2):
        for j in range(-1, 2):
            valid = _shift_mask(height, width, i, j)
            vq = _shift(var, i, j)
            wt = jnp.where(valid, GAUSSIAN_3X3[i + 1, j + 1], 0.0)
            acc += vq * wt
            wsum += wt
    return (acc / jnp.maximum(wsum, 1e-12)).reshape(-1)


def svgf_wavelet_level(
    color,  # [3, H, W]
    variance,  # [H, W]
    var_filtered,  # [H, W]
    normal,  # [3, H, W]
    prim_id,  # [H, W]
    pos,  # [3, H, W]
    step: int,
    sig_depth: float,
    sig_normal: float,
    sig_luminance: float,
):
    """Variance-guided à-trous level, Falcor-style weights
    (waveletFilter SVGF overload, denoiser.cu:92-173)."""
    h, w = color.shape[-2:]
    lum_p = _lum(color)
    denom = sig_luminance * jnp.sqrt(jnp.maximum(var_filtered, 0.0)) + 1e-4
    c_acc = jnp.zeros_like(color)
    v_acc = jnp.zeros_like(variance)
    wsum = jnp.zeros((h, w), jnp.float32)
    w2sum = jnp.zeros((h, w), jnp.float32)
    for i in range(-2, 3):
        for j in range(-2, 3):
            dy, dx = i * step, j * step
            valid = _shift_mask(h, w, dy, dx)
            cq = _shift(color, dy, dx)
            vq = _shift(variance, dy, dx)
            nq = _shift(normal, dy, dx)
            pq = _shift(pos, dy, dx)

            dp2 = jnp.sum((pos - pq) ** 2, axis=0)
            w_p = jnp.exp(-dp2 / (sig_depth + 1e-4))
            w_n = jnp.power(
                jnp.maximum(jnp.sum(normal * nq, axis=0), 0.0), sig_normal
            ) + 1e-4
            w_c = jnp.exp(-jnp.abs(lum_p - _lum(cq)) / denom) + 1e-4

            wt = jnp.where(valid, w_c * w_n * w_p * GAUSSIAN_5X5[i + 2, j + 2], 0.0)
            c_acc += cq * wt[None]
            v_acc += vq * wt * wt
            wsum += wt
            w2sum += wt * wt
    eps = 1.1920929e-07
    out_c = jnp.where(
        wsum[None] >= eps, c_acc / jnp.maximum(wsum, 1e-12)[None], color
    )
    out_v = jnp.where(w2sum >= eps, v_acc / jnp.maximum(w2sum, 1e-12), variance)
    keep = prim_id <= NULL_PRIMITIVE
    return jnp.where(keep[None], color, out_c), jnp.where(keep, variance, out_v)


def svgf_filter(
    color_in,
    state: SVGFState,
    gbuf: GBufferOut,
    last_frame: GBufferFrame,
    cam: cam_mod.Camera,
    first_time: bool,
    levels: int = 5,
    sig_depth: float = 4.0,
    sig_normal: float = 128.0,
    sig_luminance: float = 1.0,
):
    """Full SVGF: temporal accumulate -> variance -> 5 guided wavelet levels
    (SpatioTemporalFilter::filter, denoiser.cu:525-558; sigmas from :443).

    Returns (filtered color [N, 3], new SVGFState).  Like the reference, the
    *level-0* filtered color becomes next frame's history (the swap at
    denoiser.cu:533).
    """
    h, w = cam.height, cam.width
    color_accum, moment_accum = temporal_accumulate(
        color_in, state, gbuf, last_frame, first_time
    )
    variance = estimate_variance(moment_accum, w, h)

    frame = gbuf.frame
    idx = jnp.arange(h * w, dtype=jnp.int32)
    pos = _planar(camera_get_position(cam, idx % w, idx // w, frame.depth), h, w)
    normal = _planar(decoded_normal(frame), h, w)
    prim = frame.prim_id.reshape(h, w)

    color = _planar(color_accum, h, w)
    var = variance.reshape(h, w)
    history = None
    for level in range(levels):
        var_f = filter_variance(var.reshape(-1), w, h).reshape(h, w)
        color, var = svgf_wavelet_level(
            color, var, var_f, normal, prim, pos, 1 << level,
            sig_depth, sig_normal, sig_luminance,
        )
        if level == 0:
            history = color  # denoiser.cu:533 swap
    new_state = SVGFState(accum_color=_flat(history), accum_moment=moment_accum)
    return _flat(color), new_state


def svgf_filter_pair(
    color_d,
    color_i,
    state_d: SVGFState,
    state_i: SVGFState,
    gbuf: GBufferOut,
    last_frame: GBufferFrame,
    cam: cam_mod.Camera,
    first_time: bool,
    levels: int = 5,
    sig_depth: float = 4.0,
    sig_normal: float = 128.0,
    sig_luminance: float = 1.0,
):
    """Two SVGF instances (direct + indirect, DENOISER_SPLIT_DIRECT_INDIRECT)
    fused into one pass — numerically identical to two :func:`svgf_filter`
    calls, but the expensive shared work is computed ONCE:

    * one packed [N, 16] temporal motion gather carries BOTH histories
      (gather cost is per row, utils/gather.py);
    * disocclusion flags depend only on geometry — shared;
    * per-tap depth (exp) and normal (pow) wavelet weights are
      image-independent (denoiser.cu:123-141) — shared across the pair,
      only the luminance weight is per-image.

    Returns (out_d, out_i, new_state_d, new_state_i).
    """
    h, w = cam.height, cam.width
    alpha = 0.2
    cur = gbuf.frame
    last_idx = jnp.maximum(gbuf.motion, 0)
    packed = jnp.concatenate(
        [
            state_d.accum_color, state_d.accum_moment,
            state_i.accum_color, state_i.accum_moment,
            decoded_normal(last_frame),
            last_frame.prim_id.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )[last_idx]

    diff = jnp.broadcast_to(jnp.asarray(first_time, bool), color_d.shape[:1])
    diff = diff | (gbuf.motion < 0)
    diff |= cur.prim_id <= NULL_PRIMITIVE
    diff |= packed[:, 15].astype(jnp.int32) != cur.prim_id
    diff |= m.abs_dot(decoded_normal(cur), packed[:, 12:15]) < 0.1

    def blend(color_in, last_color, last_moment):
        lum = m.luminance(color_in)
        blend_color = last_color + (color_in - last_color) * alpha
        blend_m1 = last_moment[..., 0] * (1 - alpha) + lum * alpha
        blend_m2 = last_moment[..., 1] * (1 - alpha) + lum * lum * alpha
        hist = last_moment[..., 2] + 1.0
        color_accum = jnp.where(diff[..., None], color_in, blend_color)
        moment_accum = jnp.where(
            diff[..., None],
            jnp.stack([lum, lum * lum, jnp.zeros_like(lum)], axis=-1),
            jnp.stack([blend_m1, blend_m2, hist], axis=-1),
        )
        return color_accum, moment_accum

    cd_acc, md_acc = blend(color_d, packed[:, 0:3], packed[:, 3:6])
    ci_acc, mi_acc = blend(color_i, packed[:, 6:9], packed[:, 9:12])

    frame = gbuf.frame
    idx = jnp.arange(h * w, dtype=jnp.int32)
    pos = _planar(camera_get_position(cam, idx % w, idx // w, frame.depth), h, w)
    normal = _planar(decoded_normal(frame), h, w)
    prim = frame.prim_id.reshape(h, w)
    keep = prim <= NULL_PRIMITIVE

    chans = []
    for c_acc, m_acc in ((cd_acc, md_acc), (ci_acc, mi_acc)):
        chans.append({
            "color": _planar(c_acc, h, w),
            "var": estimate_variance(m_acc, w, h).reshape(h, w),
            "moment": m_acc,
            "history": None,
        })

    eps = 1.1920929e-07
    for level in range(levels):
        step = 1 << level
        for ch in chans:
            ch["var_f"] = filter_variance(
                ch["var"].reshape(-1), w, h
            ).reshape(h, w)
            ch["lum_p"] = _lum(ch["color"])
            ch["denom"] = (
                sig_luminance * jnp.sqrt(jnp.maximum(ch["var_f"], 0.0)) + 1e-4
            )
            ch["c_acc"] = jnp.zeros_like(ch["color"])
            ch["v_acc"] = jnp.zeros_like(ch["var"])
            ch["wsum"] = jnp.zeros((h, w), jnp.float32)
            ch["w2sum"] = jnp.zeros((h, w), jnp.float32)
        for i in range(-2, 3):
            for j in range(-2, 3):
                dy, dx = i * step, j * step
                valid = _shift_mask(h, w, dy, dx)
                nq = _shift(normal, dy, dx)
                pq = _shift(pos, dy, dx)
                # geometry weights: shared by both filters
                dp2 = jnp.sum((pos - pq) ** 2, axis=0)
                w_p = jnp.exp(-dp2 / (sig_depth + 1e-4))
                w_n = jnp.power(
                    jnp.maximum(jnp.sum(normal * nq, axis=0), 0.0), sig_normal
                ) + 1e-4
                w_geo = jnp.where(
                    valid, w_n * w_p * GAUSSIAN_5X5[i + 2, j + 2], 0.0
                )
                for ch in chans:
                    cq = _shift(ch["color"], dy, dx)
                    vq = _shift(ch["var"], dy, dx)
                    w_c = jnp.exp(
                        -jnp.abs(ch["lum_p"] - _lum(cq)) / ch["denom"]
                    ) + 1e-4
                    wt = w_c * w_geo
                    ch["c_acc"] += cq * wt[None]
                    ch["v_acc"] += vq * wt * wt
                    ch["wsum"] += wt
                    ch["w2sum"] += wt * wt
        for ch in chans:
            out_c = jnp.where(
                ch["wsum"][None] >= eps,
                ch["c_acc"] / jnp.maximum(ch["wsum"], 1e-12)[None],
                ch["color"],
            )
            out_v = jnp.where(
                ch["w2sum"] >= eps,
                ch["v_acc"] / jnp.maximum(ch["w2sum"], 1e-12),
                ch["var"],
            )
            ch["color"] = jnp.where(keep[None], ch["color"], out_c)
            ch["var"] = jnp.where(keep, ch["var"], out_v)
            if level == 0:
                ch["history"] = ch["color"]  # denoiser.cu:533 swap

    out = []
    for ch in chans:
        out.append(_flat(ch["color"]))
        out.append(SVGFState(accum_color=_flat(ch["history"]),
                             accum_moment=ch["moment"]))
    return out[0], out[2], out[1], out[3]
