"""ReSTIR direct illumination: RIS + temporal + spatial reservoir reuse.

Wavefront re-design of ``ReSTIRDirectKernel`` + ``Reservoir<T>``
(``/root/reference/src/restir.cu:97-233``, ``restir.h:10-101``).  Reservoir
state is SoA image-shaped arrays (no structs); each stage — candidate RIS,
visibility, temporal merge, spatial merge, shading — is its own pure function
over the whole wavefront.  The spatial pass reads a *completed* post-temporal
reservoir image, which structurally fixes the reference's block-level
``__syncthreads`` race (restir.cu:177-181: only one 8x8 block is synced, so
cross-block neighbors could be read before they were written).

Weighted-reservoir-sampling update uses the standard condition
``rand * totalWeight < newWeight``; the reference's ``Reservoir::update``
(restir.h:21) tests the *truthiness* of a float instead — a bug SURVEY.md
flags — while its ``merge`` (restir.h:51-58) is correct.  We use the correct
rule everywhere.
"""

from __future__ import annotations

from ..utils import struct

import jax
import jax.numpy as jnp

from ..bsdf import materials as bsdf
from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..sampling import rng
from ..utils import math as m
from . import gbuffer as gb
from .gbuffer import NULL_PRIMITIVE, GBufferFrame, GBufferOut


@struct.dataclass
class DirectReservoir:
    """Per-pixel light-sample reservoir — SoA of ``Reservoir<LightLiSample>``
    (restir.h:90-101)."""

    li: jnp.ndarray  # f32 [N, 3] candidate radiance
    wi: jnp.ndarray  # f32 [N, 3] direction to the light
    dist: jnp.ndarray  # f32 [N] distance to the light sample
    num: jnp.ndarray  # f32 [N] effective sample count M
    weight: jnp.ndarray  # f32 [N] sum of RIS weights


def empty_reservoir(n: int) -> DirectReservoir:
    z = jnp.zeros((n,), jnp.float32)
    z3 = jnp.zeros((n, 3), jnp.float32)
    return DirectReservoir(li=z3, wi=z3, dist=z, num=z, weight=z)


def _update(res: DirectReservoir, li, wi, dist, w, rand) -> DirectReservoir:
    """WRS update (correct rule; cf. restir.h:17-24)."""
    weight = res.weight + w
    num = res.num + 1.0
    take = rand * weight < w
    return DirectReservoir(
        li=jnp.where(take[..., None], li, res.li),
        wi=jnp.where(take[..., None], wi, res.wi),
        dist=jnp.where(take, dist, res.dist),
        num=num,
        weight=weight,
    )


def _merge(res: DirectReservoir, rhs: DirectReservoir, rand, enable) -> DirectReservoir:
    """Reservoir merge (restir.h:51-58), masked by ``enable``."""
    weight = res.weight + rhs.weight
    num = res.num + rhs.num
    take = enable & (rand * weight < rhs.weight)
    return DirectReservoir(
        li=jnp.where(take[..., None], rhs.li, res.li),
        wi=jnp.where(take[..., None], rhs.wi, res.wi),
        dist=jnp.where(take, rhs.dist, res.dist),
        num=jnp.where(enable, num, res.num),
        weight=jnp.where(enable, weight, res.weight),
    )


def _pre_clamped_merge(res, rhs, rand, enable, clamp: int):
    """preClampedMerge<M>: clamp rhs history to (M-1)x ours before merging
    (restir.h:70-78)."""
    scale = jnp.where(
        (rhs.num > (clamp - 1) * res.num) & (res.num > 0) & (rhs.num > 0),
        (clamp - 1) * res.num / jnp.maximum(rhs.num, 1e-12),
        1.0,
    )
    rhs = rhs.replace(weight=rhs.weight * scale, num=rhs.num * scale)
    return _merge(res, rhs, rand, enable)


def _invalid(res: DirectReservoir):
    return ~jnp.isfinite(res.weight) | (res.weight < 0.0)


def _check_validity(res: DirectReservoir) -> DirectReservoir:
    bad = _invalid(res)
    return res.replace(
        weight=jnp.where(bad, 0.0, res.weight), num=jnp.where(bad, 0.0, res.num)
    )


def _p_hat(res: DirectReservoir, mat, norm, wo, types=None):
    """Target function p^ = Li * f * cos (restir.h:31-35)."""
    f = bsdf.bsdf_eval(mat, norm, wo, res.wi, types=types)
    return res.li * f * m.sat_dot(norm, res.wi)[..., None]


def _big_w(res: DirectReservoir, p_hat_vec):
    """Unbiased contribution weight W (restir.h:37-40); toScalar = length."""
    scalar = m.length(p_hat_vec)
    return res.weight / jnp.maximum(scalar * res.num, 1e-12)


def _pack(res: DirectReservoir, *extra) -> jnp.ndarray:
    """Pack reservoir SoA (+ optional extra columns) into one [N, 9+] array
    so a neighbor fetch is ONE divergent gather instead of 5-8 (see
    utils/gather.py)."""
    cols = [res.li, res.wi, res.dist[:, None], res.num[:, None],
            res.weight[:, None]]
    cols += [e if e.ndim == 2 else e[:, None] for e in extra]
    return jnp.concatenate(cols, axis=1)


def _unpack(row) -> DirectReservoir:
    return DirectReservoir(
        li=row[..., 0:3],
        wi=row[..., 3:6],
        dist=row[..., 6],
        num=row[..., 7],
        weight=row[..., 8],
    )


def _mask_empty(res: DirectReservoir, valid) -> DirectReservoir:
    """Replace invalid lanes with an empty reservoir (the T() default the
    reference returns from neighbor finders)."""
    return DirectReservoir(
        li=jnp.where(valid[..., None], res.li, 0.0),
        wi=jnp.where(valid[..., None], res.wi, 0.0),
        dist=jnp.where(valid, res.dist, 0.0),
        num=jnp.where(valid, res.num, 0.0),
        weight=jnp.where(valid, res.weight, 0.0),
    )


def find_temporal_neighbor(
    reservoir: DirectReservoir,
    motion,
    cur: GBufferFrame,
    last: GBufferFrame,
    pixel_offset=None,
) -> DirectReservoir:
    """Gather last-frame reservoirs via motion indices with geometric
    validation (findTemporalNeighbor, restir.cu:20-40) — one packed gather.

    ``pixel_offset`` (shard_map callers): the GLOBAL flat index of this
    shard's first pixel.  ``motion`` is always a global index; gathers that
    land outside the local shard are invalidated — a tile seam behaves like
    an image border (documented seam semantics, parallel/sharding.py)."""
    n_local = reservoir.weight.shape[0]
    local = motion if pixel_offset is None else motion - pixel_offset
    last_idx = jnp.clip(local, 0, n_local - 1)
    packed = _pack(
        reservoir, gb.decoded_normal(last), last.prim_id.astype(jnp.float32)
    )
    row = packed[last_idx]
    ok = (motion >= 0) & (local >= 0) & (local < n_local)
    ok &= cur.prim_id > NULL_PRIMITIVE
    ok &= row[..., 12].astype(jnp.int32) == cur.prim_id
    ok &= m.abs_dot(gb.decoded_normal(cur), row[..., 9:12]) >= 0.1
    return _mask_empty(_unpack(row), ok)


def _spatial_neighbor(
    packed,  # [N, 15] reservoir + gbuffer + global-idx columns (merge_spatial)
    x,
    y,
    width: int,
    height: int,
    cur: GBufferFrame,
    rand2,
    pixel_offset=0,
):
    """One disk-sampled spatial neighbor with geometry tests
    (findSpatialNeighborDisk, restir.cu:43-80) — ONE gather per neighbor.
    Coordinates are GLOBAL; the gather is into the LOCAL shard (offset by
    ``pixel_offset``), with out-of-shard candidates invalidated."""
    radius = 5.0
    p = m.concentric_sample_disk(rand2[..., 0], rand2[..., 1]) * radius
    px = (x.astype(jnp.float32) + 0.5 + p[..., 0]).astype(jnp.int32)
    py = (y.astype(jnp.float32) + 0.5 + p[..., 1]).astype(jnp.int32)
    p_idx = py * width + px
    local = p_idx - pixel_offset
    n_local = packed.shape[0]
    row = packed[jnp.clip(local, 0, n_local - 1)]

    ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    ok &= (local >= 0) & (local < n_local)
    ok &= ~((px == x) & (py == y))
    # exact fetched-row identity: rejects clamped / cross-seam rows
    ok &= row[..., 14].astype(jnp.int32) == p_idx
    ok &= row[..., 13].astype(jnp.int32) == cur.prim_id
    ok &= m.dot(row[..., 9:12], gb.decoded_normal(cur)) >= 0.1
    ok &= jnp.abs(row[..., 12] - cur.depth) <= cur.depth * 0.1
    return _mask_empty(_unpack(row), ok)


def merge_spatial(
    temp: DirectReservoir,
    cur: GBufferFrame,
    width: int,
    height: int,
    sampler,
    table,
    num_neighbors: int = 5,
    looper=None,
    pixel_idx=None,
):
    """Merge 5 disk neighbors from the COMPLETED post-temporal reservoir image
    (mergeSpatialNeighborDirect, restir.cu:82-95) — a separate pass, so every
    neighbor value is from this frame, fixing the reference's sync bug.

    Deviation from the reference's per-pixel random disk: when ``looper``
    is given, each neighbor's disk offset is SHARED by all pixels and rotated
    per (frame, neighbor) by a hash — the fetch then lowers to a 2D roll of
    the packed image instead of a divergent [N, 15] gather.  Temporal
    rotation restores the offset coverage per-pixel randomness provided.

    ``pixel_idx`` (shard_map callers): GLOBAL flat indices of this row-shard's
    pixels (contiguous ascending).  Neighbor candidates outside the shard are
    rejected by the packed global-idx column — a tile seam behaves like an
    image border."""
    n = temp.weight.shape[0]
    if pixel_idx is None:
        idx = jnp.arange(n, dtype=jnp.int32)
        offset = 0
    else:
        idx = pixel_idx
        offset = idx[0]
    x = idx % width
    y = idx // width
    packed = _pack(
        temp, gb.decoded_normal(cur), cur.depth,
        cur.prim_id.astype(jnp.float32), idx.astype(jnp.float32),
    )
    out = empty_reservoir(n)
    # the rolled fetch needs the local pixel block to reshape into whole
    # image rows; a shard that isn't a multiple of the width (possible under
    # --mesh when height % n_tile != 0) uses the gather path instead
    if looper is not None and n % width != 0:
        looper = None
    if looper is None:
        for _ in range(num_neighbors):
            r2, sampler = rng.sample_2d(table, sampler)
            nb = _spatial_neighbor(
                packed, x, y, width, height, cur, r2, pixel_offset=offset
            )
            r1, sampler = rng.sample_1d(table, sampler)
            out = _merge(out, nb, r1, ~_invalid(nb) & (nb.num > 0))
        return out, sampler

    img = packed.reshape(-1, width, packed.shape[1])
    for k in range(num_neighbors):
        h1 = m.utilhash(jnp.uint32(looper) * 31 + jnp.uint32(2 * k + 1))
        h2 = m.utilhash(h1 ^ jnp.uint32(0x9E3779B9))
        u1 = h1.astype(jnp.float32) * jnp.float32(2.0**-32)
        u2 = h2.astype(jnp.float32) * jnp.float32(2.0**-32)
        p = m.concentric_sample_disk(u1, u2) * 5.0
        dx = jnp.round(p[..., 0]).astype(jnp.int32)
        dy = jnp.round(p[..., 1]).astype(jnp.int32)
        row = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1)).reshape(n, -1)
        px = x + dx
        py = y + dy
        ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        ok &= ~((dx == 0) & (dy == 0))
        # exact fetched-row identity: a roll that wrapped around the local
        # shard (or the image) never validates
        ok &= row[..., 14].astype(jnp.int32) == py * width + px
        ok &= row[..., 13].astype(jnp.int32) == cur.prim_id
        ok &= m.dot(row[..., 9:12], gb.decoded_normal(cur)) >= 0.1
        ok &= jnp.abs(row[..., 12] - cur.depth) <= cur.depth * 0.1
        nb = _mask_empty(_unpack(row), ok)
        r1, sampler = rng.sample_1d(table, sampler)
        out = _merge(out, nb, r1, ~_invalid(nb) & (nb.num > 0))
    return out, sampler


def restir_direct(
    ds: dsc.DeviceScene,
    cam: cam_mod.Camera,
    looper,
    gbuf: GBufferOut,
    last_frame: GBufferFrame,
    last_reservoir: DirectReservoir,
    first_frame,  # traced bool scalar
    reuse: int,
    reservoir_size: int = 32,
    temporal_clamp: int = 20,
    pixel_idx=None,
):
    """Full ReSTIR DI pass (ReSTIRDirectKernel, restir.cu:97-203).

    Returns (direct [N, 3] demodulated * gbuffer-albedo, reservoir_out) where
    ``reservoir_out`` is the post-temporal (pre-spatial) reservoir fed to the
    next frame, like the reference's ``tempReservoir`` (restir.cu:173,186-187).

    ``pixel_idx``: optional GLOBAL flat pixel indices (contiguous ascending)
    when running on a row-shard inside shard_map — temporal/spatial reuse
    then treats shard seams like image borders (parallel/sharding.py).
    """
    from ..config import ReservoirReuse
    from .pathtrace import _gen_primary

    if pixel_idx is None:
        n = cam.width * cam.height
        idx = jnp.arange(n, dtype=jnp.int32)
        pixel_offset = None
    else:
        idx = pixel_idx
        n = idx.shape[0]
        pixel_offset = idx[0]
    sampler = rng.make_sampler(looper, idx)
    table = ds.sobol

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, pixel_idx=pixel_idx)
    it = dsc.intersect(ds, ray_o, ray_d)
    hit = it.prim_id != NULL_PRIMITIVE

    direct = jnp.where(hit[..., None], 0.0, dsc.env_radiance(ds, ray_d))

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    # demodulate: shade with white albedo; gbuffer albedo re-modulates at the
    # end (restir.cu:125,200)
    mat = mat.replace(base_color=jnp.ones_like(mat.base_color))
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    direct += jnp.where(is_light[..., None], mat.base_color, 0.0)

    wo = -ray_d
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta) & (m.dot(norm, wo) < 0.0)
    norm = jnp.where(flip[..., None], -norm, norm)

    shade = hit & ~is_light

    # ---- candidate RIS over `reservoir_size` no-visibility light samples
    # (a fori_loop keeps compile time independent of the reservoir size) ----
    def _candidate(_i, carry):
        sampler, res = carry
        r4, sampler = rng.sample_4d(table, sampler)
        li, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, it.pos, r4)
        f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
        p_hat = li * f * m.sat_dot(norm, wi)[..., None]
        w = m.length(p_hat) / jnp.maximum(pdf, 1e-12)
        w = jnp.where(jnp.isfinite(w) & (pdf > 0.0), w, 0.0)
        r1, sampler = rng.sample_1d(table, sampler)
        return sampler, _update(res, li, wi, dist, w, r1)

    # derive the empty reservoir from ray state so it inherits shard_map
    # varying axes (a replicated zeros constant fails the fori carry check)
    z3 = ray_d * 0.0
    res0 = DirectReservoir(
        li=z3, wi=z3, dist=z3[..., 0], num=z3[..., 0], weight=z3[..., 0]
    )
    sampler, res = jax.lax.fori_loop(
        0, reservoir_size, _candidate, (sampler, res0)
    )

    # ---- single visibility test on the winner (restir.cu:158-163); only
    # lanes that can actually shade sweep shadow rays — the rest get
    # degenerate segments and their (all-dead) blocks are scalar-skipped ----
    vis = shade & (res.weight > 0.0)
    target = it.pos + res.wi * res.dist[..., None]
    occluded = dsc.test_occlusion_sorted(ds, it.pos, target, mask=vis)
    # NOTE: this zeroes NON-SHADE lanes (misses, direct light hits) too, not
    # just occluded winners as the reference does (restir.cu:160-163) — their
    # candidate weights were never visibility-tested, and zero is the safe
    # value to feed temporal history (the merge validates prim match anyway).
    res = res.replace(weight=jnp.where(vis & ~occluded, res.weight, 0.0))

    # ---- temporal reuse (first_frame is traced: no recompile across frames) ----
    if reuse & ReservoirReuse.TEMPORAL:
        temporal = find_temporal_neighbor(
            last_reservoir, gbuf.motion, gbuf.frame, last_frame,
            pixel_offset=pixel_offset,
        )
        r1, sampler = rng.sample_1d(table, sampler)
        ok = (
            ~_invalid(temporal)
            & (temporal.num > 0)
            & ~jnp.asarray(first_frame, bool)
        )
        res = _pre_clamped_merge(res, temporal, r1, ok, temporal_clamp)

    reservoir_out = _check_validity(res)

    # ---- spatial reuse on the completed post-temporal image ----
    if reuse & ReservoirReuse.SPATIAL:
        spatial, sampler = merge_spatial(
            reservoir_out, gbuf.frame, cam.width, cam.height, sampler, table,
            looper=looper, pixel_idx=pixel_idx,
        )
        r1, sampler = rng.sample_1d(table, sampler)
        ok = ~_invalid(spatial) & (spatial.num > 0) & ~_invalid(res)
        res = _merge(res, spatial, r1, ok)

    # ---- shade (restir.cu:189-194) ----
    p_hat = _p_hat(res, mat, norm, wo, types=ds.mat_types)
    w_big = _big_w(res, p_hat)
    contrib = p_hat * w_big[..., None]
    ok = shade & ~_invalid(res) & (res.num > 0)
    contrib = jnp.where(ok[..., None], contrib, 0.0)
    bad = jnp.any(~jnp.isfinite(contrib), axis=-1, keepdims=True)
    direct = direct + jnp.where(bad, 0.0, contrib)

    # re-modulate with gbuffer albedo (restir.cu:200)
    direct = direct * gbuf.albedo
    return direct, reservoir_out
