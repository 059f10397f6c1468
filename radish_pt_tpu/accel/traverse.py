"""Ray–scene intersection: branch-free primitives + lockstep MTBVH traversal.

Wavefront re-design of the reference's per-thread device routines:

* slab test          — ``AABB::intersect``            (bvh.h:91-155)
* Möller–Trumbore    — ``intersectTriangle``          (intersections.h:20-68)
* MTBVH traversal    — ``DevScene::intersect``        (scene.h:262-301)
* occlusion          — ``DevScene::testOcclusion``    (scene.h:303-334)
* brute-force oracle — ``DevScene::naiveIntersect``   (scene.h:218-242)
* BVH heatmap        — ``DevScene::visualizedIntersect`` (scene.h:336-372)

Instead of one divergent while-loop per CUDA thread, a whole wavefront of N
rays advances in lockstep through a ``lax.while_loop``: each iteration every
active lane visits exactly one node, exactly mirroring the reference's
per-iteration work.  Lanes that finish park at ``node == BVHSize`` and no-op.

Layout decisions:

* Node records are PACKED into one f32[6B, 8] row per (direction, node):
  bmin.xyz, bmax.xyz, bitcast(prim), bitcast(miss) — so each lockstep
  iteration issues ONE [N, 8] gather instead of five scattered ones.
* Triangles are packed as f32[T, 9] = v0.xyz, e01.xyz, e02.xyz with the edge
  vectors precomputed.
* All intersection math is COMPONENT-WISE over [N]-shaped (or [N, C]-shaped)
  arrays, so no size-3 axis ends up minor-most.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # reference makeOffsetedRay (intersections.h:16-18)
# np scalar, NOT jnp: a module-level device array would initialize the XLA
# backend at import time, breaking jax.distributed.initialize ordering
FLT_MAX = np.float32(3.402823466e38)


# ---------------------------------------------------------------------------
# packing (host / trace time)
# ---------------------------------------------------------------------------


def pack_bvh(bvh) -> np.ndarray:
    """Pack the 6-way threaded BVH into one gather-friendly f32[6B, 8] table:
    row = [bmin.x, bmin.y, bmin.z, bmax.x, bmax.y, bmax.z, leaf, miss]
    with the int32 fields (leaf row or -1; miss link) bitcast into f32 lanes."""
    leaf = np.asarray(bvh.node_leaf).reshape(-1)
    aabb = np.asarray(bvh.node_aabb).reshape(-1)
    miss = np.asarray(bvh.node_miss).reshape(-1)
    bmin = np.asarray(bvh.bounds_min)[aabb]
    bmax = np.asarray(bvh.bounds_max)[aabb]
    out = np.empty((leaf.shape[0], 8), np.float32)
    out[:, 0:3] = bmin
    out[:, 3:6] = bmax
    out[:, 6] = leaf.astype(np.int32).view(np.float32)
    out[:, 7] = miss.astype(np.int32).view(np.float32)
    return out


def pack_tris(tri_v) -> np.ndarray:
    """Pack triangles as f32[T, 9] = v0.xyz, e01.xyz, e02.xyz."""
    v = np.asarray(tri_v).reshape(-1, 3, 3)
    out = np.empty((v.shape[0], 9), np.float32)
    out[:, 0:3] = v[:, 0]
    out[:, 3:6] = v[:, 1] - v[:, 0]
    out[:, 6:9] = v[:, 2] - v[:, 0]
    return out


def _split3(a):
    return a[..., 0], a[..., 1], a[..., 2]


# ---------------------------------------------------------------------------
# component-wise primitives
# ---------------------------------------------------------------------------


def _mt_core(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
             ox, oy, oz, dx, dy, dz):
    """Component-wise Möller–Trumbore with sign-normalized determinant
    (intersections.h:20-68).  All operands broadcast-compatible arrays.
    Returns (hit, dist, bary_x, bary_y)."""
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det0 = e1x * px + e1y * py + e1z * pz
    sign = jnp.where(det0 < 0.0, -1.0, 1.0)
    det = jnp.abs(det0)
    # s = (o - v0) * sign
    sx = (ox - v0x) * sign
    sy = (oy - v0y) * sign
    sz = (oz - v0z) * sign
    bx = sx * px + sy * py + sz * pz
    # qvec = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    by = dx * qx + dy * qy + dz * qz
    inv_det = 1.0 / jnp.maximum(det, 1e-30)
    dist = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        (det >= 1.1920929e-07)
        & (bx >= 0.0)
        & (bx <= det)
        & (by >= 0.0)
        & (bx + by <= det)
        & (dist > 0.0)
    )
    return hit, dist, bx * inv_det, by * inv_det


def _slab_core(bminx, bminy, bminz, bmaxx, bmaxy, bmaxz,
               ox, oy, oz, ix, iy, iz):
    """Component-wise slab test; i* = 1/d* precomputed per ray.
    Returns (hit, t_near); t_near may be negative with origin inside."""
    def axis(bmin, bmax, o, inv):
        t1 = (bmin - o) * inv
        t2 = (bmax - o) * inv
        lo = jnp.nan_to_num(jnp.minimum(t1, t2), nan=-jnp.inf)
        hi = jnp.nan_to_num(jnp.maximum(t1, t2), nan=jnp.inf)
        return lo, hi

    lx, hx = axis(bminx, bmaxx, ox, ix)
    ly, hy = axis(bminy, bmaxy, oy, iy)
    lz, hz = axis(bminz, bmaxz, oz, iz)
    t_near = jnp.maximum(lx, jnp.maximum(ly, lz))
    t_far = jnp.minimum(hx, jnp.minimum(hy, hz))
    return (t_far >= 0.0) & (t_far >= t_near), t_near


# vec3-shaped wrappers kept for unit tests / external callers ---------------


def slab_test(bmin, bmax, ori, dir):
    inv = 1.0 / dir
    return _slab_core(
        bmin[..., 0], bmin[..., 1], bmin[..., 2],
        bmax[..., 0], bmax[..., 1], bmax[..., 2],
        ori[..., 0], ori[..., 1], ori[..., 2],
        inv[..., 0], inv[..., 1], inv[..., 2],
    )


def moller_trumbore(v0, v1, v2, ori, dir):
    e1 = v1 - v0
    e2 = v2 - v0
    hit, dist, bx, by = _mt_core(
        v0[..., 0], v0[..., 1], v0[..., 2],
        e1[..., 0], e1[..., 1], e1[..., 2],
        e2[..., 0], e2[..., 1], e2[..., 2],
        ori[..., 0], ori[..., 1], ori[..., 2],
        dir[..., 0], dir[..., 1], dir[..., 2],
    )
    return hit, dist, jnp.stack([bx, by], axis=-1)


def get_dir_class(d):
    """Map a direction to one of 6 axis-sign classes — ``DevScene::getMTBVHId``
    (scene.h:114-129).  NOTE: like the reference, traversal passes the
    *negated* ray direction."""
    ax, ay, az = jnp.abs(d[..., 0]), jnp.abs(d[..., 1]), jnp.abs(d[..., 2])
    x_cls = jnp.where(d[..., 0] > 0, 0, 1)
    y_cls = jnp.where(d[..., 1] > 0, 2, 3)
    z_cls = jnp.where(d[..., 2] > 0, 4, 5)
    return jnp.where(
        ax > ay,
        jnp.where(ax > az, x_cls, z_cls),
        jnp.where(ay > az, y_cls, z_cls),
    ).astype(jnp.int32)


def make_offseted(ori, dir):
    return ori + dir * RAY_OFFSET


# ---------------------------------------------------------------------------
# brute force (oracle + small scenes) — dense [N, C] component math
# ---------------------------------------------------------------------------


def intersect_brute(tri_packed, ray_o, ray_d, chunk: int = 2048):
    """All-pairs closest hit; [N] rays x [T] triangles in [N, chunk] tiles.

    Oracle for the BVH path (mirrors ``naiveIntersect``, scene.h:218-242) and
    the fast path for small scenes.  ``tri_packed`` is the f32[T, 9] table
    (accepts raw [T, 3, 3] soup too).  Returns (prim_id, dist, bary [N, 2]).
    """
    if tri_packed.ndim == 3:  # raw soup convenience (tests)
        v = tri_packed
        tri_packed = jnp.concatenate(
            [v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=-1
        )
    num_tris = tri_packed.shape[0]
    chunk = min(chunk, max(8, -(-num_tris // 8) * 8))
    num_chunks = max(1, -(-num_tris // chunk))
    pad = num_chunks * chunk - num_tris
    tp = jnp.pad(tri_packed, ((0, pad), (0, 0)))

    n = ray_o.shape[0]
    ox, oy, oz = (ray_o[:, k : k + 1] for k in range(3))  # [N, 1]
    dx, dy, dz = (ray_d[:, k : k + 1] for k in range(3))

    init = (
        jnp.full((n,), NULL_PRIMITIVE, jnp.int32),
        jnp.full((n,), FLT_MAX),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )

    def body(c, carry):
        best_prim, best_dist, best_bx, best_by = carry
        tc = jax.lax.dynamic_slice(tp, (c * chunk, 0), (chunk, 9))
        cols = [tc[None, :, k] for k in range(9)]  # each [1, chunk]
        hit, dist, bx, by = _mt_core(*cols, ox, oy, oz, dx, dy, dz)
        tri_idx = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
        hit = hit & (tri_idx[None, :] < num_tris)
        dist = jnp.where(hit, dist, FLT_MAX)
        j = jnp.argmin(dist, axis=-1)
        take = jnp.take_along_axis
        cd = take(dist, j[:, None], 1)[:, 0]
        cbx = take(bx, j[:, None], 1)[:, 0]
        cby = take(by, j[:, None], 1)[:, 0]
        upd = cd < best_dist
        return (
            jnp.where(upd, tri_idx[j], best_prim),
            jnp.where(upd, cd, best_dist),
            jnp.where(upd, cbx, best_bx),
            jnp.where(upd, cby, best_by),
        )

    if num_chunks == 1:
        prim, dist, bx, by = body(0, init)
    else:
        prim, dist, bx, by = jax.lax.fori_loop(0, num_chunks, body, init)
    return prim, dist, jnp.stack([bx, by], axis=-1)


def occlusion_brute(tri_packed, x, y, chunk: int = 2048):
    """Any-hit between points x and y — ``naiveTestOcclusion`` (scene.h:244-260).
    Returns bool [N] (True = occluded)."""
    eps = 1e-4
    d = y - x
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    dirn = d / dist[..., None]
    max_dist = dist - eps
    ori = make_offseted(x, dirn)
    prim, hit_dist, _ = intersect_brute(tri_packed, ori, dirn, chunk)
    return (prim != NULL_PRIMITIVE) & (hit_dist < max_dist)


# ---------------------------------------------------------------------------
# MTBVH lockstep traversal over the packed node table
# ---------------------------------------------------------------------------


def _fetch_packed(bvh_packed, dir_off, node, size):
    """One [N, 8] gather per iteration; unpack components + bitcast ints."""
    row = bvh_packed[dir_off + jnp.minimum(node, size - 1)]
    prim = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
    miss = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
    return row, prim, miss


def _leaf_test(leaf_tris, leaf_field, ox, oy, oz, dx, dy, dz):
    """Dense [N, L] Möller–Trumbore batch against one leaf row per lane.
    Returns (best_hit, best_dist, best_bx, best_by, best_slot) where slot =
    leaf_row * L + j indexes the padded leaf_map."""
    L = leaf_tris.shape[1] // 9
    row = jnp.maximum(leaf_field, 0)
    tris = leaf_tris[row].reshape(-1, L, 9)  # one gather: [N, L*9]
    cols = [tris[:, :, k] for k in range(9)]  # each [N, L]
    hit, dist, bx, by = _mt_core(
        *cols,
        ox[:, None], oy[:, None], oz[:, None],
        dx[:, None], dy[:, None], dz[:, None],
    )
    dist = jnp.where(hit, dist, FLT_MAX)
    j = jnp.argmin(dist, axis=-1)
    take = jnp.take_along_axis
    best_dist = take(dist, j[:, None], 1)[:, 0]
    best_bx = take(bx, j[:, None], 1)[:, 0]
    best_by = take(by, j[:, None], 1)[:, 0]
    best_slot = row * L + j.astype(jnp.int32)
    return best_dist < FLT_MAX, best_dist, best_bx, best_by, best_slot


def _walk_step(leaf_tris, bvh_packed, size, consts, state):
    """One lockstep traversal step shared by all walk drivers.

    ``consts`` = (dir_off, ox, oy, oz, dx, dy, dz, ix, iy, iz) per lane;
    ``state`` = (node, c_slot, c_dist, c_bx, c_by).  The dense leaf batch
    (one [N, L*9] gather + L-wide MT) is cond-gated: iterations where no lane
    sits at a leaf (the whole lockstep tail) skip it entirely.
    """
    dir_off, ox, oy, oz, dx, dy, dz, ix, iy, iz = consts
    node, c_slot, c_dist, c_bx, c_by = state
    active = node < size
    row, leaf, miss = _fetch_packed(bvh_packed, dir_off, node, size)
    bhit, bdist = _slab_core(
        row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4], row[:, 5],
        ox, oy, oz, ix, iy, iz,
    )
    descend = active & bhit & (bdist < c_dist)
    is_leaf = descend & (leaf != NULL_PRIMITIVE)

    def do_leaf(args):
        c_slot, c_dist, c_bx, c_by = args
        lhit, ldist, lbx, lby, lslot = _leaf_test(
            leaf_tris, leaf, ox, oy, oz, dx, dy, dz
        )
        upd = is_leaf & lhit & (ldist < c_dist)
        return (
            jnp.where(upd, lslot, c_slot),
            jnp.where(upd, ldist, c_dist),
            jnp.where(upd, lbx, c_bx),
            jnp.where(upd, lby, c_by),
        )

    c_slot, c_dist, c_bx, c_by = jax.lax.cond(
        jnp.any(is_leaf), do_leaf, lambda a: a, (c_slot, c_dist, c_bx, c_by)
    )
    node = jnp.where(active, jnp.where(descend, node + 1, miss), node)
    return node, c_slot, c_dist, c_bx, c_by


def _ray_consts(bvh_packed, ray_o, ray_d):
    size = bvh_packed.shape[0] // 6
    dir_off = get_dir_class(-ray_d) * size
    ox, oy, oz = _split3(ray_o)
    dx, dy, dz = _split3(ray_d)
    return (dir_off, ox, oy, oz, dx, dy, dz, 1.0 / dx, 1.0 / dy, 1.0 / dz)


# Phase-1 lockstep budget + compaction fraction: after PHASE1_ITERS steps the
# vast majority of rays have parked (counted on teapot@160^2: 63% active at 96
# steps, 9.6% at 128, 0.4% at 192); the unfinished tail is compacted to
# n/COMPACT_FRAC lanes and walked to completion, so the gathers of the long
# tail run over a quarter of the lanes.  A final full-width while_loop
# guarantees correctness if the tail overflowed the compact buffer (it exits
# immediately in the common case).
PHASE1_ITERS = 128
COMPACT_FRAC = 4


# Inside a walk block, a lane reaching a leaf parks the leaf row in a carried
# "pending" register and keeps walking; pendings are tested in one dense batch
# at each block boundary (no per-iteration lax.cond and its operand copies).
# A lane that reaches a SECOND leaf while one is pending
# stalls in place until the next flush (rare: >1 leaf per 8 steps).
FLUSH_EVERY = 8


def _pending_walk_block(leaf_tris, bvh_packed, size, consts, state, iters):
    """``iters`` node steps collecting pending leaves, then one dense flush."""
    dir_off, ox, oy, oz, dx, dy, dz, ix, iy, iz = consts

    def node_step(s):
        node, pending, c_dist = s
        active = node < size
        row, leaf, miss = _fetch_packed(bvh_packed, dir_off, node, size)
        bhit, bdist = _slab_core(
            row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4], row[:, 5],
            ox, oy, oz, ix, iy, iz,
        )
        descend = active & bhit & (bdist < c_dist)
        is_leaf = descend & (leaf != NULL_PRIMITIVE)
        can_take = pending < 0
        pending = jnp.where(is_leaf & can_take, leaf, pending)
        # stall when at a leaf with the register full
        advance = descend & (~is_leaf | can_take)
        node = jnp.where(
            active,
            jnp.where(advance, node + 1, jnp.where(descend, node, miss)),
            node,
        )
        return node, pending, c_dist

    node, c_slot, c_dist, c_bx, c_by = state
    pending = node * 0 - 1  # inherits the carry's varying axes
    node, pending, c_dist = jax.lax.fori_loop(
        0, iters, lambda i, s: node_step(s), (node, pending, c_dist)
    )

    # flush: lanes without a pending leaf gather row 0 (convergent ~ free)
    lhit, ldist, lbx, lby, lslot = _leaf_test(
        leaf_tris, jnp.maximum(pending, 0), ox, oy, oz, dx, dy, dz
    )
    upd = (pending >= 0) & lhit & (ldist < c_dist)
    return (
        node,
        jnp.where(upd, lslot, c_slot),
        jnp.where(upd, ldist, c_dist),
        jnp.where(upd, lbx, c_bx),
        jnp.where(upd, lby, c_by),
    )


def intersect_bvh(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d):
    """Closest-hit via stackless threaded traversal (scene.h:262-301) with
    dense multi-triangle leaves, deferred leaf flushing, and tail compaction.

    ``bvh_packed``: f32[6B, 8] node table; ``leaf_tris``: f32[R, L*9] padded
    leaf-major triangle table; ``leaf_map``: i32[R*L] slot -> prim id.
    Returns (prim_id, dist, bary [N, 2]).
    """
    size = bvh_packed.shape[0] // 6
    n = ray_o.shape[0]
    consts = _ray_consts(bvh_packed, ray_o, ray_d)

    # derive the carry from ray state so it inherits shard_map varying
    # axes (fresh constants would be replicated and fail the fori/scan
    # carry variance check — same pattern as render/pathtrace.py)
    zf = ray_o[:, 0] * 0.0
    zi = zf.astype(jnp.int32)
    init = (zi, zi - 1, zf + FLT_MAX, zf, zf)

    def step(s):
        return _walk_step(leaf_tris, bvh_packed, size, consts, s)

    # phase 1: fixed lockstep budget, full width, block-flushed pendings.
    # A rolled loop over the blocks: unrolling them repeats the block body
    # 16 times in every walk of the program and multiplies compile time.
    state = jax.lax.fori_loop(
        0, PHASE1_ITERS // FLUSH_EVERY,
        lambda _, s: _pending_walk_block(
            leaf_tris, bvh_packed, size, consts, s, FLUSH_EVERY
        ),
        init,
    )

    # phase 2: compact the unfinished tail and walk it to completion
    m = max(128, n // COMPACT_FRAC)
    if m < n:
        ids = jnp.nonzero(state[0] < size, size=m, fill_value=n)[0]
        safe = jnp.minimum(ids, n - 1)
        sub_consts = tuple(c[safe] for c in consts)
        sub_state = tuple(s[safe] for s in state)
        # park the fill lanes
        sub_state = (jnp.where(ids < n, sub_state[0], size),) + sub_state[1:]

        def sub_step(s):
            return _walk_step(leaf_tris, bvh_packed, size, sub_consts, s)

        sub_state = jax.lax.while_loop(
            lambda s: jnp.any(s[0] < size), lambda s: sub_step(s), sub_state
        )
        # scatter back (mode='drop' ignores the fill lanes at index n)
        state = tuple(
            arr.at[ids].set(sub, mode="drop")
            for arr, sub in zip(state, sub_state)
        )

    # phase 3: safety net for compact-buffer overflow (usually exits at once)
    state = jax.lax.while_loop(
        lambda s: jnp.any(s[0] < size), lambda s: step(s), state
    )

    _, slot, dist, bx, by = state
    prim = jnp.where(slot >= 0, leaf_map[jnp.maximum(slot, 0)], NULL_PRIMITIVE)
    return prim, dist, jnp.stack([bx, by], axis=-1)


def occlusion_bvh(leaf_tris, leaf_map, bvh_packed, x, y):
    """Any-hit shadow query with early lane termination (scene.h:303-334).
    Returns bool [N] (True = occluded)."""
    size = bvh_packed.shape[0] // 6
    eps = 1e-4
    d = y - x
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    ray_d = d / dist[..., None]
    max_dist = dist - eps
    ray_o = make_offseted(x, ray_d)
    n = x.shape[0]
    consts = _ray_consts(bvh_packed, ray_o, ray_d) + (max_dist,)

    def occ_step(consts, state):
        dir_off, ox, oy, oz, dx, dy, dz, ix, iy, iz, max_dist = consts
        node, blocked = state
        active = node < size
        row, leaf, miss = _fetch_packed(bvh_packed, dir_off, node, size)
        bhit, bdist = _slab_core(
            row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4], row[:, 5],
            ox, oy, oz, ix, iy, iz,
        )
        descend = active & bhit & (bdist < max_dist)
        is_leaf = descend & (leaf != NULL_PRIMITIVE)

        def do_leaf(blk):
            lhit, ldist, _, _, _ = _leaf_test(
                leaf_tris, leaf, ox, oy, oz, dx, dy, dz
            )
            return blk | (is_leaf & lhit & (ldist < max_dist))

        blocked = jax.lax.cond(jnp.any(is_leaf), do_leaf, lambda b: b, blocked)
        node = jnp.where(active, jnp.where(descend, node + 1, miss), node)
        node = jnp.where(blocked, size, node)  # early exit for settled lanes
        return node, blocked

    def occ_block(state, iters):
        """iters node steps collecting pending leaves + one dense flush."""
        dir_off, ox, oy, oz, dx, dy, dz, ix, iy, iz, md = consts

        def node_step(s):
            node, pending = s
            active = node < size
            row, leaf, miss = _fetch_packed(bvh_packed, dir_off, node, size)
            bhit, bdist = _slab_core(
                row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4], row[:, 5],
                ox, oy, oz, ix, iy, iz,
            )
            descend = active & bhit & (bdist < md)
            is_leaf = descend & (leaf != NULL_PRIMITIVE)
            can_take = pending < 0
            pending = jnp.where(is_leaf & can_take, leaf, pending)
            advance = descend & (~is_leaf | can_take)
            node = jnp.where(
                active,
                jnp.where(advance, node + 1, jnp.where(descend, node, miss)),
                node,
            )
            return node, pending

        node, blocked = state
        pending = jnp.full_like(node, -1)
        node, pending = jax.lax.fori_loop(
            0, iters, lambda i, s: node_step(s), (node, pending)
        )
        lhit, ldist, _, _, _ = _leaf_test(
            leaf_tris, jnp.maximum(pending, 0), ox, oy, oz, dx, dy, dz
        )
        blocked = blocked | ((pending >= 0) & lhit & (ldist < md))
        node = jnp.where(blocked, size, node)
        return node, blocked

    # carry derived from ray state: inherits shard_map varying axes
    zi = (x[:, 0] * 0.0).astype(jnp.int32)
    state = jax.lax.fori_loop(  # rolled, as in intersect_bvh
        0, PHASE1_ITERS // FLUSH_EVERY,
        lambda _, s: occ_block(s, FLUSH_EVERY), (zi, zi.astype(bool)),
    )

    m = max(128, n // COMPACT_FRAC)
    if m < n:
        ids = jnp.nonzero(state[0] < size, size=m, fill_value=n)[0]
        safe = jnp.minimum(ids, n - 1)
        sub_consts = tuple(c[safe] for c in consts)
        sub_state = tuple(s[safe] for s in state)
        sub_state = (jnp.where(ids < n, sub_state[0], size),) + sub_state[1:]
        sub_state = jax.lax.while_loop(
            lambda s: jnp.any(s[0] < size),
            lambda s: occ_step(sub_consts, s),
            sub_state,
        )
        state = tuple(
            arr.at[ids].set(sub, mode="drop")
            for arr, sub in zip(state, sub_state)
        )

    state = jax.lax.while_loop(
        lambda s: jnp.any(s[0] < size), lambda s: occ_step(consts, s), state
    )
    return state[1]


def intersect_bvh_heatmap(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d):
    """Traversal-depth heatmap for BVH debugging (``visualizedIntersect``,
    scene.h:336-372).  Returns int32 [N] = number of descended nodes."""
    size = bvh_packed.shape[0] // 6
    n = ray_o.shape[0]
    dir_off = get_dir_class(-ray_d) * size
    ox, oy, oz = _split3(ray_o)
    dx, dy, dz = _split3(ray_d)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz

    def cond(state):
        return jnp.any(state[0] < size)

    def body(state):
        node, c_dist, steps = state
        active = node < size
        row, leaf, miss = _fetch_packed(bvh_packed, dir_off, node, size)
        bhit, bdist = _slab_core(
            row[:, 0], row[:, 1], row[:, 2], row[:, 3], row[:, 4], row[:, 5],
            ox, oy, oz, ix, iy, iz,
        )
        descend = active & bhit & (bdist < c_dist)
        is_leaf = descend & (leaf != NULL_PRIMITIVE)

        def do_leaf(cd):
            lhit, ldist, _, _, _ = _leaf_test(
                leaf_tris, leaf, ox, oy, oz, dx, dy, dz
            )
            upd = is_leaf & lhit & (ldist < cd)
            return jnp.where(upd, ldist, cd)

        c_dist = jax.lax.cond(jnp.any(is_leaf), do_leaf, lambda c: c, c_dist)
        steps = steps + descend.astype(jnp.int32)
        node = jnp.where(active, jnp.where(descend, node + 1, miss), node)
        return node, c_dist, steps

    init = (
        jnp.zeros((n,), jnp.int32),
        jnp.full((n,), FLT_MAX),
        jnp.zeros((n,), jnp.int32),
    )
    _, _, steps = jax.lax.while_loop(cond, body, init)
    return steps
