"""Dense ray x triangle sweep as a Pallas kernel for NVIDIA GPUs (Triton).

Twin of :func:`radish_pt_tpu.accel.traverse.intersect_brute` for the
small scenes the ``brute`` engine serves.  One program owns a block of
``RAY_BLOCK`` rays and keeps their origin, direction and best hit in
registers; a loop inside the program walks the triangles in chunks of
``TRI_CHUNK`` with masked loads, so nothing carries between programs and
the blocks run in any order.  The Möller–Trumbore arithmetic is the XLA
engine's own (``traverse._mt_core``), and ties resolve the same way: the
lowest triangle index among equal distances wins.

The occlusion variant stops a block's chunk loop once every ray in it is
blocked (any-hit early exit).

``interpret=True`` runs the kernel through the Pallas interpreter, which is
how the CPU tests reach it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .traverse import FLT_MAX, NULL_PRIMITIVE, RAY_OFFSET, _mt_core

RAY_BLOCK = 128  # rays per program (power of two)
TRI_CHUNK = 16  # triangles per loop step (power of two)
NUM_WARPS = 4


def _chunk(tri_refs, c, num_tris):
    """Masked load of triangle chunk ``c``: nine [1, TRI_CHUNK] columns and
    the [TRI_CHUNK] triangle ids with their validity mask."""
    off = c * TRI_CHUNK
    ids = off + jax.lax.broadcasted_iota(jnp.int32, (TRI_CHUNK,), 0)
    valid = ids < num_tris
    cols = [
        plgpu.load(r.at[pl.ds(off, TRI_CHUNK)], mask=valid, other=0.0)[None, :]
        for r in tri_refs
    ]
    return cols, ids, valid


def _closest_kernel(*refs, num_tris: int, n_chunks: int):
    tri_refs, ray_refs = refs[:9], refs[9:15]
    prim_ref, dist_ref, bx_ref, by_ref = refs[15:]
    ox, oy, oz, dx, dy, dz = (r[...][:, None] for r in ray_refs)  # [B, 1]

    def body(c, carry):
        best_prim, best_dist, best_bx, best_by = carry
        cols, ids, valid = _chunk(tri_refs, c, num_tris)
        hit, dist, bx, by = _mt_core(*cols, ox, oy, oz, dx, dy, dz)
        dist = jnp.where(hit & valid[None, :], dist, FLT_MAX)
        cd = jnp.min(dist, axis=1)
        # lowest id among the chunk's minima, as argmin picks it
        j = jnp.min(jnp.where(dist == cd[:, None], ids[None, :],
                              jnp.int32(2**31 - 1)), axis=1)
        sel = ids[None, :] == j[:, None]
        cbx = jnp.sum(jnp.where(sel, bx, 0.0), axis=1)
        cby = jnp.sum(jnp.where(sel, by, 0.0), axis=1)
        upd = cd < best_dist
        return (
            jnp.where(upd, j, best_prim),
            jnp.where(upd, cd, best_dist),
            jnp.where(upd, cbx, best_bx),
            jnp.where(upd, cby, best_by),
        )

    zero = jnp.zeros((RAY_BLOCK,), jnp.float32)
    init = (jnp.full((RAY_BLOCK,), NULL_PRIMITIVE, jnp.int32), zero + FLT_MAX,
            zero, zero)
    prim, dist, bx, by = jax.lax.fori_loop(0, n_chunks, body, init)
    prim_ref[...] = prim
    dist_ref[...] = dist
    bx_ref[...] = bx
    by_ref[...] = by


def _occlusion_kernel(*refs, num_tris: int, n_chunks: int):
    tri_refs, ray_refs = refs[:9], refs[9:16]
    (blocked_ref,) = refs[16:]
    ox, oy, oz, dx, dy, dz, tmax = (r[...][:, None] for r in ray_refs)

    def cond(st):
        c, n_open, _ = st
        return (c < n_chunks) & (n_open > 0)

    def body(st):
        c, _, blocked = st
        cols, _, valid = _chunk(tri_refs, c, num_tris)
        hit, dist, _, _ = _mt_core(*cols, ox, oy, oz, dx, dy, dz)
        hit = hit & valid[None, :] & (dist < tmax)
        blocked = jnp.maximum(blocked, jnp.max(hit.astype(jnp.int32), axis=1))
        return c + 1, jnp.sum(1 - blocked), blocked

    blocked0 = jnp.zeros((RAY_BLOCK,), jnp.int32)
    _, _, blocked = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(RAY_BLOCK), blocked0)
    )
    blocked_ref[...] = blocked


def _call(kernel, tri_packed, ray_cols, out_dtypes, interpret):
    """Pad rays to whole blocks and run ``kernel`` over the ray grid."""
    n = ray_cols[0].shape[0]
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    num_tris = tri_packed.shape[0]
    n_chunks = max(1, -(-num_tris // TRI_CHUNK))
    tris = [tri_packed[:, k] for k in range(9)]
    # padded lanes trace a harmless ray (+z from the origin); results dropped
    rays = [jnp.pad(col, (0, n_pad - n), constant_values=1.0)
            for col in ray_cols]
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    # inside shard_map the outputs vary over the mesh axes the inputs do
    vma = frozenset().union(*(jax.typeof(x).vma for x in tris + rays))
    outs = pl.pallas_call(
        functools.partial(kernel, num_tris=num_tris, n_chunks=n_chunks),
        grid=(n_pad // RAY_BLOCK,),
        in_specs=[pl.no_block_spec] * 9 + [ray_spec] * len(rays),
        out_specs=[ray_spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt, vma=vma)
                   for dt in out_dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*tris, *rays)
    return [o[:n] for o in outs]


@functools.partial(jax.jit, static_argnames=("interpret",))
def intersect_brute_triton(tri_packed, ray_o, ray_d, interpret: bool = False):
    """Closest hit over all triangles.  ``tri_packed`` f32[T, 9] (v0, e01,
    e02), rays [N, 3].  Returns (prim_id [N], dist [N], bary [N, 2])."""
    cols = [ray_o[:, k] for k in range(3)] + [ray_d[:, k] for k in range(3)]
    prim, dist, bx, by = _call(
        _closest_kernel, tri_packed, cols,
        (jnp.int32, jnp.float32, jnp.float32, jnp.float32), interpret,
    )
    return prim, dist, jnp.stack([bx, by], axis=-1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def occlusion_brute_triton(tri_packed, x, y, interpret: bool = False):
    """Any-hit between points x and y, with the same segment conventions as
    :func:`radish_pt_tpu.accel.traverse.occlusion_brute`.  Returns bool [N]
    (True = occluded)."""
    eps = 1e-4
    d = y - x
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
    dirn = d / dist[..., None]
    ori = x + dirn * RAY_OFFSET
    cols = ([ori[:, k] for k in range(3)] + [dirn[:, k] for k in range(3)]
            + [dist - eps])
    (blocked,) = _call(_occlusion_kernel, tri_packed, cols, (jnp.int32,),
                       interpret)
    return blocked != 0
