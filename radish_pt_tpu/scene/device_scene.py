"""DeviceScene: the on-device scene mirror as a pytree of SoA arrays.

Wavefront re-design of the reference's ``DevScene`` (``/root/reference/src/scene.h:73-518``).
Where the reference owns raw CUDA pointers and per-thread methods, here the
scene is an immutable pytree of ``jnp`` arrays (geometry soup, 6-way threaded
BVH, material SoA, one big texture atlas, light tables, alias samplers, Sobol
table) and every "method" is a pure, wavefront-batched function.

Conventions:
* ``[N]`` = wavefront lanes (rays/pixels); ``[T]`` triangles; ``[B]`` BVH
  nodes; ``[M]`` materials; ``[L]`` area lights (+1 alias slot for the env
  map, like the reference's light sampler — scene.h:424-427).
* Lights are single-sided toward their geometric normal when
  ``single_sided`` is set.  NOTE: the reference's NEE and emissive-hit tests
  disagree about which side emits (scene.h:444-448 vs pathtrace.cu:252-256);
  we use one consistent convention: a light emits into the half-space its
  geometric normal points into.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from ..accel import traverse as trv
from ..sampling.alias import alias_sample
from ..utils import math as m
from ..utils import struct
from ..utils.gather import take_rows

NULL_TEXTURE = -1
PROCEDURAL_TEXTURE = -2
INVALID_PDF = -1.0

MAT_LAMBERTIAN = 0
MAT_METALLIC_WORKFLOW = 1
MAT_DIELECTRIC = 2
MAT_DISNEY = 3  # parsed but shaded as metallic workflow (reference never implements Disney either)
MAT_LIGHT = 4

MATERIAL_TYPE_TOKENS = {
    "Lambertian": MAT_LAMBERTIAN,
    "MetallicWorkflow": MAT_METALLIC_WORKFLOW,
    "Dielectric": MAT_DIELECTRIC,
    "Disney": MAT_DISNEY,
    "Light": MAT_LIGHT,
}


@struct.dataclass
class DeviceScene:
    # --- static metadata (compile-time) ---
    # intersector: 'bvh' (lockstep MTBVH walk), 'brute' (XLA dense
    # all-pairs sweep, small scenes) or 'pallas_brute' (the same sweep as a
    # Pallas-Triton kernel, GPU) — scene/build.py::select_intersector
    intersector: str = struct.field(pytree_node=False, default="bvh")
    n_area_lights: int = struct.field(pytree_node=False, default=0)
    has_env: bool = struct.field(pytree_node=False, default=False)
    has_aperture: bool = struct.field(pytree_node=False, default=False)
    single_sided: bool = struct.field(pytree_node=False, default=True)
    # static tuple of MAT_* types present: BSDF dispatch skips absent lobes
    # (None = unknown, evaluate everything)
    mat_types: tuple = struct.field(pytree_node=False, default=None)

    # --- geometry soup (DevScene::vertices/normals/texcoords, scene.h:494-496) ---
    tri_v: jnp.ndarray = None  # f32 [T, 3, 3] (light sampling / host use)
    # per-triangle shading attributes packed for ONE gather per hit:
    # [v0 v1 v2 (9) | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat id (1)] — one
    # row fetch per lane instead of four narrow ones
    tri_attr: jnp.ndarray = None  # f32 [T, 25]
    material_ids: jnp.ndarray = None  # i32 [T]

    # --- MTBVH (scene.h:497-499) ---
    bounds_min: jnp.ndarray = None  # f32 [B, 3]
    bounds_max: jnp.ndarray = None  # f32 [B, 3]
    bvh_packed: jnp.ndarray = None  # f32 [6*B, 8] packed node table
    tri_packed: jnp.ndarray = None  # f32 [T, 9] v0/e01/e02 components
    # AABBs of the leaf-order triangle clusters (scene/build.py): the
    # wavefront signature sort keys on them (None below 1k triangles)
    cluster_bounds: jnp.ndarray = None  # f32 [C, 6] (min.xyz, max.xyz)
    leaf_tris: jnp.ndarray = None  # f32 [R, L*9] padded leaf-major tris
    leaf_map: jnp.ndarray = None  # i32 [R*L] leaf slot -> prim id

    # --- materials SoA (Material struct, material.h:276-286) ---
    mat_type: jnp.ndarray = None  # i32 [M]
    mat_base_color: jnp.ndarray = None  # f32 [M, 3]
    mat_metallic: jnp.ndarray = None  # f32 [M]
    mat_roughness: jnp.ndarray = None  # f32 [M]
    mat_ior: jnp.ndarray = None  # f32 [M]
    mat_color_map: jnp.ndarray = None  # i32 [M]
    mat_normal_map: jnp.ndarray = None  # i32 [M]
    mat_metallic_map: jnp.ndarray = None  # i32 [M]
    mat_roughness_map: jnp.ndarray = None  # i32 [M]

    # --- texture atlas (DevScene::textureData + DevTextureObj views) ---
    tex_data: jnp.ndarray = None  # f32 [P, 3]
    tex_offset: jnp.ndarray = None  # i32 [K]
    tex_width: jnp.ndarray = None  # i32 [K]
    tex_height: jnp.ndarray = None  # i32 [K]
    env_tex: int = struct.field(pytree_node=False, default=NULL_TEXTURE)
    aperture_tex: int = struct.field(pytree_node=False, default=NULL_TEXTURE)

    # --- light tables (scene.h:506-512) ---
    light_prim_ids: jnp.ndarray = None  # i32 [L]
    light_radiance: jnp.ndarray = None  # f32 [L, 3]
    sum_light_power_inv: jnp.ndarray = None  # f32 scalar
    light_alias_prob: jnp.ndarray = None  # f32 [L(+1 env)]
    light_alias_idx: jnp.ndarray = None  # i32
    env_alias_prob: jnp.ndarray = None  # f32 [envW*envH] (or [1])
    env_alias_idx: jnp.ndarray = None  # i32
    aperture_alias_prob: jnp.ndarray = None  # f32
    aperture_alias_idx: jnp.ndarray = None  # i32

    # --- samplers ---
    sobol: jnp.ndarray = None  # u32 [SobolSampleNum * SobolSampleDim]

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]

    @property
    def has_lights(self) -> bool:
        """True when the light sampler is non-empty (area lights or env)."""
        return self.n_area_lights > 0 or self.has_env


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


def _texture_bilinear(ds: DeviceScene, tex_id, uv):
    """Bilinear texture fetch with wraparound — DevTextureObj::linearSample
    (image.h:42-73).  ``tex_id`` int32 [N] (must be valid), uv f32 [N, 2]."""
    w = ds.tex_width[tex_id]
    h = ds.tex_height[tex_id]
    off = ds.tex_offset[tex_id]
    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * h.astype(jnp.float32) - 0.5
    ix = jnp.floor(fx).astype(jnp.int32)
    iy = jnp.floor(fy).astype(jnp.int32)
    tx = fx - ix.astype(jnp.float32)
    ty = fy - iy.astype(jnp.float32)

    def wrap(i, n):
        return jnp.mod(jnp.mod(i, n) + n, n)

    x0 = wrap(ix, w)
    x1 = wrap(ix + 1, w)
    y0 = wrap(iy, h)
    y1 = wrap(iy + 1, h)
    c00 = ds.tex_data[off + y0 * w + x0]
    c10 = ds.tex_data[off + y0 * w + x1]
    c01 = ds.tex_data[off + y1 * w + x0]
    c11 = ds.tex_data[off + y1 * w + x1]
    cx0 = c00 * (1 - tx)[..., None] + c10 * tx[..., None]
    cx1 = c01 * (1 - tx)[..., None] + c11 * tx[..., None]
    return cx0 * (1 - ty)[..., None] + cx1 * ty[..., None]


def procedural_texture(uv):
    """Checker-ish procedural pattern — DevScene::proceduralTexture
    (scene.h:77-86), with the thrust RNG replaced by utilhash."""
    cell = (uv[..., 0] * 1024).astype(jnp.int32) * 1024 + (
        uv[..., 1] * 1024
    ).astype(jnp.int32)
    h1 = m.utilhash(cell.astype(jnp.uint32))
    h2 = m.utilhash(h1)
    rx = h1.astype(jnp.float32) * jnp.float32(2.0**-32)
    ry = h2.astype(jnp.float32) * jnp.float32(2.0**-32)
    f = (jnp.sin(uv[..., 0] * 10.0 * m.TWO_PI + rx * m.TWO_PI) + 1.0) * 0.5
    g = (jnp.sin(uv[..., 1] * 10.0 * m.TWO_PI + ry * m.TWO_PI) + 1.0) * 0.5
    return jnp.repeat((f * g)[..., None], 3, axis=-1)


# ---------------------------------------------------------------------------
# surface interaction
# ---------------------------------------------------------------------------


@struct.dataclass
class Interaction:
    prim_id: jnp.ndarray  # i32 [N], NULL_PRIMITIVE on miss
    mat_id: jnp.ndarray  # i32 [N]
    pos: jnp.ndarray  # f32 [N, 3]
    norm: jnp.ndarray  # f32 [N, 3] (shading normal)
    uv: jnp.ndarray  # f32 [N, 2]


@struct.dataclass
class SurfaceMaterial:
    """Per-lane material parameters after texture fetches
    (getTexturedMaterialAndSurface, scene.h:88-112)."""

    mtype: jnp.ndarray  # i32 [N]
    base_color: jnp.ndarray  # f32 [N, 3]
    metallic: jnp.ndarray  # f32 [N]
    roughness: jnp.ndarray  # f32 [N]
    ior: jnp.ndarray  # f32 [N]


def surface_info(ds: DeviceScene, prim_id, bary) -> tuple:
    """Interpolate position/normal/uv from barycentrics —
    ``getIntersecGeomInfo`` (scene.h:147-165) as ONE packed [T,25] gather.
    Also returns mat_id (f32 col 24, exact), -1 where prim_id < 0."""
    a = take_rows(ds.tri_attr, jnp.maximum(prim_id, 0))
    bx = bary[..., 0:1]
    by = bary[..., 1:2]
    bw = 1.0 - bx - by
    pos = a[:, 3:6] * bx + a[:, 6:9] * by + a[:, 0:3] * bw
    norm = m.normalize(a[:, 12:15] * bx + a[:, 15:18] * by + a[:, 9:12] * bw)
    uvi = a[:, 20:22] * bx + a[:, 22:24] * by + a[:, 18:20] * bw
    mat_id = jnp.where(prim_id >= 0, a[:, 24].astype(jnp.int32), -1)
    return pos, norm, uvi, mat_id


def _closest_hit(ds: DeviceScene, ray_o, ray_d):
    """(prim_id, dist, bary) from the scene's intersection engine."""
    if ds.intersector == "bvh":
        return trv.intersect_bvh(
            ds.leaf_tris, ds.leaf_map, ds.bvh_packed, ray_o, ray_d
        )
    if ds.intersector == "pallas_brute":
        from ..accel.brute_triton import intersect_brute_triton

        return intersect_brute_triton(ds.tri_packed, ray_o, ray_d)
    return trv.intersect_brute(ds.tri_packed, ray_o, ray_d)


def intersect(ds: DeviceScene, ray_o, ray_d, active=None) -> Interaction:
    """Closest hit + surface interpolation (DevScene::intersect, scene.h:262-301).
    Static dispatch over the scene's intersector (MTBVH walk / dense sweep).

    ``active`` (bool [N], optional): lanes marked False are DEAD and return
    prim_id == NULL_PRIMITIVE.
    """
    prim, bary = intersect_ids(ds, ray_o, ray_d, active)
    pos, norm, uv, mat_id = surface_info(ds, prim, bary)
    return Interaction(prim_id=prim, mat_id=mat_id, pos=pos, norm=norm, uv=uv)


def intersect_sorted(ds: DeviceScene, ray_o, ray_d, active=None) -> Interaction:
    """Closest hit for DIVERGENT wavefronts (bounce rays): sort rays by their
    cluster signature (:func:`_sort_key`) so neighbouring lanes share a
    direction cone and an origin region, intersect, and undo the sort.

    ``active``: dead lanes sort to the back (top key bit) and report no hit.

    Both permutations ride ``lax.sort`` with payload columns: the forward
    sort carries (lane, rays), the inverse is a second sort keyed on the
    carried lane id.

    Results are bitwise identical to :func:`intersect` (per-ray independent
    math + exact round-trip), for any intersector.
    """
    if ds.cluster_bounds is None:
        return intersect(ds, ray_o, ray_d, active=active)

    n = ray_o.shape[0]
    key = _sort_key(ds, ray_o, ray_d)
    if active is not None:
        key = key + jnp.where(active, 0, _DEAD_KEY_BIT)
    lane = jnp.arange(n, dtype=jnp.int32)
    ops = (key, lane,
           ray_o[:, 0], ray_o[:, 1], ray_o[:, 2],
           ray_d[:, 0], ray_d[:, 1], ray_d[:, 2])
    s = jax.lax.sort(ops, num_keys=1)
    lane_s = s[1]
    o_s = jnp.stack(s[2:5], axis=-1)
    d_s = jnp.stack(s[5:8], axis=-1)
    # liveness rides the sorted KEY's dead bit — no payload column needed
    act_s = (s[0] < _DEAD_KEY_BIT) if active is not None else None

    it = intersect(ds, o_s, d_s, active=act_s)
    u = jax.lax.sort(
        (lane_s, it.prim_id, it.mat_id,
         it.pos[:, 0], it.pos[:, 1], it.pos[:, 2],
         it.norm[:, 0], it.norm[:, 1], it.norm[:, 2],
         it.uv[:, 0], it.uv[:, 1]),
        num_keys=1,
    )
    return Interaction(
        prim_id=u[1],
        mat_id=u[2],
        pos=jnp.stack(u[3:6], axis=-1),
        norm=jnp.stack(u[6:9], axis=-1),
        uv=jnp.stack(u[9:11], axis=-1),
    )


def intersect_compact(ds: DeviceScene, ray_o, ray_d, active, extras=(),
                      key=None):
    """Extension-pass closest hit that RETURNS THE SORTED ORDER — the
    wavefront-compaction primitive behind the tiered bounce loop
    (render/pathtrace.py).

    Like :func:`intersect_sorted`, rays sort by the cluster-signature key
    with dead lanes pushed to the back — but there is NO inverse
    permutation: the caller keeps its whole carry in the sorted order, so
    the live lanes occupy a contiguous prefix of length ``sum(active)``
    and the next bounce can statically slice a smaller capacity.
    ``extras``: tuple of f32/i32 [N] columns to carry through the forward
    sort (per-lane state that must follow its ray).

    Returns ``(it, o_sorted, d_sorted, act_sorted, extras_sorted)`` — all
    in sorted order; ``it.prim_id`` is NULL on dead lanes.
    """
    if key is None:
        key = _sort_key(ds, ray_o, ray_d)
    key = key + jnp.where(active, 0, _DEAD_KEY_BIT)
    ops = (key,
           ray_o[:, 0], ray_o[:, 1], ray_o[:, 2],
           ray_d[:, 0], ray_d[:, 1], ray_d[:, 2]) + tuple(extras)
    s = jax.lax.sort(ops, num_keys=1)
    o_s = jnp.stack(s[1:4], axis=-1)
    d_s = jnp.stack(s[4:7], axis=-1)
    extras_s = s[7:]
    act_s = s[0] < _DEAD_KEY_BIT
    it = intersect(ds, o_s, d_s, active=act_s)
    return it, o_s, d_s, act_s, extras_s


def intersect_ids(ds: DeviceScene, ray_o, ray_d, active=None):
    """Closest hit returning only the winner — ``(prim_id [N], bary [N,2])``
    — with NO surface recovery.  The sliced bounce loop
    (render/pathtrace.py::_sliced_bounce_loop) sweeps and refetches in the
    same slice, so the surface interpolation (:func:`surface_info`) moves
    after the accounting that needs only ids.  Dead lanes (``active``
    False) return NULL_PRIMITIVE."""
    prim, _, bary = _closest_hit(ds, ray_o, ray_d)
    if active is not None:
        prim = jnp.where(active, prim, -1)
    return prim, bary


_DEAD_KEY_BIT = 1 << 24  # above all live sort-key bits
# the signature prepass is an [N, C] slab test; big scenes COARSEN the key
# clusters (repeated pairing) to stay under this bound instead of falling
# back to the geometric key, whose pinhole primaries collapse to ONE
# (octant, origin-cell) bucket
_SIGNATURE_MAX_CLUSTERS = 256
# skip the forced key pairing when the scene already has few clusters —
# below this count the [N, C] prepass is cheap and the finer key wins;
# RADISH_SIG_PAIR_MIN overrides
_SIGNATURE_PAIR_MIN = 64


def _sort_key(ds: DeviceScene, ray_o, ray_d, tmax=None):
    """Wavefront coherence sort key.

    Preferred form: the ray's CLUSTER SIGNATURE — (first flagged cluster,
    second flagged cluster, clamped flag count) from a conservative slab
    test against the cluster AABBs.  Rays that sort together then cross
    near-identical cluster sets (teapot bounce rays: 7.4 clusters per
    128-ray row vs 10.9 for the best geometric (direction, Morton cell) key
    and 3.0 for the per-ray floor).

    ``tmax`` (f32 [N]): segment bound for shadow queries — tightens the
    signature to the segment.

    The signature is computed on 128-tri SUPER-clusters (pairs of the
    64-tri build clusters): the row-union count is the same (teapot 7.36 vs
    7.37 clusters/row) at half the [N, C] slab-prepass cost."""
    cb = ds.cluster_bounds
    # pair-reduce (64-tri clusters -> 128-tri super-clusters -> ...) until
    # the [N, C] signature prepass is affordable
    pair_min = int(os.environ.get("RADISH_SIG_PAIR_MIN",
                                  _SIGNATURE_PAIR_MIN))
    while cb.shape[0] > 1 and (
        cb.shape[0] > _SIGNATURE_MAX_CLUSTERS
        or (cb is ds.cluster_bounds and cb.shape[0] > pair_min)
    ):
        pad = cb.shape[0] % 2
        cbp = jnp.pad(cb, ((0, pad), (0, 0)),
                      mode="edge") if pad else cb
        pairs = cbp.reshape(-1, 2, 6)
        cb = jnp.concatenate(
            [pairs[:, :, 0:3].min(axis=1), pairs[:, :, 3:6].max(axis=1)],
            axis=1,
        )
    n_c = cb.shape[0]
    if n_c <= _SIGNATURE_MAX_CLUSTERS:
        inv = 1.0 / jnp.where(jnp.abs(ray_d) > 1e-12, ray_d, 1e-12)
        tn = jnp.full((ray_o.shape[0], n_c), -3.4e38)
        tf = jnp.full((ray_o.shape[0], n_c), 3.4e38)
        for k in range(3):
            a = (cb[None, :, k] - ray_o[:, k, None]) * inv[:, k, None]
            b = (cb[None, :, 3 + k] - ray_o[:, k, None]) * inv[:, k, None]
            tn = jnp.maximum(tn, jnp.minimum(a, b))
            tf = jnp.minimum(tf, jnp.maximum(a, b))
        hit = tf >= jnp.maximum(tn, 0.0)
        if tmax is not None:
            hit = hit & (tn < tmax[:, None])
        any_hit = hit.any(axis=1)
        first = jnp.where(any_hit, jnp.argmax(hit, axis=1), n_c + 1)
        ids = jnp.arange(n_c, dtype=jnp.int32)[None, :]
        rest = hit & (ids != first[:, None])
        second = jnp.where(rest.any(axis=1), jnp.argmax(rest, axis=1), n_c + 1)
        # first(8b) | second ABSOLUTE id (8b) | count(6b) = 22 bits, below
        # _DEAD_KEY_BIT
        first8 = jnp.minimum(first, 255)
        second8 = jnp.minimum(second, 255)
        cnt = jnp.minimum(hit.sum(axis=1), 63)
        return ((first8 << 14) | (second8 << 6) | cnt).astype(jnp.int32)

    lo = cb[:, 0:3].min(axis=0)
    hi = cb[:, 3:6].max(axis=0)
    q = jnp.clip((ray_o - lo) / jnp.maximum(hi - lo, 1e-6), 0.0, 0.999)
    cell = (q * 16.0).astype(jnp.int32)  # 4 bits per axis
    dq = jnp.clip(((ray_d + 1.0) * 2.0), 0.0, 3.999).astype(jnp.int32)
    dirk = (dq[:, 0] * 4 + dq[:, 1]) * 4 + dq[:, 2]  # 6 bits

    def spread(v):  # 4 bits -> every 3rd bit
        v = (v | (v << 8)) & 0x0F00F
        v = (v | (v << 4)) & 0xC30C3
        v = (v | (v << 2)) & 0x249249
        return v

    morton = spread(cell[:, 0]) * 4 + spread(cell[:, 1]) * 2 + spread(cell[:, 2])
    return (dirk << 12) | morton


def test_occlusion_sorted(ds: DeviceScene, x, y, mask=None):
    """Occlusion for divergent shadow wavefronts — same ray sorting as
    :func:`intersect_sorted`; the unpermute is one single-column sort.

    ``mask``: lanes marked False get a degenerate zero-length segment, sort
    to the back and report no occlusion."""
    if mask is not None:
        y = jnp.where(mask[..., None], y, x)
    if ds.cluster_bounds is None:
        return test_occlusion(ds, x, y)
    d = y - x
    # d is the unnormalized segment, so slab distances are in segment
    # fractions: tmax=1 bounds the signature at the light
    key = _sort_key(ds, x, d, tmax=jnp.ones(x.shape[0]))
    if mask is not None:
        key = key + jnp.where(mask, 0, _DEAD_KEY_BIT)
    n = x.shape[0]
    lane = jnp.arange(n, dtype=jnp.int32)
    s = jax.lax.sort(
        (key, lane, x[:, 0], x[:, 1], x[:, 2], y[:, 0], y[:, 1], y[:, 2]),
        num_keys=1,
    )
    occ = test_occlusion(ds, jnp.stack(s[2:5], axis=-1),
                         jnp.stack(s[5:8], axis=-1))
    # pack the 1-bit result into the lane key: (lane << 1) | occ sorts
    # identically to lane (lanes are distinct), so the inverse permutation
    # is a single-column sort instead of key + payload
    packed = (s[1] << 1) | occ.astype(jnp.int32)
    u = jax.lax.sort((packed,), num_keys=1)
    return (u[0] & 1).astype(jnp.bool_)


def test_occlusion(ds: DeviceScene, x, y):
    """True where segment x->y is blocked (testOcclusion, scene.h:303-334)."""
    if ds.intersector == "pallas_brute":
        from ..accel.brute_triton import occlusion_brute_triton

        return occlusion_brute_triton(ds.tri_packed, x, y)
    if ds.intersector == "bvh":
        return trv.occlusion_bvh(ds.leaf_tris, ds.leaf_map, ds.bvh_packed, x, y)
    return trv.occlusion_brute(ds.tri_packed, x, y)


def get_textured_material(ds: DeviceScene, mat_id, uv, norm):
    """Fetch material params with texture/normal maps applied
    (getTexturedMaterialAndSurface, scene.h:88-112).

    Returns (SurfaceMaterial, shading normal).

    All per-material scalars are fetched as ONE packed [M,11] row (gather
    cost is per row — utils/gather.py); for the typical handful of scene
    materials the fetch lowers to a branchless select chain.
    """
    mid = jnp.maximum(mat_id, 0)
    f32 = jnp.float32
    col = lambda a: a.astype(f32)[:, None]  # noqa: E731
    packed = jnp.concatenate(
        [
            col(ds.mat_type),
            ds.mat_base_color,
            col(ds.mat_metallic),
            col(ds.mat_roughness),
            col(ds.mat_ior),
            col(ds.mat_color_map),
            col(ds.mat_normal_map),
            col(ds.mat_metallic_map),
            col(ds.mat_roughness_map),
        ],
        axis=1,
    )  # [M, 11]; int fields round-trip exactly through f32 (small values)
    row = take_rows(packed, mid)
    mtype = row[..., 0].astype(jnp.int32)
    base = row[..., 1:4]
    metallic = row[..., 4]
    roughness = row[..., 5]
    ior = row[..., 6]

    cmap = row[..., 7].astype(jnp.int32)
    use_tex = cmap > NULL_TEXTURE
    use_proc = cmap == PROCEDURAL_TEXTURE
    if ds.tex_offset.shape[0] > 0:
        tex_col = _texture_bilinear(ds, jnp.maximum(cmap, 0), uv)
    else:
        tex_col = base
    base = jnp.where(use_proc[..., None], procedural_texture(uv), jnp.where(use_tex[..., None], tex_col, base))

    if ds.tex_offset.shape[0] > 0:
        mmap = row[..., 9].astype(jnp.int32)
        metallic = jnp.where(
            mmap > NULL_TEXTURE,
            _texture_bilinear(ds, jnp.maximum(mmap, 0), uv)[..., 0],
            metallic,
        )
        rmap = row[..., 10].astype(jnp.int32)
        roughness = jnp.where(
            rmap > NULL_TEXTURE,
            _texture_bilinear(ds, jnp.maximum(rmap, 0), uv)[..., 0],
            roughness,
        )
        nmap = row[..., 8].astype(jnp.int32)
        mapped = _texture_bilinear(ds, jnp.maximum(nmap, 0), uv)
        local_n = m.normalize(mapped - 0.5)
        norm = jnp.where(
            (nmap > NULL_TEXTURE)[..., None], m.local_to_world(norm, local_n), norm
        )

    return (
        SurfaceMaterial(
            mtype=mtype, base_color=base, metallic=metallic,
            roughness=roughness, ior=ior,
        ),
        norm,
    )


# ---------------------------------------------------------------------------
# environment map
# ---------------------------------------------------------------------------


def env_radiance(ds: DeviceScene, dir):
    """Env-map radiance for a direction (equirect; pathtrace.cu:233-236)."""
    if not ds.has_env:
        return jnp.zeros(dir.shape[:-1] + (3,), jnp.float32)
    uv = m.to_plane(dir)
    tex_id = jnp.full(dir.shape[:-1], ds.env_tex, jnp.int32)
    return _texture_bilinear(ds, tex_id, uv)


def env_map_pdf(ds: DeviceScene, wi):
    """Solid-angle pdf of the env-map light sampler in direction wi.

    Consistent formula lum * W * H / (sumPower * 2 pi^2) — the reference uses
    this in ``sampleEnvironmentMap`` (scene.h:397-398) but drops the 1/pi^2 in
    ``environmentMapPdf`` (scene.h:374-378); we use the consistent one for
    both NEE and MIS.
    """
    rad = env_radiance(ds, wi)
    w = ds.tex_width[ds.env_tex].astype(jnp.float32)
    h = ds.tex_height[ds.env_tex].astype(jnp.float32)
    return (
        m.luminance(rad) * ds.sum_light_power_inv * w * h * (m.INV_PI * m.INV_PI) * 0.5
    )


def _sample_env_map(ds: DeviceScene, r2):
    """Alias-sample the env map; returns (radiance, wi, pdf_solid_angle)
    (sampleEnvMapNoVisbility, scene.h:401-414)."""
    pix = alias_sample(ds.env_alias_prob, ds.env_alias_idx, r2[..., 0], r2[..., 1])
    w = ds.tex_width[ds.env_tex]
    h = ds.tex_height[ds.env_tex]
    y = pix // w
    x = pix - y * w
    radiance = ds.tex_data[ds.tex_offset[ds.env_tex] + pix]
    uv = jnp.stack(
        [
            (x.astype(jnp.float32) + 0.5) / w.astype(jnp.float32),
            (y.astype(jnp.float32) + 0.5) / h.astype(jnp.float32),
        ],
        axis=-1,
    )
    wi = m.to_sphere(uv)
    pdf = (
        m.luminance(radiance)
        * ds.sum_light_power_inv
        * w.astype(jnp.float32)
        * h.astype(jnp.float32)
        * (m.INV_PI * m.INV_PI)
        * 0.5
    )
    return radiance, wi, pdf


# ---------------------------------------------------------------------------
# direct-light sampling
# ---------------------------------------------------------------------------


def sample_direct_light_no_vis(ds: DeviceScene, pos, r4):
    """One light sample per lane WITHOUT visibility — counterpart of
    ``sampleDirectLightNoVisibility`` (scene.h:458-492).

    Returns (radiance [N,3], wi [N,3], dist [N], pdf [N]).  pdf <= 0 marks an
    invalid sample (INVALID_PDF).  The area-light pdf uses the consistent
    power-proportional form: pdf_area = lum * 2pi / sumPower (constant across
    prims of equal radiance because power is proportional to area) — see the
    module docstring for the reference deviation note.
    """
    n_lanes = pos.shape[0]
    zero3 = jnp.zeros((n_lanes, 3), jnp.float32)
    if not ds.has_lights:
        return zero3, zero3, jnp.zeros(n_lanes), jnp.full(n_lanes, INVALID_PDF)

    light_id = alias_sample(
        ds.light_alias_prob, ds.light_alias_idx, r4[..., 0], r4[..., 1]
    )
    num_area = ds.n_area_lights

    # --- area light branch ---
    if num_area > 0:
        lid = jnp.clip(light_id, 0, num_area - 1)
        # one packed [L,12] row per lane (vertices + radiance); select chain
        # for the typical few-light scene (utils/gather.py)
        ltable = jnp.concatenate(
            [
                ds.tri_v[ds.light_prim_ids].reshape(-1, 9),
                ds.light_radiance,
            ],
            axis=1,
        )
        lrow = take_rows(ltable, lid)
        v0, v1, v2 = lrow[..., 0:3], lrow[..., 3:6], lrow[..., 6:9]
        sampled = m.sample_triangle_uniform(v0, v1, v2, r4[..., 2], r4[..., 3])
        normal = m.triangle_normal(v0, v1, v2)
        radiance = lrow[..., 9:12]
        to_sampled = sampled - pos
        dist = m.length(to_sampled)
        wi = to_sampled / jnp.maximum(dist, 1e-12)[..., None]
        pdf_area = m.luminance(radiance) * (2.0 * m.PI) * ds.sum_light_power_inv
        pdf = m.pdf_area_to_solid_angle(pdf_area, pos, sampled, normal)
        if ds.single_sided:
            # emits into the half-space of its geometric normal
            facing = m.dot(normal, -wi) > 1e-6
            pdf = jnp.where(facing, pdf, INVALID_PDF)
    else:
        radiance, wi = zero3, zero3
        dist = jnp.zeros(n_lanes)
        pdf = jnp.full(n_lanes, INVALID_PDF)

    # --- env branch (last sampler slot, scene.h:426-427) ---
    if ds.has_env:
        env_rad, env_wi, env_pdf = _sample_env_map(
            ds, jnp.stack([r4[..., 2], r4[..., 3]], axis=-1)
        )
        is_env = light_id == num_area
        radiance = jnp.where(is_env[..., None], env_rad, radiance)
        wi = jnp.where(is_env[..., None], env_wi, wi)
        dist = jnp.where(is_env, 1e6, dist)
        pdf = jnp.where(is_env, env_pdf, pdf)

    return radiance, wi, dist, pdf


def sample_direct_light(ds: DeviceScene, pos, r4, mask=None, sort=True,
                        shade_normal=None):
    """Light sample WITH a shadow test (sampleDirectLight, scene.h:419-456).
    Returns (radiance, wi, pdf); pdf <= 0 when invalid or occluded.

    ``mask``: lanes that cannot use the sample anyway (dead paths, delta
    BSDFs) skip the shadow sweep via degenerate (zero-length) segments.
    ``sort=False`` skips the shadow-ray signature sort — pass it when the
    caller's lanes are already coherently ordered (permuted wavefront).
    ``shade_normal``: the (flipped) shading normal at ``pos``; lanes whose
    light sample lies at or below the horizon contribute exactly zero
    (every caller multiplies by sat_dot(normal, wi)), so they skip the
    shadow sweep too (after the signature sort, dead lanes pack together)."""
    radiance, wi, dist, pdf = sample_direct_light_no_vis(ds, pos, r4)
    ok = pdf > 0.0
    if mask is not None:
        ok = ok & mask
    if shade_normal is not None:
        ok = ok & (m.dot(shade_normal, wi) > 0.0)
    target = pos + wi * dist[..., None]
    if sort:
        occ = test_occlusion_sorted(ds, pos, target, mask=ok)
    else:
        safe_target = jnp.where(ok[..., None], target, pos)
        occ = test_occlusion(ds, pos, safe_target)
    pdf = jnp.where(ok & ~occ, pdf, INVALID_PDF)
    return radiance, wi, pdf


def area_light_hit_pdf(ds: DeviceScene, radiance, prev_pos, hit_pos, hit_norm):
    """Solid-angle pdf that NEE would have assigned to an emissive hit —
    used for the MIS weight on BSDF paths (pathtrace.cu:260-268), with the
    consistent pdf_area = lum * 2pi / sumPower."""
    pdf_area = m.luminance(radiance) * (2.0 * m.PI) * ds.sum_light_power_inv
    return m.pdf_area_to_solid_angle(pdf_area, prev_pos, hit_pos, hit_norm)


# ---------------------------------------------------------------------------
# host-side assembly helper
# ---------------------------------------------------------------------------


def pack_textures(images: list[np.ndarray]):
    """Concatenate [H,W,3] float images into one flat [P,3] atlas + meta."""
    if not images:
        return (
            np.zeros((1, 3), np.float32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
        )
    data = []
    offsets = []
    widths = []
    heights = []
    off = 0
    for img in images:
        h, w = img.shape[:2]
        data.append(img.reshape(-1, 3).astype(np.float32))
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        off += h * w
    return (
        np.concatenate(data, axis=0),
        np.asarray(offsets, np.int32),
        np.asarray(widths, np.int32),
        np.asarray(heights, np.int32),
    )
