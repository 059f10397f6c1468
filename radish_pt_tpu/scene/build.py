"""Host-side scene build: flatten instances, extract lights, build alias
tables + BVH, and assemble the :class:`DeviceScene` pytree.

Counterpart of ``Scene::buildDevData`` + ``DevScene::create``
(``/root/reference/src/scene.cpp:190-249,461-551``) — but producing SoA jnp
arrays instead of cudaMemcpy'd pointers.
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from ..accel.bvh import build_bvh
from ..accel.traverse import pack_bvh, pack_tris
from ..sampling.alias import build_alias_table
from ..sampling.sobol import load_sobol_table
from ..utils.math import luminance
from .camera import Camera, make_camera
from .device_scene import MAT_LIGHT, NULL_TEXTURE, DeviceScene, pack_textures
from .parser import SceneDesc

# At or below this triangle count the dense all-pairs sweep replaces the tree
# walk; the crossover has not been measured on the GPU (ROADMAP Speed 3).
BRUTE_FORCE_MAX_TRIS = 128

# triangles per leaf-order culling cluster (the signature sort key's unit)
CLUSTER_SUB = 64

# intersection engines a scene can run (``--intersector`` /
# ``RADISH_INTERSECTOR``): the lockstep MTBVH walk, the XLA dense sweep, and
# the dense sweep as a Pallas-Triton kernel (GPU only)
INTERSECTORS = ("bvh", "brute", "pallas_brute")


def select_intersector(num_tris: int, requested: str | None = None) -> str:
    """The engine for a scene of ``num_tris`` triangles: ``requested`` (or
    ``RADISH_INTERSECTOR``) when given, else the dense sweep up to
    :data:`BRUTE_FORCE_MAX_TRIS` — the Triton kernel on a GPU, where it
    renders the frame faster than the XLA sweep (PERF.md), the XLA sweep
    elsewhere — and ``bvh`` above.  An unknown name raises, and so does
    ``pallas_brute`` without a GPU."""
    import jax

    gpu = jax.default_backend() == "gpu"
    if requested is None:
        requested = os.environ.get("RADISH_INTERSECTOR", "")
    if not requested:
        if num_tris > BRUTE_FORCE_MAX_TRIS:
            return "bvh"
        return "pallas_brute" if gpu else "brute"
    if requested not in INTERSECTORS:
        raise ValueError(
            f"unknown intersector {requested!r}; choose one of "
            f"{', '.join(INTERSECTORS)}"
        )
    if requested == "pallas_brute" and not gpu:
        raise ValueError("intersector 'pallas_brute' is a GPU kernel; the "
                         f"{jax.default_backend()} backend runs 'brute'")
    return requested


def _luminance_np(c: np.ndarray) -> np.ndarray:
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _cluster_cuts(pmin: np.ndarray, pmax: np.ndarray, sub: int = 64,
                  lam_frac: float | None = None,
                  chunk: int = 4096) -> np.ndarray:
    """Area-optimal segmentation of the leaf-ordered triangles into culling
    clusters of <= ``sub`` triangles.

    Minimizes  sum_segments(AABB surface area)  +  lambda * n_segments
    by windowed dynamic programming: a segment ending at triangle i may
    start at most ``sub`` back, and A_k[k, i] (the area of segment
    (i-k..i)) is built by running min/max.  lambda = lam_frac * scene box
    area trades cluster tightness against slot padding (each segment
    occupies a full ``sub``-slot block in the padded layout) and prepass
    width.  The DP runs exactly per ``chunk`` (cuts forced at chunk
    boundaries, negligible at 4k tris) and is vectorized ACROSS chunks so
    scene load stays sub-second at 100k+ triangles.

    Returns the cut positions, int64 [n_segments + 1] with cuts[0] == 0 and
    cuts[-1] == T.
    """
    # measured (tools-probe, 256^2 wavefronts): teapot flags/ray 0.62-0.65x
    # at 0.02, hires 0.67-0.68x at 0.005 with ~zero extra clusters; 0.005
    # is on the flat part of both curves
    if lam_frac is None:
        lam_frac = float(os.environ.get("RADISH_CLUSTER_LAMBDA", "0.005"))
    T = pmin.shape[0]
    lam = lam_frac * _box_area(pmin.min(axis=0), pmax.max(axis=0))

    # the DP recurrence is sequential in i; the C++ twin runs it ~30x
    # faster than the python-dispatch-bound numpy loop (native/__init__.py)
    from ..native import native_cluster_cuts

    cuts_native = native_cluster_cuts(pmin, pmax, sub, lam, chunk)
    if cuts_native is not None:
        return cuts_native

    n_chunks = -(-T // chunk)
    T_pad = n_chunks * chunk
    # pad with copies of the last triangle: zero extra area, cut dropped
    pmin_p = np.concatenate([pmin, np.repeat(pmin[-1:], T_pad - T, axis=0)])
    pmax_p = np.concatenate([pmax, np.repeat(pmax[-1:], T_pad - T, axis=0)])

    # A_k[k, i] = area of (i-k .. i), window boxes by running min/max
    lo = pmin_p.copy()
    hi = pmax_p.copy()
    A_k = np.empty((sub, T_pad), np.float32)
    A_k[0] = _box_area(lo, hi)
    for k in range(1, sub):
        lo[k:] = np.minimum(lo[k:], pmin_p[:-k])
        hi[k:] = np.maximum(hi[k:], pmax_p[:-k])
        A_k[k] = _box_area(lo, hi)
    A_k = A_k.reshape(sub, n_chunks, chunk)

    ks = np.arange(sub)
    cost = np.zeros((n_chunks, chunk + 1), np.float32)
    back = np.zeros((n_chunks, chunk + 1), np.int32)
    for i in range(chunk):
        kmax = min(sub, i + 1)
        # segment (i-k .. i) within the chunk; candidates [n_chunks, kmax]
        c = cost[:, i - ks[:kmax]] + A_k[:kmax, :, i].T + lam
        b = np.argmin(c, axis=1)
        rows = np.arange(n_chunks)
        cost[:, i + 1] = c[rows, b]
        back[:, i + 1] = i - b  # segment start (within chunk)

    cuts = []
    for ci in range(n_chunks):
        base = ci * chunk
        i = chunk
        cc = []
        while i > 0:
            cc.append(base + i)
            i = back[ci, i]
        cuts.extend(cc[::-1])
    cuts = np.asarray([0] + cuts, np.int64)
    cuts = np.unique(np.minimum(cuts, T))  # drop padded-tail cut points
    return cuts


def _box_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 0] * d[..., 2])


def build_device_scene(
    scene: SceneDesc,
    use_sobol: bool = True,
    intersector: str | None = None,
) -> tuple[DeviceScene, Camera]:
    """Build the device scene pytree + camera from a parsed scene.
    ``intersector`` forces an engine (see :func:`select_intersector`)."""
    verts, norms, uvs, mat_ids = [], [], [], []
    light_prims, light_radiance, light_power = [], [], []

    prim_base = 0
    for inst in scene.instances:
        mesh = inst.mesh
        M = inst.transform
        nrm_mat = np.linalg.inv(M[:3, :3]).T

        v = mesh.vertices @ M[:3, :3].T + M[:3, 3]
        n = mesh.normals @ nrm_mat.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        verts.append(v.astype(np.float32))
        norms.append(n.astype(np.float32))
        uvs.append(mesh.texcoords.astype(np.float32))

        t = mesh.num_triangles
        mat_ids.append(np.full(t, inst.material_id, np.int32))

        mat = scene.materials[inst.material_id]
        if mat.mtype == MAT_LIGHT:
            # every light triangle is an emitter record (scene.cpp:204-219)
            tv = v.reshape(-1, 3, 3)
            area = (
                np.linalg.norm(
                    np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1
                )
                * 0.5
            )
            rad = np.asarray(mat.base_color, np.float32)
            power_unit = float(_luminance_np(rad)) * 2.0 * np.pi
            for k in range(t):
                light_prims.append(prim_base + k)
                light_radiance.append(rad)
                light_power.append(power_unit * float(area[k]))
        prim_base += t

    if prim_base == 0:
        raise ValueError("No mesh data loaded")

    tri_v = np.concatenate(verts).reshape(-1, 3, 3)
    tri_n = np.concatenate(norms).reshape(-1, 3, 3)
    tri_uv = np.concatenate(uvs).reshape(-1, 3, 2)
    material_ids = np.concatenate(mat_ids)

    # ---- light + env samplers (createLightSampler, scene.cpp:145-169) ----
    has_env = scene.env_tex_id != NULL_TEXTURE
    env_prob = np.ones(1, np.float32)
    env_alias = np.zeros(1, np.int32)
    light_weights = list(light_power)
    if has_env:
        env_img = scene.textures[scene.env_tex_id]
        h, w = env_img.shape[:2]
        sin_theta = np.sin((0.5 + np.arange(h)) / h * np.pi).astype(np.float32)
        env_pdf = _luminance_np(env_img) * sin_theta[:, None]
        env_table = build_alias_table(env_pdf.reshape(-1))
        env_prob, env_alias = env_table.prob, env_table.alias
        light_weights.append(env_table.total)

    n_area_lights = len(light_prims)
    if light_weights:
        light_table = build_alias_table(np.asarray(light_weights, np.float64))
        sum_power_inv = 1.0 / max(light_table.total, 1e-12)
        la_prob, la_idx = light_table.prob, light_table.alias
    else:
        sum_power_inv = 0.0
        la_prob = np.ones(1, np.float32)
        la_idx = np.zeros(1, np.int32)

    # ---- aperture sampler (createApertureSampler, scene.cpp:171-188) ----
    has_aperture = scene.aperture_tex_id != NULL_TEXTURE
    ap_prob = np.ones(1, np.float32)
    ap_idx = np.zeros(1, np.int32)
    if has_aperture:
        ap_img = scene.textures[scene.aperture_tex_id]
        ap_table = build_alias_table(_luminance_np(ap_img).reshape(-1))
        ap_prob, ap_idx = ap_table.prob, ap_table.alias

    # ---- BVH + intersector choice ----
    num_tris = tri_v.shape[0]
    intersector = select_intersector(num_tris, intersector)
    bvh = build_bvh(tri_v.reshape(-1, 3))

    # ---- global spatial permutation + culling clusters ----
    # The WHOLE scene is stored in BVH leaf (DFS) order: spatially close
    # triangles are contiguous, so consecutive runs make tight cluster
    # AABBs for the wavefront signature sort (device_scene._sort_key).
    lm = np.asarray(bvh.leaf_map)
    tri_order = lm[lm >= 0].astype(np.int32)
    assert tri_order.size == num_tris, "leaf_map must cover every triangle"
    inv_order = np.empty_like(tri_order)
    inv_order[tri_order] = np.arange(num_tris, dtype=np.int32)
    tri_v = tri_v[tri_order]
    tri_n = tri_n[tri_order]
    tri_uv = tri_uv[tri_order]
    material_ids = material_ids[tri_order]
    light_prims = [int(inv_order[p]) for p in light_prims]
    leaf_map = np.where(lm >= 0, inv_order[np.clip(lm, 0, None)], lm)

    cluster_bounds = None
    if num_tris > 1024:
        # ---- area-optimal cluster cuts ----
        # Fixed CLUSTER_SUB-sized cuts of the DFS order slice across subtree
        # boundaries, so some cluster AABBs span spatially distant geometry.
        # A windowed DP over the leaf order instead picks VARIABLE cut
        # points minimizing sum(cluster surface area) + lambda * count — the
        # expected number of clusters a ray crosses is proportional to total
        # cluster area.
        cuts = _cluster_cuts(
            tri_v.min(axis=1).astype(np.float32),
            tri_v.max(axis=1).astype(np.float32),
            sub=CLUSTER_SUB,
        )
        cluster_bounds = np.stack([
            np.concatenate([tri_v[a:b].reshape(-1, 3).min(axis=0),
                            tri_v[a:b].reshape(-1, 3).max(axis=0)])
            for a, b in zip(cuts[:-1], cuts[1:])
        ]).astype(np.float32)

    # ---- textures ----
    tex_data, tex_off, tex_w, tex_h = pack_textures(scene.textures)

    # ---- materials SoA ----
    from .parser import HostMaterial

    mats = scene.materials if scene.materials else [HostMaterial()]

    ds = DeviceScene(
        intersector=intersector,
        n_area_lights=n_area_lights,
        has_env=has_env,
        has_aperture=has_aperture,
        single_sided=scene.settings.scene_light_single_sided,
        tri_v=jnp.asarray(tri_v),
        tri_attr=jnp.asarray(
            np.concatenate(
                [
                    tri_v.reshape(-1, 9),
                    tri_n.reshape(-1, 9),
                    tri_uv.reshape(-1, 6),
                    # material id as f32 col 24 (exact to 2^24): the surface
                    # fetch then yields mat_id with NO second row gather
                    material_ids.reshape(-1, 1).astype(np.float32),
                ],
                axis=1,
            )
        ),
        material_ids=jnp.asarray(material_ids),
        bounds_min=jnp.asarray(bvh.bounds_min),
        bounds_max=jnp.asarray(bvh.bounds_max),
        bvh_packed=jnp.asarray(pack_bvh(bvh)),
        tri_packed=jnp.asarray(pack_tris(tri_v)),
        cluster_bounds=(
            jnp.asarray(cluster_bounds) if cluster_bounds is not None else None
        ),
        leaf_tris=jnp.asarray(bvh.leaf_tris),
        leaf_map=jnp.asarray(leaf_map),
        mat_type=jnp.asarray([m.mtype for m in mats], jnp.int32),
        mat_types=tuple(sorted({m.mtype for m in mats})),
        mat_base_color=jnp.asarray([m.base_color for m in mats], jnp.float32),
        mat_metallic=jnp.asarray([m.metallic for m in mats], jnp.float32),
        mat_roughness=jnp.asarray([m.roughness for m in mats], jnp.float32),
        mat_ior=jnp.asarray([m.ior for m in mats], jnp.float32),
        mat_color_map=jnp.asarray([m.color_map for m in mats], jnp.int32),
        mat_normal_map=jnp.asarray([m.normal_map for m in mats], jnp.int32),
        mat_metallic_map=jnp.asarray([m.metallic_map for m in mats], jnp.int32),
        mat_roughness_map=jnp.asarray([m.roughness_map for m in mats], jnp.int32),
        tex_data=jnp.asarray(tex_data),
        tex_offset=jnp.asarray(tex_off),
        tex_width=jnp.asarray(tex_w),
        tex_height=jnp.asarray(tex_h),
        env_tex=int(scene.env_tex_id),
        aperture_tex=int(scene.aperture_tex_id),
        light_prim_ids=jnp.asarray(
            np.asarray(light_prims, np.int32)
            if light_prims
            else np.zeros(1, np.int32)
        ),
        light_radiance=jnp.asarray(
            np.asarray(light_radiance, np.float32).reshape(-1, 3)
            if light_radiance
            else np.zeros((1, 3), np.float32)
        ),
        sum_light_power_inv=jnp.float32(sum_power_inv),
        light_alias_prob=jnp.asarray(la_prob),
        light_alias_idx=jnp.asarray(la_idx),
        env_alias_prob=jnp.asarray(env_prob),
        env_alias_idx=jnp.asarray(env_alias),
        aperture_alias_prob=jnp.asarray(ap_prob),
        aperture_alias_idx=jnp.asarray(ap_idx),
        sobol=jnp.asarray(load_sobol_table()) if use_sobol else None,
    )

    cam = make_camera(
        scene.width,
        scene.height,
        scene.cam_position,
        scene.cam_rotation,
        fov_y=scene.fov_y,
        lens_radius=scene.lens_radius,
        focal_dist=scene.focal_dist,
    )
    return ds, cam


def load_scene(path: str, **kwargs):
    """Parse + build in one call; returns (DeviceScene, Camera, SceneDesc)."""
    from .parser import parse_scene

    desc = parse_scene(path)
    ds, cam = build_device_scene(desc, use_sobol=desc.settings.use_sobol, **kwargs)
    return ds, cam, desc
