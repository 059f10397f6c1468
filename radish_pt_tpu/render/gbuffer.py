"""G-buffer pass: albedo / normal / matId / depth / motion reprojection.

Wavefront re-design of ``renderGBuffer`` (``/root/reference/src/gBuffer.cu:3-103``)
and the double-buffered ``GBuffer`` struct (gBuffer.h).  One primary-ray
wavefront writes SoA image-shaped arrays; double buffering is functional —
the renderer keeps (current, last) ``GBufferFrame`` pytrees and swaps the
references instead of flipping ``frameIdx``.

Like the reference we store the *material* id in the id channel (lights
remapped to ``NullPrimitive - 1``; gBuffer.cu:35-42) — the temporal/spatial
ReSTIR and SVGF neighbor tests compare these ids.
"""

from __future__ import annotations

from ..utils import struct

import jax.numpy as jnp

from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..utils import math as m

NULL_PRIMITIVE = -1
LIGHT_ID = NULL_PRIMITIVE - 1  # lights in the id channel (gBuffer.cu:36)


@struct.dataclass
class GBufferFrame:
    """One frame's geometry attributes (the double-buffered half).

    ``normal`` is either raw f32 [N, 3] or hemi-octahedral-encoded f32
    [N, 2] (``DENOISER_ENCODE_NORMAL``, gBuffer.h:7-13 / common.h:15) —
    consumers read through :func:`decoded_normal`, which dispatches on the
    static trailing dim."""

    normal: jnp.ndarray  # f32 [N, 3] raw or [N, 2] hemi-oct encoded
    prim_id: jnp.ndarray  # i32 [N] — material id, lights remapped
    depth: jnp.ndarray  # f32 [N] — DENOISER_ENCODE_POSITION layout


@struct.dataclass
class GBufferOut:
    frame: GBufferFrame
    albedo: jnp.ndarray  # f32 [N, 3]
    motion: jnp.ndarray  # i32 [N] — flat pixel index into last frame, -1 invalid


def empty_frame(n: int, encode_normal: bool = False) -> GBufferFrame:
    return GBufferFrame(
        normal=jnp.zeros((n, 2 if encode_normal else 3), jnp.float32),
        prim_id=jnp.full((n,), NULL_PRIMITIVE, jnp.int32),
        depth=jnp.ones((n,), jnp.float32),
    )


def decoded_normal(frame: GBufferFrame) -> jnp.ndarray:
    """[N, 3] world normals regardless of the frame's storage encoding (the
    trailing dim is static, so this branch resolves at trace time)."""
    if frame.normal.shape[-1] == 2:
        return m.decode_normal_hemioct(frame.normal)
    return frame.normal


def camera_get_position(cam: cam_mod.Camera, x, y, dist):
    """Reconstruct the world position seen at pixel (x, y) at ray distance
    ``dist`` — reference ``Camera::getPosition`` (sceneStructs.h:50-67)."""
    ray_o, ray_d = cam_mod.pinhole_rays(cam, x, y)
    return ray_o + ray_d * dist[..., None]


def render_gbuffer(
    ds: dsc.DeviceScene,
    cam: cam_mod.Camera,
    last_cam: cam_mod.Camera,
    encode_normal: bool = False,
    pixel_idx=None,
    extra_motion_cam=None,
):
    """``pixel_idx`` (optional i32 [n_local] GLOBAL flat pixel indices) lets a
    shard_map caller render a row-shard of the G-buffer; motion stays a
    global index into the last frame.  With ``extra_motion_cam`` returns
    ``(GBufferOut, motion2)`` — a second motion field reprojected through
    that camera (same primary hits)."""
    if pixel_idx is None:
        idx = jnp.arange(cam.width * cam.height, dtype=jnp.int32)
    else:
        idx = pixel_idx
    x = idx % cam.width
    y = idx // cam.width

    ray_o, ray_d = cam_mod.pinhole_rays(cam, x, y)
    it = dsc.intersect(ds, ray_o, ray_d)
    hit = it.prim_id != NULL_PRIMITIVE

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    if ds.single_sided:
        # light backface counts as a miss (gBuffer.cu:37-41, consistent side)
        hit = hit & ~(is_light & (m.dot(norm, ray_d) >= 0.0))

    mat_id = jnp.where(is_light, LIGHT_ID, it.mat_id)

    env_albedo = dsc.env_radiance(ds, ray_d)
    albedo = jnp.where(hit[..., None], mat.base_color, env_albedo)
    if encode_normal:
        # DENOISER_ENCODE_NORMAL (gBuffer.h:7-13): store 2-component
        # hemi-oct; miss lanes encode +z (the encoder divides by the L1
        # norm, so a zero vector would produce NaN)
        safe = jnp.where(hit[..., None], norm, jnp.array([0.0, 0.0, 1.0]))
        normal = m.encode_normal_hemioct(safe)
    else:
        normal = jnp.where(hit[..., None], norm, 0.0)
    prim_id = jnp.where(hit, mat_id, NULL_PRIMITIVE)
    depth = jnp.where(hit, m.length(it.pos - ray_o), 1.0)

    # motion: reproject hit position through LAST frame's camera
    motion = _motion_index(cam, last_cam, it.pos, hit)

    out = GBufferOut(
        frame=GBufferFrame(normal=normal, prim_id=prim_id, depth=depth),
        albedo=albedo,
        motion=motion,
    )
    if extra_motion_cam is not None:
        # second motion field against another "last" camera — used by the
        # static-camera ReSTIR batch: frame 0 reprojects through the real
        # last_cam, frames k>0 through the batch's own (steady) camera
        return out, _motion_index(cam, extra_motion_cam, it.pos, hit)
    return out


def _motion_index(cam, last_cam, pos, hit):
    """Flat pixel index of ``pos`` in ``last_cam``'s raster (-1 off-screen,
    0 on miss) — gBuffer.cu:53-59."""
    last_pos = cam_mod.raster_coord(last_cam, pos)
    in_bounds = (
        (last_pos[..., 0] >= 0)
        & (last_pos[..., 0] < cam.width)
        & (last_pos[..., 1] >= 0)
        & (last_pos[..., 1] < cam.height)
    )
    return jnp.where(
        hit,
        jnp.where(in_bounds, last_pos[..., 1] * cam.width + last_pos[..., 0], -1),
        0,
    ).astype(jnp.int32)


def motion_debug_image(motion, width: int, height: int):
    """Visualize motion indices as rg-colors (sendImageToPBO int overload,
    pathtrace.cu:99-118)."""
    px = (motion % width).astype(jnp.float32) / width
    py = (motion // width).astype(jnp.float32) / height
    return jnp.stack([px, py, jnp.zeros_like(px)], axis=-1)
