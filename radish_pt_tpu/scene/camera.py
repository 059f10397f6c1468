"""Thin-lens perspective camera.

JAX re-design of the reference ``Camera`` (``/root/reference/src/sceneStructs.h:21-131``).
The camera is an immutable pytree; ray generation and motion-vector
reprojection are pure, batched functions over pixel index arrays.

Unlike the reference revision — which hard-codes ``pAperture = vec2(0)``
(sceneStructs.h:58,81) leaving depth-of-field dormant — we wire the aperture
in: when ``lens_radius > 0`` the lens point is sampled from a concentric disk
or from the custom aperture-mask alias table (see render/pathtrace.py).
"""

from __future__ import annotations

import numpy as np
from ..utils import struct

import jax.numpy as jnp

from ..utils import math as m


@struct.dataclass
class Camera:
    # static metadata (shape-defining)
    width: int = struct.field(pytree_node=False, default=800)
    height: int = struct.field(pytree_node=False, default=800)

    # dynamic state
    position: jnp.ndarray = None  # [3]
    rotation: jnp.ndarray = None  # [3] yaw/pitch/roll degrees
    view: jnp.ndarray = None  # [3]
    up: jnp.ndarray = None  # [3]
    right: jnp.ndarray = None  # [3]
    fov_y: jnp.ndarray = None  # scalar, HALF vertical fov in degrees
    tan_fov_y: jnp.ndarray = None  # tan(radians(fov_y))
    lens_radius: jnp.ndarray = None  # scalar
    focal_dist: jnp.ndarray = None  # scalar

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def aspect(self):
        return self.width / self.height


def make_camera(
    width: int,
    height: int,
    position,
    rotation,
    fov_y: float = 45.0,
    lens_radius: float = 0.0,
    focal_dist: float = 1.0,
) -> Camera:
    cam = Camera(
        width=int(width),
        height=int(height),
        position=jnp.asarray(position, jnp.float32),
        rotation=jnp.asarray(rotation, jnp.float32),
        view=jnp.zeros(3, jnp.float32),
        up=jnp.zeros(3, jnp.float32),
        right=jnp.zeros(3, jnp.float32),
        fov_y=jnp.float32(fov_y),
        tan_fov_y=jnp.float32(np.tan(np.radians(fov_y))),
        lens_radius=jnp.float32(lens_radius),
        focal_dist=jnp.float32(focal_dist),
    )
    return update_camera(cam)


def update_camera(cam: Camera) -> Camera:
    """Recompute the view basis from yaw/pitch/roll — reference
    ``Camera::update`` (sceneStructs.h:93-107).  Pure jnp so it can run
    inside jit (e.g. camera animation)."""
    yaw = jnp.radians(cam.rotation[0])
    pitch = jnp.radians(cam.rotation[1])
    roll = jnp.radians(cam.rotation[2])
    view = jnp.stack(
        [
            jnp.cos(yaw) * jnp.cos(pitch),
            jnp.sin(pitch) * jnp.cos(roll),
            jnp.sin(yaw) * jnp.cos(pitch),
        ]
    )
    view = m.normalize(view)
    right = m.normalize(m.cross(view, jnp.array([0.0, 1.0, 0.0], jnp.float32)))
    up = m.normalize(m.cross(right, view))
    return cam.replace(
        view=view, up=up, right=right, tan_fov_y=jnp.tan(jnp.radians(cam.fov_y))
    )


def sample_rays(cam: Camera, x, y, r, p_aperture=None):
    """Generate one primary ray per lane — reference ``Camera::sample``
    (sceneStructs.h:72-91) with the aperture actually wired up.

    x, y: int arrays [N] of pixel coords; r: [N, 4] uniforms (r.xy = pixel
    jitter; r.zw reserved for the aperture when ``p_aperture`` is None).
    ``p_aperture``: optional [N, 2] points on the unit aperture (custom mask).
    Returns (origins [N, 3], directions [N, 3]).
    """
    aspect = jnp.float32(cam.aspect)
    pixel_size = 1.0 / jnp.array([cam.width, cam.height], jnp.float32)
    scr = jnp.stack([x, y], axis=-1).astype(jnp.float32) * pixel_size
    ruv = scr + pixel_size * r[..., 0:2]
    ruv = 1.0 - ruv * 2.0

    if p_aperture is None:
        p_aperture = m.concentric_sample_disk(r[..., 2], r[..., 3])
    p_lens = p_aperture * cam.lens_radius  # [N, 2]

    p_focus = (
        jnp.stack(
            [
                ruv[..., 0] * aspect * cam.tan_fov_y,
                ruv[..., 1] * cam.tan_fov_y,
                jnp.ones_like(ruv[..., 0]),
            ],
            axis=-1,
        )
        * cam.focal_dist
    )
    d_local = p_focus - jnp.concatenate(
        [p_lens, jnp.zeros_like(p_lens[..., :1])], axis=-1
    )
    # world = mat3(right, up, view) * local  (columns are the basis vectors)
    d_world = (
        cam.right * d_local[..., 0:1]
        + cam.up * d_local[..., 1:2]
        + cam.view * d_local[..., 2:3]
    )
    directions = m.normalize(d_world)
    origins = cam.position + cam.right * p_lens[..., 0:1] + cam.up * p_lens[..., 1:2]
    origins = jnp.broadcast_to(origins, directions.shape)
    return origins, directions


def pinhole_rays(cam: Camera, x, y):
    """Center-of-pixel pinhole rays (no jitter, no lens) — used by the
    G-buffer pass (gBuffer.cu:11-26)."""
    r = jnp.full(x.shape + (4,), 0.5, jnp.float32)
    zero_ap = jnp.zeros(x.shape + (2,), jnp.float32)
    return sample_rays(cam, x, y, r, p_aperture=zero_ap)


def raster_uv(cam: Camera, pos):
    """Project world position into this camera's raster uv [0,1]^2 —
    reference ``Camera::getRasterUV`` (sceneStructs.h:22-43)."""
    dir = m.normalize(pos - cam.position)
    d = 1.0 / m.dot(dir, cam.view)
    p = dir * d[..., None]
    # rotationMatInv is the transpose of [right|up|view] (orthonormal)
    px = m.dot(p, cam.right)
    py = m.dot(p, cam.up)
    aspect = jnp.float32(cam.aspect)
    ndc_x = -(px / (aspect * cam.tan_fov_y))
    ndc_y = -(py / cam.tan_fov_y)
    return jnp.stack([ndc_x, ndc_y], axis=-1) * 0.5 + 0.5


def raster_coord(cam: Camera, pos):
    """Integer raster coords — reference ``getRasterCoord`` (sceneStructs.h:45-48).
    May be out of bounds; callers must range-check (gBuffer.cu:53-59)."""
    uv = raster_uv(cam, pos)
    res = jnp.array([cam.width, cam.height], jnp.float32)
    return jnp.floor(uv * res).astype(jnp.int32)
