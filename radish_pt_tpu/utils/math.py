"""Batched math library for the path tracer.

JAX re-design of the reference's header-only CUDA math library
(``/root/reference/src/mathUtil.h:29-207``).  Every function is a pure,
batched ``jnp`` function operating on arrays whose *last* axis holds the
vector components, so the same code vectorizes over a whole wavefront of
rays/pixels instead of one CUDA thread.

Host-side helpers (transform matrices) live at the bottom and use numpy.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
EPSILON = 1e-5

# ---------------------------------------------------------------------------
# small vector helpers (last-axis = xyz)
# ---------------------------------------------------------------------------


def dot(a, b):
    """Batched dot product over the last axis, keeps no dims."""
    return jnp.sum(a * b, axis=-1)


def vdot(a, b):
    """Batched dot product, keepdims for broadcasting against vec3s."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    return jnp.sqrt(jnp.maximum(jnp.sum(a * a, axis=-1), 0.0))


def normalize(a, eps: float = 1e-12):
    return a / jnp.maximum(length(a), eps)[..., None]


def sat_dot(a, b):
    """max(dot(a, b), 0) — reference ``Math::satDot`` (mathUtil.h:67)."""
    return jnp.maximum(dot(a, b), 0.0)


def abs_dot(a, b):
    """|dot(a, b)| — reference ``Math::absDot`` (mathUtil.h:71)."""
    return jnp.abs(dot(a, b))


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def square(x):
    return x * x


def ceil_div(x: int, y: int) -> int:
    return (x + y - 1) // y


# ---------------------------------------------------------------------------
# MIS heuristics (mathUtil.h:81-88)
# ---------------------------------------------------------------------------


def power_heuristic(f, g):
    f2 = f * f
    return f2 / (f2 + g * g)


def balance_heuristic(f, g):
    return f / (f + g)


# ---------------------------------------------------------------------------
# triangles (mathUtil.h:90-108)
# ---------------------------------------------------------------------------


def triangle_area(v0, v1, v2):
    return length(cross(v1 - v0, v2 - v0)) * 0.5


def triangle_normal(v0, v1, v2):
    return normalize(cross(v1 - v0, v2 - v0))


def sample_triangle_uniform(v0, v1, v2, ru, rv):
    """Uniform point on a triangle; matches reference's sqrt warp
    (mathUtil.h:100-108): u = 1-sqrt(rv), v = ru*sqrt(rv)."""
    r = jnp.sqrt(rv)
    u = 1.0 - r
    v = ru * r
    w = 1.0 - u - v
    return (v1 * u[..., None] + v2 * v[..., None] + v0 * w[..., None])


# ---------------------------------------------------------------------------
# tone mapping / color (mathUtil.h:110-130)
# ---------------------------------------------------------------------------


def _calc_filmic(c):
    return (c * (c * 0.22 + 0.03) + 0.002) / (c * (c * 0.22 + 0.3) + 0.06) - 1.0 / 30.0


def filmic(c):
    """Uncharted-style filmic curve (mathUtil.h:110-116)."""
    return _calc_filmic(c * 1.6) / _calc_filmic(jnp.float32(11.2))


def aces(c):
    """ACES approximation (mathUtil.h:118-122)."""
    return (c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14)


def gamma_correction(c):
    return jnp.power(jnp.maximum(c, 0.0), 1.0 / 2.2)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def hdr_to_ldr(c):
    """Reinhard-style range compression c/(1+c) (mathUtil.h:49-51)."""
    return c / (c + 1.0)


def ldr_to_hdr(c):
    """Inverse of :func:`hdr_to_ldr`.

    NOTE: the reference's ``LDRToHDR`` (mathUtil.h:53-56) early-returns the
    input unchanged (dead code after ``return c /= 1.f``); we implement the
    mathematically correct inverse instead.
    """
    return c / jnp.maximum(1.0 - c, 1e-4)


# ---------------------------------------------------------------------------
# sampling warps (mathUtil.h:132-166)
# ---------------------------------------------------------------------------


def concentric_sample_disk(rx, ry):
    """Disk sample; reference uses the simple polar warp (mathUtil.h:132-136)."""
    r = jnp.sqrt(rx)
    theta = TWO_PI * ry
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def to_sphere(v):
    """Equirect [0,1]^2 -> unit direction (mathUtil.h:138-142).
    v[...,0]*2pi = azimuth, v[...,1]*pi = polar from +Y."""
    phi = v[..., 0] * TWO_PI
    theta = v[..., 1] * PI
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.cos(theta), jnp.sin(phi) * sin_t], axis=-1
    )


def to_plane(v):
    """Unit direction -> equirect uv in [0,1]^2 (mathUtil.h:144-147)."""
    u = jnp.mod(jnp.arctan2(v[..., 2], v[..., 0]) * INV_PI * 0.5 + 1.0, 1.0)
    w = jnp.arctan2(length(v[..., [0, 2]]), v[..., 1]) * INV_PI
    return jnp.stack([u, w], axis=-1)


def local_ref_matrix(n):
    """Orthonormal frame with n as +Z; returns (t, b, n) rows stacked on a new
    second-to-last axis: shape [..., 3, 3] where [..., i, :] is basis column i
    (t, b, n).  Mirrors mathUtil.h:149-155."""
    up = jnp.where(
        (jnp.abs(n[..., 1]) > 0.9999)[..., None],
        jnp.array([0.0, 0.0, 1.0], dtype=n.dtype),
        jnp.array([0.0, 1.0, 0.0], dtype=n.dtype),
    )
    b = normalize(cross(n, up))
    t = cross(b, n)
    return jnp.stack([t, b, n], axis=-2)


def local_to_world(n, v):
    """Transform local vec (z = n) to world and normalize (mathUtil.h:157-159)."""
    m = local_ref_matrix(n)
    return normalize(
        m[..., 0, :] * v[..., 0:1] + m[..., 1, :] * v[..., 1:2] + m[..., 2, :] * v[..., 2:3]
    )


def cosine_sample_hemisphere(n, rx, ry):
    d = concentric_sample_disk(rx, ry)
    z = jnp.sqrt(jnp.maximum(1.0 - jnp.sum(d * d, axis=-1), 0.0))
    v = jnp.concatenate([d, z[..., None]], axis=-1)
    return local_to_world(n, v)


def refract(n, wi, ior):
    """Batched refraction (mathUtil.h:168-186).

    Returns (wt, valid): refracted direction and a bool mask (False on TIR).
    ``ior`` is the material's eta, interpreted relative to which side ``wi``
    is on, exactly like the reference.
    """
    cos_in = dot(n, wi)
    eta = jnp.where(cos_in < 0.0, 1.0 / ior, ior)
    sin2_in = jnp.maximum(0.0, 1.0 - cos_in * cos_in)
    sin2_tr = sin2_in / (eta * eta)
    valid = sin2_tr < 1.0
    cos_tr = jnp.sqrt(jnp.maximum(1.0 - sin2_tr, 0.0))
    cos_tr = jnp.where(cos_in < 0.0, -cos_tr, cos_tr)
    wt = normalize(-wi / eta[..., None] + n * (cos_in / eta - cos_tr)[..., None])
    return wt, valid


def fresnel(cos_in, ior):
    """Exact unpolarized dielectric Fresnel (material.h:44-64).

    ``cos_in`` may be negative (ray inside the medium); handled like the
    reference by inverting ior.
    """
    eta = jnp.where(cos_in < 0.0, 1.0 / ior, ior)
    ci = jnp.abs(cos_in)
    sin_in = jnp.sqrt(jnp.maximum(1.0 - ci * ci, 0.0))
    sin_tr = sin_in / eta
    tir = sin_tr >= 1.0
    cos_tr = jnp.sqrt(jnp.maximum(1.0 - sin_tr * sin_tr, 0.0))
    r_par = (ci - eta * cos_tr) / (ci + eta * cos_tr)
    r_per = (eta * ci - cos_tr) / (eta * ci + cos_tr)
    f = (r_par * r_par + r_per * r_per) * 0.5
    return jnp.where(tir, 1.0, f)


def fresnel_schlick(l_dot_h, f0):
    """Schlick approximation; f0 may be scalar or vec3 (material.h:35-42)."""
    t = pow5(jnp.maximum(1.0 - l_dot_h, 0.0))
    f0 = jnp.asarray(f0)
    if f0.ndim > 0 and f0.shape[-1] == 3:
        t = t[..., None]
    return f0 + (1.0 - f0) * t


def pdf_area_to_solid_angle(pdf, x, y, ny):
    """Convert area-measure pdf at point y (normal ny) seen from x into a
    solid-angle pdf (mathUtil.h:188-192)."""
    yx = x - y
    dist2 = jnp.sum(yx * yx, axis=-1)
    return pdf * dist2 / jnp.maximum(abs_dot(ny, normalize(yx)), 1e-12)


# ---------------------------------------------------------------------------
# normal hemi-octahedral encoding (mathUtil.h:38-47)
# ---------------------------------------------------------------------------


def encode_normal_hemioct(n):
    denom = jnp.abs(n[..., 0]) + jnp.abs(n[..., 1]) + jnp.maximum(n[..., 2], 1e-12)
    p = n[..., :2] / denom[..., None]
    return jnp.stack([p[..., 0] + p[..., 1], p[..., 0] - p[..., 1]], axis=-1)


def decode_normal_hemioct(e):
    tx = (e[..., 0] + e[..., 1]) * 0.5
    ty = (e[..., 0] - e[..., 1]) * 0.5
    tz = 1.0 - jnp.abs(tx) - jnp.abs(ty)
    return normalize(jnp.stack([tx, ty, tz], axis=-1))


# ---------------------------------------------------------------------------
# integer hash (mathUtil.h:199-207) — uint32 arithmetic wraps naturally
# ---------------------------------------------------------------------------


def utilhash(a):
    """32-bit integer hash; used for per-pixel Sobol scrambling."""
    a = jnp.asarray(a, dtype=jnp.uint32)
    a = (a + jnp.uint32(0x7ED55D16)) + (a << 12)
    a = (a ^ jnp.uint32(0xC761C23C)) ^ (a >> 19)
    a = (a + jnp.uint32(0x165667B1)) + (a << 5)
    a = (a + jnp.uint32(0xD3A2646C)) ^ (a << 9)
    a = (a + jnp.uint32(0xFD7046C5)) + (a << 3)
    a = (a ^ jnp.uint32(0xB55A4F09)) ^ (a >> 16)
    return a


def utilhash_np(a: int) -> int:
    """Host-side counterpart of :func:`utilhash`."""
    M = 0xFFFFFFFF
    a &= M
    a = ((a + 0x7ED55D16) + (a << 12)) & M
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & M
    a = ((a + 0x165667B1) + (a << 5)) & M
    a = ((a + 0xD3A2646C) ^ (a << 9)) & M
    a = ((a + 0xFD7046C5) + (a << 3)) & M
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & M
    return a


# ---------------------------------------------------------------------------
# host-side transform builder (mathUtil.cpp:12-25)
# ---------------------------------------------------------------------------


def build_transformation_matrix(
    translation, rotation_deg, scale
) -> np.ndarray:
    """4x4 TRS matrix: T * Rx * Ry * Rz * S, rotations in degrees (matches
    glm::rotate order in reference mathUtil.cpp:12-25)."""
    t = np.asarray(translation, dtype=np.float64)
    r = np.radians(np.asarray(rotation_deg, dtype=np.float64))
    s = np.asarray(scale, dtype=np.float64)

    def rot(axis, ang):
        c, si = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        if axis == 0:
            m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -si, si, c
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, si, -si, c
        else:
            m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -si, si, c
        return m

    T = np.eye(4)
    T[:3, 3] = t
    S = np.diag([s[0], s[1], s[2], 1.0])
    M = T @ rot(0, r[0]) @ rot(1, r[1]) @ rot(2, r[2]) @ S
    return M.astype(np.float32)
