"""Physically based BSDFs: Lambertian, GGX metallic-workflow, dielectric.

Wavefront re-design of the reference ``Material`` device methods
(``/root/reference/src/material.h:128-275``).  Instead of a per-thread switch,
every lane evaluates all lobes branch-free and the result is selected by the
material-type mask, with no divergent control flow.

Sampling follows the reference math:
* Lambertian — cosine hemisphere (material.h:141-147)
* MetallicWorkflow — GGX VNDF sampling (Heitz, JCGT 2018; material.h:99-126)
  with the metallic-dependent diffuse/specular lobe mix (material.h:215-233)
* Dielectric — exact Fresnel reflect/refract with 1/eta^2 radiance scaling
  (material.h:159-183)
"""

from __future__ import annotations

from ..utils import struct

import jax.numpy as jnp

from ..scene.device_scene import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METALLIC_WORKFLOW,
    SurfaceMaterial,
)
from ..utils import math as m

# BSDF sample type flags (material.h:18-26)
DIFFUSE = 1 << 0
GLOSSY = 1 << 1
SPECULAR = 1 << 2
REFLECTION = 1 << 4
TRANSMISSION = 1 << 5
INVALID = 1 << 15


@struct.dataclass
class BSDFSample:
    dir: jnp.ndarray  # [N, 3]
    bsdf: jnp.ndarray  # [N, 3]
    pdf: jnp.ndarray  # [N]
    type: jnp.ndarray  # [N] int32 flag bits


def is_delta(sample_type) -> jnp.ndarray:
    return (sample_type & SPECULAR) != 0


def is_invalid(sample_type) -> jnp.ndarray:
    return (sample_type & INVALID) != 0


# ---------------------------------------------------------------------------
# GGX microfacet pieces (material.h:68-126)
# ---------------------------------------------------------------------------


def schlick_g(cos_theta, alpha):
    a = alpha * 0.5
    return cos_theta / (cos_theta * (1.0 - a) + a)


def smith_g(cos_wo, cos_wi, alpha):
    return schlick_g(jnp.abs(cos_wo), alpha) * schlick_g(jnp.abs(cos_wi), alpha)


def ggx_distribution(cos_theta, alpha):
    alpha2 = alpha * alpha
    denom = (cos_theta * cos_theta) * (alpha2 - 1.0) + 1.0
    d = alpha2 / jnp.maximum(denom * denom * m.PI, 1e-12)
    return jnp.where(cos_theta < 1e-6, 0.0, d)


def ggx_pdf(n, mvec, wo, alpha):
    return (
        ggx_distribution(m.dot(n, mvec), alpha)
        * schlick_g(m.dot(n, wo), alpha)
        * m.abs_dot(mvec, wo)
        / jnp.maximum(m.abs_dot(n, wo), 1e-12)
    )


def ggx_sample_vndf(n, wo, alpha, r2):
    """Sample the GGX visible-normal distribution (material.h:106-126)."""
    frame = m.local_ref_matrix(n)  # [..., 3(basis), 3]
    t_axis, b_axis, n_axis = frame[..., 0, :], frame[..., 1, :], frame[..., 2, :]
    wo_local = jnp.stack(
        [m.dot(wo, t_axis), m.dot(wo, b_axis), m.dot(wo, n_axis)], axis=-1
    )
    vh = m.normalize(wo_local * jnp.stack(
        [alpha, alpha, jnp.ones_like(alpha)], axis=-1
    ))
    len_sq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(len_sq, 1e-24))
    t1 = jnp.where(
        (len_sq > 0.0)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(len_sq)], axis=-1)
        * inv_len[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32), vh.shape),
    )
    t2 = jnp.cross(vh, t1)

    p = m.concentric_sample_disk(r2[..., 0], r2[..., 1])
    s = 0.5 * (vh[..., 2] + 1.0)
    py = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p[..., 0] ** 2, 0.0)) + s * p[..., 1]
    px = p[..., 0]
    pz = jnp.sqrt(jnp.maximum(1.0 - px * px - py * py, 0.0))
    h = t1 * px[..., None] + t2 * py[..., None] + vh * pz[..., None]
    h = jnp.stack(
        [h[..., 0] * alpha, h[..., 1] * alpha, jnp.maximum(h[..., 2], 0.0)], axis=-1
    )
    h_world = (
        t_axis * h[..., 0:1] + b_axis * h[..., 1:2] + n_axis * h[..., 2:3]
    )
    return m.normalize(h_world)


# ---------------------------------------------------------------------------
# per-lobe eval / pdf
# ---------------------------------------------------------------------------


def _lambertian_eval(mat: SurfaceMaterial, n, wo, wi):
    return mat.base_color * m.INV_PI


def _lambertian_pdf(mat, n, wo, wi):
    return m.sat_dot(n, wi) * m.INV_PI


def _metallic_eval(mat: SurfaceMaterial, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = m.normalize(wo + wi)
    cos_o = m.dot(n, wo)
    cos_i = m.dot(n, wi)
    f0 = 0.08 + (mat.base_color - 0.08) * mat.metallic[..., None]
    f = m.fresnel_schlick(m.dot(h, wo), f0)
    d = ggx_distribution(m.dot(n, h), alpha)
    g = smith_g(cos_o, cos_i, alpha)
    diffuse = mat.base_color * m.INV_PI * (1.0 - mat.metallic)[..., None]
    spec = (g * d / jnp.maximum(4.0 * cos_i * cos_o, 1e-12))[..., None]
    out = diffuse * (1.0 - f) + spec * f
    return jnp.where((cos_i * cos_o < 1e-7)[..., None], 0.0, out)


def _metallic_pdf(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = m.normalize(wo + wi)
    spec_w = 1.0 / (2.0 - mat.metallic)
    diff_pdf = m.sat_dot(n, wi) * m.INV_PI
    spec_pdf = ggx_pdf(n, h, wo, alpha) / jnp.maximum(4.0 * m.abs_dot(h, wo), 1e-12)
    return diff_pdf * (1.0 - spec_w) + spec_pdf * spec_w


def bsdf_eval(mat: SurfaceMaterial, n, wo, wi, types=None):
    """f(wo, wi) — Material::BSDF (material.h:235-246).  Dielectric and Light
    contribute zero (delta / emissive).

    ``types``: static tuple of material types present in the scene
    (DeviceScene.mat_types) — lobes of absent types are not computed.  The
    vectorized dispatch evaluates every lobe and selects, so a
    Lambertian-only scene otherwise pays the full GGX chain per lane (the
    RIS-32 candidate loop evaluates this 32x per pixel)."""
    t = mat.mtype[..., None]
    out = jnp.zeros_like(mat.base_color)
    if types is None or MAT_METALLIC_WORKFLOW in types:
        out = jnp.where(
            t == MAT_METALLIC_WORKFLOW, _metallic_eval(mat, n, wo, wi), out
        )
    if types is None or MAT_LAMBERTIAN in types:
        out = jnp.where(
            t == MAT_LAMBERTIAN, _lambertian_eval(mat, n, wo, wi), out
        )
    return out


def bsdf_pdf(mat: SurfaceMaterial, n, wo, wi, types=None):
    """pdf(wo, wi) — Material::pdf (material.h:248-258)."""
    t = mat.mtype
    out = jnp.zeros_like(mat.roughness)
    if types is None or MAT_METALLIC_WORKFLOW in types:
        out = jnp.where(
            t == MAT_METALLIC_WORKFLOW, _metallic_pdf(mat, n, wo, wi), out
        )
    if types is None or MAT_LAMBERTIAN in types:
        out = jnp.where(
            t == MAT_LAMBERTIAN, _lambertian_pdf(mat, n, wo, wi), out
        )
    return out


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def bsdf_sample(mat: SurfaceMaterial, n, wo, r3, types=None) -> BSDFSample:
    """Sample an outgoing direction for every lane — Material::sample
    (material.h:260-275).  r3: [N, 3] uniforms.  ``types``: static tuple of
    material types present (lobes of absent types are not computed)."""
    t = mat.mtype
    has = lambda ty: types is None or ty in types  # noqa: E731

    out = BSDFSample(
        dir=jnp.zeros_like(n),
        bsdf=jnp.zeros_like(n),
        pdf=jnp.zeros(n.shape[:-1], n.dtype),
        type=jnp.full(n.shape[:-1], INVALID, jnp.int32),
    )

    def overlay(out, cond, s):
        c3 = cond[..., None]
        return BSDFSample(
            dir=jnp.where(c3, s.dir, out.dir),
            bsdf=jnp.where(c3, s.bsdf, out.bsdf),
            pdf=jnp.where(cond, s.pdf, out.pdf),
            type=jnp.where(cond, s.type, out.type),
        )

    if has(MAT_LAMBERTIAN) or has(MAT_METALLIC_WORKFLOW):
        # the metallic diffuse lobe reuses the cosine-sampled direction
        lam_dir = m.cosine_sample_hemisphere(n, r3[..., 0], r3[..., 1])

    if has(MAT_LAMBERTIAN):
        lam = BSDFSample(
            dir=lam_dir,
            bsdf=mat.base_color * m.INV_PI,
            pdf=m.sat_dot(n, lam_dir) * m.INV_PI,
            type=jnp.full(n.shape[:-1], DIFFUSE | REFLECTION, jnp.int32),
        )
        out = overlay(out, t == MAT_LAMBERTIAN, lam)

    if has(MAT_METALLIC_WORKFLOW):
        alpha = mat.roughness * mat.roughness
        h = ggx_sample_vndf(n, wo, alpha, r3[..., 0:2])
        spec_dir = m.normalize(2.0 * m.vdot(h, wo) * h - wo)
        use_diffuse = r3[..., 2] > (1.0 / (2.0 - mat.metallic))
        met_dir = jnp.where(use_diffuse[..., None], lam_dir, spec_dir)
        met_bad = m.dot(n, met_dir) < 0.0
        met = BSDFSample(
            dir=met_dir,
            bsdf=_metallic_eval(mat, n, wo, met_dir),
            pdf=_metallic_pdf(mat, n, wo, met_dir),
            type=jnp.where(met_bad, INVALID, GLOSSY | REFLECTION).astype(
                jnp.int32
            ),
        )
        out = overlay(out, t == MAT_METALLIC_WORKFLOW, met)

    if has(MAT_DIELECTRIC):
        cos_wo = m.dot(n, wo)
        pdf_refl = m.fresnel(cos_wo, mat.ior)
        refl_dir = m.normalize(2.0 * cos_wo[..., None] * n - wo)
        refr_dir, refr_ok = m.refract(n, wo, mat.ior)
        choose_refl = r3[..., 2] < pdf_refl
        eta = jnp.where(cos_wo < 0.0, 1.0 / mat.ior, mat.ior)
        die_dir = jnp.where(choose_refl[..., None], refl_dir, refr_dir)
        die_bsdf = jnp.where(
            choose_refl[..., None],
            mat.base_color,
            mat.base_color / (eta * eta)[..., None],
        )
        die_invalid = (~choose_refl) & (~refr_ok)
        die_type = jnp.where(
            die_invalid,
            INVALID,
            jnp.where(
                choose_refl, SPECULAR | REFLECTION, SPECULAR | TRANSMISSION
            ),
        ).astype(jnp.int32)
        die = BSDFSample(
            dir=die_dir,
            bsdf=die_bsdf,
            pdf=jnp.ones_like(pdf_refl),
            type=die_type,
        )
        out = overlay(out, t == MAT_DIELECTRIC, die)

    return out
