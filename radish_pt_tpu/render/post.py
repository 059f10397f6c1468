"""Post-processing: tone mapping, gamma, albedo (de)modulation, display.

Counterpart of the reference's ``sendImageToPBO`` kernels
(``/root/reference/src/pathtrace.cu:32-118``) and the modulate/add helpers
(``denoiser.cu:175-206``).  All trivial fused elementwise ops under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ToneMapping
from ..utils import math as m


def tonemap(color, mode: int):
    """Static tonemap dispatch (pathtrace.cu:44-53)."""
    if mode == ToneMapping.FILMIC:
        return m.filmic(color)
    if mode == ToneMapping.ACES:
        return m.aces(color)
    return color


def to_display(color, tone_mapping: int = ToneMapping.NONE, scale: float = 1.0):
    """HDR image -> uint8 display buffer: scale, tonemap, gamma, quantize
    (sendImageToPBO, pathtrace.cu:32-59)."""
    c = tonemap(color * scale, tone_mapping)
    c = m.gamma_correction(c)
    return jnp.clip(c * 255.0, 0.0, 255.0).astype(jnp.uint8)


def modulate_albedo(img, albedo):
    """Re-apply albedo after demodulated denoising (denoiser.cu:175-185).
    The reference's LDRToHDR there is an identity; we apply the true inverse
    of the accumulation-time range compression."""
    return m.ldr_to_hdr(img) * jnp.maximum(albedo, 0.0)


def add_image(a, b):
    return a + b
