"""Wavefront sampler: scrambled Sobol + hash-RNG fallback.

Wavefront re-design of the reference sampler (``/root/reference/src/sampler.h:11-64``).
The reference's per-thread ``Sampler`` is a tiny struct {ptr, scramble, data*};
here the whole wavefront shares one scalar ``ptr`` (all lanes consume random
dimensions in lockstep) and carries a per-lane uint32 ``scramble`` that evolves
through the ``utilhash`` chain — a scalar table load + vector XOR per draw,
which is cheap elementwise work.

Keeping ``ptr`` scalar is exact: in the reference every pixel starts at
``iter * SobolSampleDim`` and advances once per draw; our masked-lane wavefront
executes draws in lockstep, so all lanes always share the same ptr.
"""

from __future__ import annotations

from ..utils import struct

import jax.numpy as jnp

from ..utils.math import utilhash
from .sobol import SOBOL_SAMPLE_DIM, SOBOL_SAMPLE_NUM


@struct.dataclass
class SamplerState:
    """Functional sampler state for a wavefront of lanes."""

    scramble: jnp.ndarray  # uint32 [N]
    ptr: jnp.ndarray  # int32 scalar — shared dimension pointer


def make_sampler(looper, pixel_index) -> SamplerState:
    """Counterpart of ``makeSeededRandomEngine`` (sampler.h:32-35):
    ptr = looper * SobolSampleDim, scramble = utilhash(pixel_index)."""
    return SamplerState(
        scramble=utilhash(jnp.asarray(pixel_index, dtype=jnp.uint32)),
        ptr=jnp.asarray(looper, dtype=jnp.int32) * SOBOL_SAMPLE_DIM,
    )


def sample_1d(table: jnp.ndarray, state: SamplerState):
    """Draw one dimension for all lanes; returns (r in [0,1), new state).

    Sobol mode (table is the flattened uint32 table): r = table[ptr] ^ scramble
    then scramble = utilhash(scramble), ptr += 1 — matching sampler.h:21-25.
    If ``table`` is None, falls back to a counter-based hash RNG.
    """
    if table is not None:
        ptr = jnp.clip(state.ptr, 0, SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM - 1)
        bits = table[ptr] ^ state.scramble
    else:
        bits = utilhash(state.scramble ^ (state.ptr.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)))
    r = bits.astype(jnp.float32) * jnp.float32(2.0**-32)
    new_state = SamplerState(scramble=utilhash(state.scramble), ptr=state.ptr + 1)
    return r, new_state


def sample_2d(table, state):
    r1, state = sample_1d(table, state)
    r2, state = sample_1d(table, state)
    return jnp.stack([r1, r2], axis=-1), state


def sample_3d(table, state):
    r12, state = sample_2d(table, state)
    r3, state = sample_1d(table, state)
    return jnp.concatenate([r12, r3[..., None]], axis=-1), state


def sample_4d(table, state):
    r123, state = sample_3d(table, state)
    r4, state = sample_1d(table, state)
    return jnp.concatenate([r123, r4[..., None]], axis=-1), state
