"""Runtime configuration — counterpart of the reference's compile-time
``#define``s + runtime ``Settings``/``State`` globals
(``/root/reference/src/common.h:5-72``, ``common.cpp:3-19``).

Instead of mutable globals, a plain dataclass threaded through the renderer;
fields that change kernel structure are static under ``jit`` (recompile on
change, like flipping a ``#define``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ToneMapping:
    NONE = 0
    FILMIC = 1
    ACES = 2


class Tracer:
    STREAMED = 0  # wavefront path tracer (full MIS)
    SINGLE_KERNEL = 1  # alias of STREAMED here (kept for API parity)
    BVH_VISUALIZE = 2
    GBUFFER_PREVIEW = 3
    RESTIR_DI = 4
    DIRECT_LIGHT = 5  # PTDirectKernel path (the reference demo-loop default)


class Denoiser:
    NONE = 0
    GAUSSIAN = 1
    EA_WAVELET = 2
    SVGF = 3


class ReservoirReuse:
    NONE = 0b00
    TEMPORAL = 0b01
    SPATIAL = 0b10
    TEMPORAL_SPATIAL = 0b11


@dataclass
class Settings:
    # render
    trace_depth: int = 5  # Settings::traceDepth
    tone_mapping: int = ToneMapping.ACES
    tracer: int = Tracer.STREAMED
    denoiser: int = Denoiser.NONE
    modulate: bool = False  # re-apply albedo after denoise
    accumulate: bool = True

    # ReSTIR
    use_reservoir: bool = False
    reservoir_reuse: int = ReservoirReuse.TEMPORAL_SPATIAL
    reservoir_size: int = 32  # RESERVOIR_SIZE (restir.h:9)
    temporal_clamp: int = 20  # preClampedMerge<20> (restir.cu:168)

    # sampling
    use_sobol: bool = True  # SAMPLER_USE_SOBOL (common.h:5)
    scene_light_single_sided: bool = True  # SCENE_LIGHT_SINGLE_SIDED

    # camera animation (Settings::animateCamera etc.)
    animate_camera: bool = False
    animate_radius: float = 2.0
    animate_speed: float = 1.0

    # denoiser detail
    denoiser_demodulate: bool = True  # DENOISER_DEMODULATE
    denoiser_split: bool = True  # DENOISER_SPLIT_DIRECT_INDIRECT (common.h:10)
    encode_normal: bool = False  # DENOISER_ENCODE_NORMAL (common.h:15)
    svgf_levels: int = 5
    # filter sigmas, live-tunable in the reference GUI (preview.cpp:261-267);
    # defaults match the reference creates: EAW 64/.2/1 (denoiser.cu:413),
    # SVGF 4/128/1 (denoiser.cu:438)
    eaw_sig_depth: float = 64.0
    eaw_sig_normal: float = 0.2
    eaw_sig_luminance: float = 1.0
    svgf_sig_depth: float = 4.0
    svgf_sig_normal: float = 128.0
    svgf_sig_luminance: float = 1.0

    # debug
    check_nans: bool = False
    gbuffer_view: str = "albedo"  # albedo | normal | depth | motion
    # denoiser AOV preview (reference Preview combo, preview.cpp:254-276):
    # composed | input_direct | input_indirect | output_direct |
    # output_indirect | direct_moment | indirect_moment | direct_variance |
    # indirect_variance
    preview_aov: str = "composed"


@dataclass
class RenderState:
    """Per-run mutable host state — reference ``RenderState`` + ``State``
    (sceneStructs.h:138-142, common.h:68-72)."""

    iterations: int = 64  # target spp ("Sample" in the scene file)
    image_name: str = "render"
    iteration: int = 0  # accumulated frames so far
    looper: int = 0  # sobol frame counter (wraps at SobolSampleNum)
    cam_changed: bool = False
