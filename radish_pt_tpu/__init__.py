"""radish_pt_tpu — a physically based wavefront path-tracing framework in JAX.

Built from scratch in JAX/XLA with the capability set of the CUDA
reference renderer Radish_PT (see SURVEY.md).  Public API:

    from radish_pt_tpu import load_scene, Renderer
"""

__version__ = "0.1.0"

from .scene.build import load_scene  # noqa: F401
from .render.renderer import Renderer  # noqa: F401
