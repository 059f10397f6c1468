"""Persistent XLA compilation cache setup.

Caching compiled executables on disk makes every process after the first
start fast.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no directory; otherwise the cache lives at the fixed
path ``<checkout>/.jax_cache`` (git-ignored).  Called from the CLI, the
bench harness, ``chip_smoke.py`` and the test conftest.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
