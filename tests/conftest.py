"""Test configuration: force CPU backend with 8 virtual devices (the standard
JAX pattern for testing multi-chip sharding without hardware — SURVEY.md §4)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from radish_pt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture(scope="session")
def cornell():
    """Cornell box at tiny resolution; session-cached (compiles are slow on
    the 1-core CI host)."""
    from radish_pt_tpu.scene.build import load_scene

    ds, cam, desc = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    cam = cam.replace(width=16, height=16)
    return ds, cam, desc


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(7)
