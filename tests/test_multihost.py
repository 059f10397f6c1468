"""Multi-host (multi-process) rendering test: 2 CPU processes with Gloo
collectives stand in for a multi-host cluster (the standard JAX pattern).
The global-mesh sharded render must equal the single-device render."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_two_process_render_matches_single_device(tmp_path):
    out = str(tmp_path / "mh.npy")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH="",
    )
    args = [
        sys.executable, "tools/multihost_render.py", "scenes/cornell_box.txt",
        "--coordinator", "127.0.0.1:9931", "--num-processes", "2",
        "--res", "32", "32", "--spp", "3", "--depth", "3", "--out-npy", out,
    ]
    p1 = subprocess.Popen(
        args + ["--process-id", "1"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    p0 = subprocess.run(
        args + ["--process-id", "0"], cwd=REPO, env=env,
        capture_output=True, timeout=500,
    )
    p1.wait(timeout=60)
    assert p0.returncode == 0, p0.stderr.decode()[-2000:]
    assert p1.returncode == 0

    import jax
    import jax.numpy as jnp
    from functools import partial

    from radish_pt_tpu.render import pathtrace as pt
    from radish_pt_tpu.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(REPO, "scenes", "cornell_box.txt"))
    cam = cam.replace(width=32, height=32)
    acc = jnp.zeros((32 * 32, 3))
    for i in range(3):
        d, ind = jax.jit(partial(pt.path_trace, max_depth=3))(ds, cam, i)
        acc = pt.accumulate(acc, pt.scrub_and_compress(d + ind), i)
    ref = np.asarray(acc).reshape(32, 32, 3)

    mh = np.load(out)
    np.testing.assert_allclose(mh, ref, atol=1e-6)
