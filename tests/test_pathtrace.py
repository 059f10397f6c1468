"""Path-tracer integration tests on the Cornell box + furnace test."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radish_pt_tpu.render import pathtrace as pt


@pytest.fixture(scope="module")
def traced(cornell):
    ds, cam, _ = cornell
    f = jax.jit(pt.path_trace, static_argnames=("max_depth",))
    d, ind = f(ds, cam, 0, 3)
    return np.asarray(d), np.asarray(ind), cam


def test_renders_finite_nonzero(traced):
    d, ind, cam = traced
    img = d + ind
    assert np.isfinite(img).all()
    assert img.mean() > 0.05
    assert (img >= 0).all()


def test_light_pixels_bright(traced):
    d, ind, cam = traced
    img = (d + ind).reshape(cam.height, cam.width, 3)
    # ceiling light around image top-center; its radiance is 40
    top = img[: cam.height // 5, cam.width // 3 : 2 * cam.width // 3]
    assert top.max() > 10.0


def test_indirect_color_bleed(traced):
    """Indirect illumination exists and carries wall colors."""
    d, ind, cam = traced
    assert ind.mean() > 0.005
    # red and green channels differ spatially (bleed from colored walls)
    ind_img = ind.reshape(cam.height, cam.width, 3)
    left = ind_img[:, : cam.width // 4]
    right = ind_img[:, 3 * cam.width // 4 :]
    # right wall is green in scene space: ruv flip puts +X (green) at image
    # left pre-mirror; just require asymmetry between the halves
    assert abs(float(left[..., 0].mean() - right[..., 0].mean())) > 1e-4


@pytest.mark.slow
def test_accumulation_reduces_variance(cornell):
    ds, cam, _ = cornell
    f = jax.jit(pt.path_trace, static_argnames=("max_depth",))
    accum = jnp.zeros((cam.width * cam.height, 3))
    singles = []
    for i in range(4):
        d, ind = f(ds, cam, i, 2)
        img = pt.scrub_and_compress(d + ind)
        singles.append(np.asarray(img))
        accum = pt.accumulate(accum, img, i)
    accum = np.asarray(accum)
    np.testing.assert_allclose(accum, np.mean(singles, axis=0), atol=1e-5)


def test_direct_only_no_bleed(cornell):
    """path_trace_direct: single bounce — no indirect component at all."""
    ds, cam, _ = cornell
    d = np.asarray(jax.jit(pt.path_trace_direct)(ds, cam, 0))
    assert np.isfinite(d).all()
    assert d.mean() > 0.01


@pytest.mark.slow
def test_furnace_env_constant(cornell):
    """White furnace: constant env map, no lights, white Lambertian box ->
    every pixel converges to the env radiance (energy conservation of the
    full transport loop)."""
    ds, cam, _ = cornell
    n_env = 8
    env = np.full((n_env, n_env, 3), 0.5, np.float32)
    from radish_pt_tpu.sampling.alias import build_alias_table

    sin_t = np.sin((0.5 + np.arange(n_env)) / n_env * np.pi)
    tbl = build_alias_table((0.5 * 3 / 3 * np.ones((n_env, n_env)) * sin_t[:, None]).ravel())

    # single distant-ish white sphere? simplest: empty scene except env:
    # keep geometry but make all materials white Lambertian and remove lights
    white = jnp.broadcast_to(jnp.array([1.0, 1.0, 1.0]), ds.mat_base_color.shape)
    lam = jnp.zeros_like(ds.mat_type)
    ds2 = ds.replace(
        mat_base_color=white,
        mat_type=lam,
        n_area_lights=0,
        has_env=True,
        env_tex=0,
        tex_data=jnp.asarray(env.reshape(-1, 3)),
        tex_offset=jnp.array([0], jnp.int32),
        tex_width=jnp.array([n_env], jnp.int32),
        tex_height=jnp.array([n_env], jnp.int32),
        light_alias_prob=jnp.array([1.0]),
        light_alias_idx=jnp.array([0], jnp.int32),
        env_alias_prob=jnp.asarray(tbl.prob),
        env_alias_idx=jnp.asarray(tbl.alias),
        sum_light_power_inv=jnp.float32(1.0 / tbl.total),
    )
    f = jax.jit(pt.path_trace, static_argnames=("max_depth",))
    acc = 0.0
    frames = 10
    for i in range(frames):
        d, ind = f(ds2, cam, i, 32)
        acc = acc + np.asarray(d + ind)
    img = acc / frames
    # albedo-1.0 paths inside the box survive many bounces, so finite depth
    # truncates a geometric tail: measured 0.454 @ depth 16, 0.491 @ depth 32
    # (converging to 0.5 from below). depth 32 within 4% is the energy-
    # conservation check; a bias bug would overshoot or miss by far more.
    assert img.mean() == pytest.approx(0.5, rel=0.04), img.mean()


@pytest.mark.slow
def test_bvh_and_brute_render_identically(cornell):
    """Same cornell frame with use_bvh toggled — the full pipeline oracle."""
    ds, cam, _ = cornell
    f = jax.jit(pt.path_trace, static_argnames=("max_depth",))
    d0, i0 = f(ds.replace(intersector="brute"), cam, 3, 2)
    d1, i1 = f(ds.replace(intersector="bvh"), cam, 3, 2)
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=2e-3)
    np.testing.assert_allclose(np.asarray(i0), np.asarray(i1), atol=2e-3)


def test_sorted_primaries_render_identically():
    """Primary wavefronts through intersect_sorted (signature sort +
    unpermute) must be a no-op against the plain intersect, on a scene
    that has cull clusters: the same winners, and surfaces equal up to the
    compiler's float re-association (1e-6)."""
    import os

    from radish_pt_tpu.scene import camera as cam_mod
    from radish_pt_tpu.scene import device_scene as dsc
    from radish_pt_tpu.scene.build import load_scene

    scenes = os.path.join(os.path.dirname(__file__), "..", "scenes")
    ds, cam, _ = load_scene(os.path.join(scenes, "teapot.txt"))
    assert ds.cluster_bounds is not None
    cam = cam.replace(width=24, height=24)
    idx = jnp.arange(cam.width * cam.height, dtype=jnp.int32)
    o, d = cam_mod.pinhole_rays(cam, idx % cam.width, idx // cam.width)
    a = jax.jit(dsc.intersect)(ds, o, d)
    b = jax.jit(dsc.intersect_sorted)(ds, o, d)
    assert (np.asarray(a.prim_id) >= 0).any()
    np.testing.assert_array_equal(np.asarray(a.prim_id), np.asarray(b.prim_id))
    np.testing.assert_array_equal(np.asarray(a.mat_id), np.asarray(b.mat_id))
    for x, y in ((a.pos, b.pos), (a.norm, b.norm), (a.uv, b.uv)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


def test_debug_tracers_render(cornell):
    """BVH heatmap + G-buffer preview tracers (the reference GUI debug
    combos, preview.cpp:254-276) produce finite, non-constant images."""
    from radish_pt_tpu.config import Settings, Tracer
    from radish_pt_tpu.render.renderer import Renderer

    ds, cam, _ = cornell
    for tracer, view in [
        (Tracer.BVH_VISUALIZE, None),
        (Tracer.GBUFFER_PREVIEW, "albedo"),
        (Tracer.GBUFFER_PREVIEW, "normal"),
        (Tracer.GBUFFER_PREVIEW, "depth"),
        (Tracer.GBUFFER_PREVIEW, "motion"),
    ]:
        s = Settings(tracer=tracer)
        if view:
            s.gbuffer_view = view
        r = Renderer(ds=ds, cam=cam, desc=None, settings=s)
        img = r.step()
        assert img.shape == (cam.height, cam.width, 3)
        assert np.isfinite(img).all()
        if view != "motion":  # static camera: motion image may be uniform
            assert img.std() > 0  # structure, not a constant fill


def test_odd_resolution_renders(cornell):
    """Non-tile-aligned resolutions (not multiples of 128/1024 lanes) must
    render through padding on every path."""
    from radish_pt_tpu.config import Settings, Tracer
    from radish_pt_tpu.render.renderer import Renderer

    ds, cam, _ = cornell
    cam = cam.replace(width=37, height=29)
    for tracer in (Tracer.STREAMED, Tracer.RESTIR_DI, Tracer.DIRECT_LIGHT):
        r = Renderer(ds=ds, cam=cam, desc=None,
                     settings=Settings(tracer=tracer, trace_depth=2))
        img = r.step()
        assert img.shape == (29, 37, 3)
        assert np.isfinite(img).all()


@pytest.mark.slow
def test_compact_loop_matches_dense(monkeypatch):
    """The tiered compact bounce loop (wavefront compaction via the
    extension signature sort + lax.switch capacity tiers) must produce
    BITWISE-identical images to the dense masked loop: RNG stays in
    lockstep (shared scalar ptr; per-lane scramble rides the sorts) and
    per-lane accumulation order is unchanged."""
    import os

    from radish_pt_tpu.scene.build import load_scene

    scenes = os.path.join(os.path.dirname(__file__), "..", "scenes")
    ds, cam, _ = load_scene(os.path.join(scenes, "teapot.txt"))
    assert ds.cluster_bounds is not None  # compaction only engages with cull clusters
    cam = cam.replace(width=48, height=48)

    # separate jit instances: the env flag is read at TRACE time, so a
    # shared cache would silently reuse the first compilation
    monkeypatch.setenv("RADISH_COMPACT", "0")
    d0, i0 = jax.jit(pt.path_trace, static_argnames=("max_depth",))(
        ds, cam, 5, 3)
    # "a,b" = round-4 tiered loop; "m" = round-5 sliced loop (one global
    # compaction sort per bounce + dynamic slice count); nee_level=bounce
    # = sweep-only slices + one full-width shading pass per bounce
    for env, nee_level in (("4,1", "slice"), ("4", "slice"),
                           ("4", "bounce")):
        monkeypatch.setenv("RADISH_COMPACT", env)
        monkeypatch.setenv("RADISH_NEE_LEVEL", nee_level)
        d1, i1 = jax.jit(pt.path_trace, static_argnames=("max_depth",))(
            ds, cam, 5, 3)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))
