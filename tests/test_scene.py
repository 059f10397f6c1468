"""Scene parsing, OBJ loading, HDR I/O, device-scene build, light sampling."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from radish_pt_tpu.scene import device_scene as dsc
from radish_pt_tpu.scene.obj_loader import load_obj

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_obj_loader_plane():
    mesh = load_obj(os.path.join(SCENES, "models", "plane.obj"))
    assert mesh.num_triangles == 2
    assert mesh.vertices.shape == (6, 3)
    np.testing.assert_allclose(mesh.normals, [[0, 1, 0]] * 6)
    # geometric winding gives +Y too
    v = mesh.vertices.reshape(-1, 3, 3)
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    assert (gn[:, 1] > 0).all()


def test_obj_loader_missing_normals(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 1
    np.testing.assert_allclose(mesh.normals, [[0, 0, 1]] * 3, atol=1e-6)
    np.testing.assert_allclose(mesh.texcoords, 0.0)


def test_obj_loader_quad_negative_indices(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n"
    )
    mesh = load_obj(str(p))
    assert mesh.num_triangles == 2  # fan triangulated


def test_parse_cornell(cornell):
    ds, cam, desc = cornell
    assert ds.num_triangles == 36
    assert ds.n_area_lights == 2
    assert not ds.has_env
    assert cam.width == 16
    assert desc.state.iterations == 64
    assert desc.settings.trace_depth == 5
    # light radiance recorded per prim
    np.testing.assert_allclose(np.asarray(ds.light_radiance), 40.0)


def test_light_sampler_unoccluded_pdf(cornell):
    """Light sampling from the box center: valid pdfs, direction toward the
    ceiling light, correct distance."""
    ds, cam, desc = cornell
    n = 256
    rng = np.random.default_rng(0)
    pos = jnp.broadcast_to(jnp.array([0.0, 5.0, 0.0], jnp.float32), (n, 3))
    r4 = jnp.asarray(rng.random((n, 4)), jnp.float32)
    li, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, pos, r4)
    li, wi, dist, pdf = map(np.asarray, (li, wi, dist, pdf))
    ok = pdf > 0
    assert ok.mean() > 0.9  # light faces down toward box center
    assert (wi[ok][:, 1] > 0.9).all()  # sample points are up at the ceiling
    # distance ~ 5 (y from 5 to ~9.98)
    np.testing.assert_allclose(dist[ok] * wi[ok][:, 1], 4.98, atol=0.05)
    np.testing.assert_allclose(li[ok], 40.0)


def test_light_sampler_single_sided(cornell):
    """From above the light plane (between light and ceiling) the light's
    back side must be rejected."""
    ds, cam, desc = cornell
    pos = jnp.broadcast_to(jnp.array([0.0, 9.99, 0.0], jnp.float32), (64, 3))
    rng = np.random.default_rng(1)
    r4 = jnp.asarray(rng.random((64, 4)), jnp.float32)
    li, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, pos, r4)
    assert (np.asarray(pdf) <= 0).all()


def test_occlusion_through_box(cornell):
    """The tall box occludes floor->light paths behind it."""
    ds, _, _ = cornell
    # from inside the tall box region to the light: blocked by the box top
    x = jnp.array([[-1.8, 0.01, -1.7]], jnp.float32)
    y = jnp.array([[-1.8, 9.9, -1.7]], jnp.float32)
    assert bool(dsc.test_occlusion(ds, x, y)[0])
    # clear line in open space
    x2 = jnp.array([[3.5, 5.0, 3.5]], jnp.float32)
    y2 = jnp.array([[3.5, 9.0, 3.5]], jnp.float32)
    assert not bool(dsc.test_occlusion(ds, x2, y2)[0])


def test_hdr_roundtrip(tmp_path):
    from radish_pt_tpu.scene.image_io import read_hdr, write_hdr

    rng = np.random.default_rng(0)
    img = (rng.random((16, 32, 3)).astype(np.float32) * 50) ** 2
    p = str(tmp_path / "t.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    maxc = img.max(-1, keepdims=True)
    sig = img > maxc / 8  # RGBE shared-exponent precision limit
    rel = (np.abs(back - img) / np.maximum(img, 1e-6))[sig]
    assert rel.max() < 0.05, rel.max()


def test_texture_bilinear_center_values(cornell):
    """Bilinear fetch at texel centers returns exact texel values."""
    ds, _, _ = cornell
    tex = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    ds2 = ds.replace(
        tex_data=jnp.asarray(tex.reshape(-1, 3)),
        tex_offset=jnp.array([0], jnp.int32),
        tex_width=jnp.array([2], jnp.int32),
        tex_height=jnp.array([2], jnp.int32),
    )
    uv = jnp.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])
    tid = jnp.zeros((4,), jnp.int32)
    out = np.asarray(dsc._texture_bilinear(ds2, tid, uv))
    np.testing.assert_allclose(out, tex.reshape(4, 3), atol=1e-5)


def test_env_scene_build():
    from radish_pt_tpu.scene.build import load_scene

    ds, cam, desc = load_scene(os.path.join(SCENES, "env_teapot.txt"))
    assert ds.has_env
    assert ds.intersector == "bvh"  # teapot is big enough
    # env pdf is positive toward the sun
    wi = jnp.asarray(np.array([[0.0, 1.0, 0.0]], np.float32))
    assert float(dsc.env_map_pdf(ds, wi)[0]) > 0
    # alias table covers area lights + env slot
    assert ds.light_alias_prob.shape[0] == ds.n_area_lights + 1


@pytest.mark.slow
def test_intersect_sorted_matches_unsorted():
    """Ray sorting + unpermute must be an exact no-op on results."""
    import jax.numpy as jnp

    from radish_pt_tpu.scene import build as sbuild
    from radish_pt_tpu.scene import device_scene as dsc
    from radish_pt_tpu.scene.parser import parse_scene

    ds, cam = sbuild.build_device_scene(parse_scene("scenes/teapot.txt"))
    assert ds.cluster_bounds is not None
    rng = np.random.default_rng(9)
    n = 512
    o = jnp.asarray(rng.uniform(-3, 3, size=(n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    it0 = dsc.intersect(ds, o, d)
    it1 = dsc.intersect_sorted(ds, o, d)
    np.testing.assert_array_equal(np.asarray(it1.prim_id), np.asarray(it0.prim_id))
    np.testing.assert_array_equal(np.asarray(it1.pos), np.asarray(it0.pos))
    y = o + d * 2.0
    o0 = dsc.test_occlusion(ds, o, y)
    o1 = dsc.test_occlusion_sorted(ds, o, y)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o0))

    # dead-lane culling: active lanes must be untouched, dead lanes must
    # report no hit / no occlusion
    active = jnp.asarray(rng.uniform(size=n) < 0.5)
    it2 = dsc.intersect_sorted(ds, o, d, active=active)
    act = np.asarray(active)
    np.testing.assert_array_equal(
        np.asarray(it2.prim_id)[act], np.asarray(it0.prim_id)[act]
    )
    o2 = dsc.test_occlusion_sorted(ds, o, y, mask=active)
    np.testing.assert_array_equal(np.asarray(o2)[act], np.asarray(o0)[act])
    assert not np.asarray(o2)[~act].any()
