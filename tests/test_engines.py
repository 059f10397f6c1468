"""Intersection engines: the MTBVH walk against the dense sweep on every
scene, sorted against unsorted wavefronts, engine selection and refusal of
removed engines, the device-mesh guard and the compile-cache placement."""

import functools
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radish_pt_tpu.accel import traverse as trv
from radish_pt_tpu.scene import build as sbuild
from radish_pt_tpu.scene import device_scene as dsc

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SCENE_FILES = sorted(os.path.basename(p)
                     for p in glob.glob(os.path.join(SCENES, "*.txt")))
CLUSTER_SCENES = ("env_teapot.txt", "glass.txt", "teapot.txt",
                  "teapot_hires.txt")
REMOVED_ENGINES = ("pallas_mxu", "pallas_compact", "pallas_quad",
                   "pallas_band", "nonsense")
N_RAYS = 384


@functools.lru_cache(maxsize=None)
def _scene(fname):
    ds, cam, _ = sbuild.load_scene(os.path.join(SCENES, fname))
    return ds, cam


@functools.lru_cache(maxsize=None)
def _rays(fname, n=N_RAYS, seed=5):
    """Rays from random points inside the scene box (so many of them hit),
    in random directions."""
    ds, _ = _scene(fname)
    lo = np.asarray(ds.bounds_min).min(axis=0)
    hi = np.asarray(ds.bounds_max).max(axis=0)
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_same_hits(prim_a, dist_a, prim_b, dist_b):
    """Equal triangle ids, except distance ties (coplanar neighbours hit on
    a shared edge) within 1e-5 relative."""
    prim_a, prim_b = np.asarray(prim_a), np.asarray(prim_b)
    dist_a, dist_b = np.asarray(dist_a), np.asarray(dist_b)
    diff = prim_a != prim_b
    tie = (np.abs(dist_a - dist_b)
           <= 1e-5 * np.maximum(np.abs(dist_b), 1e-30)) & (prim_a >= 0) & (
               prim_b >= 0)
    assert not (diff & ~tie).any(), np.flatnonzero(diff & ~tie)[:10]
    assert diff.mean() < 0.01


@pytest.mark.parametrize("fname", SCENE_FILES)
def test_bvh_closest_hit_matches_brute(fname):
    ds, _ = _scene(fname)
    o, d = _rays(fname)
    pa, ta, _ = jax.jit(trv.intersect_bvh)(ds.leaf_tris, ds.leaf_map,
                                           ds.bvh_packed, o, d)
    pb, tb, _ = jax.jit(trv.intersect_brute)(ds.tri_packed, o, d)
    assert (np.asarray(pb) >= 0).mean() > 0.2  # open scenes: rays escape
    _assert_same_hits(pa, ta, pb, tb)


@pytest.mark.parametrize("fname", SCENE_FILES)
def test_bvh_occlusion_matches_brute(fname):
    ds, _ = _scene(fname)
    o, d = _rays(fname)
    scale = float(np.linalg.norm(np.asarray(ds.bounds_max).max(0)
                                 - np.asarray(ds.bounds_min).min(0)))
    y = o + d * (0.3 * scale)
    oa = np.asarray(jax.jit(trv.occlusion_bvh)(ds.leaf_tris, ds.leaf_map,
                                              ds.bvh_packed, o, y))
    ob = np.asarray(jax.jit(trv.occlusion_brute)(ds.tri_packed, o, y))
    assert 0.0 < ob.mean() < 1.0
    # a segment ending within float noise of a surface may flip
    assert (oa != ob).mean() <= 0.01


def _dead_lanes(n, seed=2):
    return jnp.asarray(np.random.default_rng(seed).uniform(size=n) < 0.6)


@pytest.mark.parametrize("fname", CLUSTER_SCENES)
def test_intersect_sorted_matches_intersect(fname):
    """The signature sort + unpermute is a no-op on the bvh engine's hits,
    dead lanes included (they report no hit)."""
    ds, _ = _scene(fname)
    assert ds.intersector == "bvh" and ds.cluster_bounds is not None
    o, d = _rays(fname)
    active = _dead_lanes(o.shape[0])
    a = jax.jit(dsc.intersect)(ds, o, d, active)
    b = jax.jit(dsc.intersect_sorted)(ds, o, d, active)
    act = np.asarray(active)
    np.testing.assert_array_equal(np.asarray(b.prim_id), np.asarray(a.prim_id))
    assert (np.asarray(b.prim_id)[~act] == trv.NULL_PRIMITIVE).all()
    for x, y in ((a.pos, b.pos), (a.norm, b.norm), (a.uv, b.uv)):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-6)


@pytest.mark.parametrize("fname", CLUSTER_SCENES)
def test_occlusion_sorted_matches_occlusion(fname):
    ds, _ = _scene(fname)
    o, d = _rays(fname)
    y = o + d * 2.0
    mask = _dead_lanes(o.shape[0], seed=3)
    plain = np.asarray(jax.jit(dsc.test_occlusion)(ds, o, y))
    srt = np.asarray(jax.jit(dsc.test_occlusion_sorted)(ds, o, y, mask))
    m = np.asarray(mask)
    np.testing.assert_array_equal(srt[m], plain[m])
    assert not srt[~m].any()


@pytest.mark.parametrize("backend,n_tris,engine", [
    ("cpu", 36, "brute"), ("cpu", 128, "brute"), ("cpu", 129, "bvh"),
    ("cpu", 111186, "bvh"), ("gpu", 36, "pallas_brute"),
    ("gpu", 128, "pallas_brute"), ("gpu", 129, "bvh"),
])
def test_engine_auto_selection(backend, n_tris, engine, monkeypatch):
    monkeypatch.delenv("RADISH_INTERSECTOR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert sbuild.select_intersector(n_tris) == engine


def test_scene_build_picks_engine_by_size(monkeypatch):
    monkeypatch.delenv("RADISH_INTERSECTOR", raising=False)
    assert _scene("cornell_box.txt")[0].intersector == "brute"
    assert _scene("teapot.txt")[0].intersector == "bvh"


@pytest.mark.parametrize("name", REMOVED_ENGINES)
def test_cli_refuses_removed_engine(name, capsys):
    from radish_pt_tpu.cli import build_arg_parser

    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(
            [os.path.join(SCENES, "cornell_box.txt"), "--intersector", name])


@pytest.mark.parametrize("name", REMOVED_ENGINES)
def test_env_refuses_removed_engine(name, monkeypatch):
    monkeypatch.setenv("RADISH_INTERSECTOR", name)
    with pytest.raises(ValueError, match="unknown intersector"):
        sbuild.select_intersector(36)


@pytest.mark.parametrize("name", sbuild.INTERSECTORS)
def test_remaining_engines_accepted(name, monkeypatch):
    from radish_pt_tpu.cli import build_arg_parser

    args = build_arg_parser().parse_args(["s.txt", "--intersector", name])
    assert args.intersector == name
    monkeypatch.setenv("RADISH_INTERSECTOR", name)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sbuild.select_intersector(36) == name
    assert sbuild.select_intersector(10**6) == name


def test_triton_engine_refused_without_gpu(monkeypatch):
    monkeypatch.setenv("RADISH_INTERSECTOR", "pallas_brute")
    with pytest.raises(ValueError, match="GPU"):
        sbuild.select_intersector(36)


@pytest.mark.parametrize("n_tile,n_sample", [(16, 1), (8, 2), (3, 3)])
def test_make_mesh_refuses_too_few_devices(n_tile, n_sample):
    from radish_pt_tpu.parallel.sharding import make_mesh

    assert len(jax.devices()) == 8
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_tile=n_tile, n_sample=n_sample)


def test_make_mesh_uses_default_backend():
    from radish_pt_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(n_tile=4, n_sample=2)
    assert mesh.shape == {"tile": 4, "sample": 2}
    assert {d.platform for d in mesh.devices.ravel()} == {
        jax.default_backend()}


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the code sets no directory (JAX
    reads the variable itself); without it the cache is the checkout's
    git-ignored .jax_cache/."""
    from radish_pt_tpu.utils import cache

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_persistent_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == os.path.join(
            root, ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert calls["jax_persistent_cache_min_compile_time_secs"] > 0
