"""The Pallas-Triton dense sweep (accel/brute_triton.py) in interpret mode
against the XLA sweep: padding, ray counts off the block size, dead lanes,
occlusion, and that every primitive it uses lowers through Triton."""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radish_pt_tpu.accel import brute_triton as bt
from radish_pt_tpu.accel import traverse as trv
from radish_pt_tpu.scene import build as sbuild
from radish_pt_tpu.scene import device_scene as dsc

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@functools.lru_cache(maxsize=None)
def _scene(fname):
    return sbuild.load_scene(os.path.join(SCENES, fname))[0]


def _rays(ds, n, seed=1):
    rng = np.random.default_rng(seed)
    lo = np.asarray(ds.bounds_min).min(axis=0)
    hi = np.asarray(ds.bounds_max).max(axis=0)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n", [1, 127, 128, 300])
@pytest.mark.parametrize("fname", ["cornell_box.txt", "many_light.txt"])
def test_closest_hit_matches_xla(fname, n):
    ds = _scene(fname)
    o, d = _rays(ds, n)
    pa, ta, ba = bt.intersect_brute_triton(ds.tri_packed, o, d, interpret=True)
    pb, tb, bb = trv.intersect_brute(ds.tri_packed, o, d)
    assert pa.shape == (n,) and ba.shape == (n, 2)
    pa, pb = np.asarray(pa), np.asarray(pb)
    same = pa == pb
    tie = np.abs(np.asarray(ta) - np.asarray(tb)) <= 1e-5 * np.abs(
        np.asarray(tb))
    assert (same | tie).all()
    np.testing.assert_allclose(np.asarray(ta)[same], np.asarray(tb)[same],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ba)[same], np.asarray(bb)[same],
                               atol=1e-4)


@pytest.mark.parametrize("fname", ["cornell_box.txt", "many_light.txt"])
def test_occlusion_matches_xla(fname):
    ds = _scene(fname)
    o, d = _rays(ds, 200, seed=2)
    y = o + d * 4.0
    a = np.asarray(bt.occlusion_brute_triton(ds.tri_packed, o, y,
                                             interpret=True))
    b = np.asarray(trv.occlusion_brute(ds.tri_packed, o, y))
    assert 0 < b.mean() < 1
    np.testing.assert_array_equal(a, b)


def test_engine_dispatch_and_dead_lanes(monkeypatch):
    """ds.intersector == 'pallas_brute' routes intersect / test_occlusion
    through the kernel; dead lanes report no hit."""
    calls = []
    for name in ("intersect_brute_triton", "occlusion_brute_triton"):
        fn = getattr(bt, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, interpret=True, **k)

        monkeypatch.setattr(bt, name, wrapped)
    ds = _scene("cornell_box.txt")
    o, d = _rays(ds, 150, seed=3)
    active = jnp.asarray(np.arange(150) % 3 != 0)
    ref = dsc.intersect(ds, o, d, active)
    got = dsc.intersect(ds.replace(intersector="pallas_brute"), o, d, active)
    np.testing.assert_array_equal(np.asarray(got.prim_id),
                                  np.asarray(ref.prim_id))
    assert (np.asarray(got.prim_id)[::3] == -1).all()
    occ = dsc.test_occlusion(ds.replace(intersector="pallas_brute"), o,
                             o + d * 2.0)
    np.testing.assert_array_equal(
        np.asarray(occ), np.asarray(dsc.test_occlusion(ds, o, o + d * 2.0)))
    assert calls == ["intersect_brute_triton", "occlusion_brute_triton"]


def _kernel_primitives(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    kernels = []

    def walk(j, inside):
        for e in j.eqns:
            if inside:
                kernels.append(e.primitive)
            if e.primitive.name == "pallas_call":
                walk(e.params["jaxpr"], True)
                continue
            for p in e.params.values():
                for q in (p if isinstance(p, (list, tuple)) else [p]):
                    sub = getattr(q, "jaxpr", None)
                    if sub is not None:
                        walk(getattr(sub, "jaxpr", sub), inside)

    walk(jaxpr, False)
    return set(kernels)


@pytest.mark.parametrize("which", ["closest", "occlusion"])
def test_every_kernel_primitive_lowers_through_triton(which):
    """The GPU compiler cannot be asked here; this catches an operation the
    Pallas Triton route has no lowering for (it refuses a `slice`, say)."""
    from jax._src.pallas.triton import lowering

    ds = _scene("cornell_box.txt")
    o, d = _rays(ds, 64)
    fn = {"closest": bt.intersect_brute_triton,
          "occlusion": bt.occlusion_brute_triton}[which]
    prims = _kernel_primitives(lambda t, a, b: fn(t, a, b), ds.tri_packed,
                               o, o + d)
    assert prims
    missing = {p.name for p in prims} - {
        p.name for p in lowering.triton_lowering_rules}
    assert not missing, missing


def test_kernel_under_shard_map():
    """Inside shard_map the kernel's outputs must declare the mesh axes
    its inputs vary over (the multi-device path runs it per tile)."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from radish_pt_tpu.parallel.sharding import make_mesh

    ds = _scene("cornell_box.txt")
    o, d = _rays(ds, 4 * 40, seed=4)
    mesh = make_mesh(n_tile=4, n_sample=1)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("tile"), P("tile")),
             out_specs=P("tile"))
    def per_tile(tp, o, d):
        return bt.intersect_brute_triton(tp, o, d, interpret=True)[0]

    got = np.asarray(jax.jit(per_tile)(ds.tri_packed, o, d))
    want = np.asarray(trv.intersect_brute(ds.tri_packed, o, d)[0])
    np.testing.assert_array_equal(got, want)
