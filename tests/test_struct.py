"""The local pytree dataclass helper (utils/struct.py)."""

import dataclasses

import pytest

import jax
import jax.numpy as jnp

from radish_pt_tpu.utils import struct


@struct.dataclass
class _Thing:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = struct.field(pytree_node=False, default=3)
    name: str = struct.field(pytree_node=False, default="x")


def test_flatten_unflatten_keeps_static_fields():
    t = _Thing(a=jnp.ones(2), b=jnp.zeros(3), n=5, name="y")
    leaves, tree = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2  # static fields are not leaves
    back = jax.tree_util.tree_unflatten(tree, [x + 1 for x in leaves])
    assert back.n == 5 and back.name == "y"
    assert float(back.b.sum()) == 3.0
    # None children flatten to nothing
    assert len(jax.tree_util.tree_leaves(_Thing(a=jnp.ones(1)))) == 1


def test_replace_returns_copy():
    t = _Thing(a=jnp.ones(2))
    u = t.replace(n=7, a=jnp.zeros(2))
    assert t.n == 3 and u.n == 7
    assert float(t.a.sum()) == 2.0 and float(u.a.sum()) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.n = 4


def test_jit_cache_keyed_on_static_fields():
    traces = []

    @jax.jit
    def f(t):
        traces.append(t.n)
        return t.a * t.n

    t = _Thing(a=jnp.ones(2))
    assert float(f(t).sum()) == 6.0
    f(t.replace(a=jnp.ones(2) * 2))  # new leaves, same static: no retrace
    assert traces == [3]
    assert float(f(t.replace(n=4)).sum()) == 8.0  # static change retraces
    assert traces == [3, 4]


def test_tree_map_and_vmap_over_children():
    t = _Thing(a=jnp.arange(3.0), b=jnp.arange(3.0) * 2)
    s = jax.tree_util.tree_map(lambda x: x * 10, t)
    assert s.name == "x" and float(s.b[2]) == 40.0
    out = jax.vmap(lambda t: t.a + t.b)(t)
    assert out.shape == (3,)
