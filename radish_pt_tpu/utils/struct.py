"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` turns a class into a frozen dataclass registered with
``jax.tree_util``.  Every field is a pytree child unless it is declared
``struct.field(pytree_node=False)``: such a field is static metadata that
lives in the tree structure, so a jitted function retraces when it changes
and the value must be hashable.  ``obj.replace(**changes)`` returns a copy
with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration (static fields as metadata)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )
