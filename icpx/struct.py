"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `field(pytree_node=False)`, which are static
metadata (part of the treedef, hashed into jit cache keys). Instances get
a `.replace(**changes)` method. Built on `jax.tree_util.register_dataclass`
so the package needs nothing beyond jax.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` marks it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration (static fields as meta)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
