"""Debug & correctness-audit utilities (SURVEY §5.2).

The reference has no sanitizers (single-threaded MSVC defaults); the JAX
equivalents here are: NaN trapping, deterministic-mode toggles, and
shard-equivalence auditing (run a sharded function and its single-device
replay, compare) — the data-race detector of the SPMD world.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def nan_checks(enabled: bool = True):
    """Trap NaNs produced by any jitted computation inside the scope."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextlib.contextmanager
def deterministic_mode():
    """Bitwise-reproducible reductions across runs (slower).

    This pins matmul precision to HIGHEST inside the scope
    so results do not shift between precision heuristics.
    """
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jax.config.update("jax_default_matmul_precision", prev)


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise if any leaf contains NaN/Inf (host-side audit)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad} non-finite values"
            )


def shard_equivalence_report(
    sharded_out,
    single_out,
    *,
    atol: float = 1e-5,
    rtol: float = 1e-5,
) -> dict:
    """Compare a sharded run against its single-device replay.

    Returns {leaf path: max abs diff} for leaves that differ beyond
    tolerance; empty dict == equivalent.
    """
    diffs = {}
    flat_a = jax.tree_util.tree_flatten_with_path(sharded_out)[0]
    flat_b = jax.tree_util.tree_leaves(single_out)
    for (path, a), b in zip(flat_a, flat_b):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind not in "fc":
            if not np.array_equal(a, b):
                diffs[jax.tree_util.keystr(path)] = float("nan")
            continue
        finite = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            diffs[jax.tree_util.keystr(path)] = float("inf")
            continue
        if finite.any():
            d = np.abs(a[finite] - b[finite])
            tol = atol + rtol * np.abs(b[finite])
            if (d > tol).any():
                diffs[jax.tree_util.keystr(path)] = float(d.max())
    return diffs
