"""Failure detection, degraded-mode fallbacks, and fault injection
(SURVEY §5.3 — the reference's error handling is an early-return on a
missing file).

Multi-host JAX has no partial failure: a lost host stalls the collective
and the job dies, so resilience is (a) detecting the stall early, (b)
checkpoint + restart (icpx.utils.checkpoint), and (c) degrading
gracefully on *data* faults (empty shards, degenerate geometry) which ARE
survivable inside SPMD. This module provides all three, plus the fault
injectors used by tests.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


class HeartbeatMonitor:
    """Watchdog for collective stalls.

    Multi-host failures surface as a collective that never completes;
    wrap the per-step `block_until_ready` in `beat()` and a background
    thread calls `on_stall` (default: raise in the main thread via
    captured flag) if no beat lands within `timeout_s`.
    """

    def __init__(self, timeout_s: float = 300.0, on_stall: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.stalled = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatMonitor":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def beat(self, out=None):
        if out is not None:
            jax.block_until_ready(out)
        self._last = time.monotonic()
        self.stalled = False  # a successful beat clears a past stall
        return out

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def _watch(self):
        fired = False
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self.stalled = True
                if self.on_stall and not fired:
                    self.on_stall()
                    fired = True  # fire once per stall episode
            elif fired and not self.stalled:
                fired = False  # beats resumed: re-arm for the next stall

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CollectiveStallError(RuntimeError):
    """A device fence (collective or transfer) failed to complete within
    the watchdog timeout — the multi-host failure mode JAX cannot surface
    itself (a lost peer stalls the collective forever)."""


def guarded_call(fn: Callable, timeout_s: float, on_stall: Optional[Callable] = None):
    """Run `fn` (a device-completion fence: scalar fetch or
    `block_until_ready`) under a `HeartbeatMonitor`; raise
    `CollectiveStallError` if it does not complete within `timeout_s`.

    The fence runs in a worker thread because a stalled fence blocks
    inside the runtime's C call — the main thread cannot be interrupted
    there, so detection must come from outside the call. `timeout_s <= 0`
    runs `fn` inline (watchdog off — the CPU/test default).
    """
    if timeout_s <= 0:
        return fn()
    box: dict = {}

    def work():
        try:
            box["value"] = fn()
        except BaseException as e:  # surfaced in the caller below
            box["error"] = e

    with HeartbeatMonitor(timeout_s=timeout_s, on_stall=on_stall) as mon:
        t = threading.Thread(target=work, daemon=True)
        t.start()
        while t.is_alive() and not mon.stalled:
            t.join(min(timeout_s / 20, 1.0))
        if t.is_alive():
            raise CollectiveStallError(
                f"device fence did not complete within {timeout_s:.0f}s — "
                "stalled collective (lost host) or hung device transport; "
                "checkpoint-and-restart is the recovery path (SURVEY §5.3)"
            )
        mon.beat()
    if "error" in box:
        raise box["error"]
    return box["value"]


def default_stall_timeout(warmup: bool = False) -> float:
    """Watchdog default for entry points: on only in multi-process runs,
    where a lost peer stalls a collective forever (generous, because a
    first compile can take minutes); off in a single process, where a
    device fence always completes or raises."""
    if jax.process_count() <= 1:
        return 0.0
    return 1200.0 if warmup else 600.0


def degenerate_solve_guard(transform, stats, prev_transform):
    """Reject a solve update when its convergence stats are non-finite or
    the inlier count collapsed — keep the previous transform instead.

    SPMD-safe (pure where-select); the data faults this catches: all
    correspondences gated out, rank-collapsed normal equations that
    slipped past damping, NaN residuals from corrupted input points.
    """
    ok = (
        jnp.isfinite(stats.rmse)
        & jnp.isfinite(stats.diff)
        & (stats.inlier_count >= 3.0)
        & jnp.all(jnp.isfinite(transform.t))
        & jnp.all(jnp.isfinite(transform.R))
    )
    return jax.tree_util.tree_map(
        lambda new, old: jnp.where(ok, new, old), transform, prev_transform
    ), ok


# ---- fault injection (tests) -------------------------------------------------


def drop_shard(mask: jax.Array, shard_index: int, n_shards: int) -> jax.Array:
    """Simulate a host losing its data shard: zero the validity mask of
    one contiguous 1/n_shards slice. The remaining shards must still
    produce a valid (slightly noisier) solution — tested in
    tests/test_fault.py."""
    n = mask.shape[0]
    s = n // n_shards
    idx = jnp.arange(n)
    dead = (idx >= shard_index * s) & (idx < (shard_index + 1) * s)
    return mask & ~dead


def corrupt_points(
    xyz: jax.Array, key: jax.Array, fraction: float = 0.05, magnitude: float = 100.0
) -> jax.Array:
    """Inject gross outliers into a fraction of points."""
    n = xyz.shape[0]
    k1, k2 = jax.random.split(key)
    hit = jax.random.uniform(k1, (n,)) < fraction
    noise = magnitude * jax.random.normal(k2, xyz.shape)
    return jnp.where(hit[:, None], xyz + noise, xyz)
