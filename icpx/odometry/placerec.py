"""Appearance-based place recognition for loop closure.

The round-1 detector gated candidates purely on believed-position distance
(`loopclosure.py`), so once accumulated drift exceeded the gate, closures
were undiscoverable by construction. This module
adds a Scan-Context-style polar descriptor, computed on-chip with one
scatter-add pass per cloud:

  * ring features (radial annuli about the sensor origin): point density,
    mean height, height spread, max height — invariant to sensor yaw, so
    descriptor distance finds revisits regardless of heading or drift;
  * a sector profile (azimuthal bins of max height): circular
    cross-correlation of two profiles estimates the RELATIVE YAW between
    two visits, seeding the verification ICP when the believed relative
    pose is useless.

The reference has no multi-scan capability at all (one pair per process,
`main.cpp:8-10`); this is part of the odometry/SLAM extension (SURVEY §7
layer 5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from icpx.cloud import PointCloud


@partial(jax.jit, static_argnames=("n_rings", "n_sectors"))
def place_descriptor(
    xyz: jax.Array,
    mask: jax.Array,
    *,
    n_rings: int = 12,
    n_sectors: int = 48,
    max_range: Optional[float] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Polar place descriptor of a sensor-frame cloud.

    Returns (ring_desc (n_rings, 4), sector_profile (n_sectors,)).
    ring_desc columns: [density frac, mean z, std z, max z]; the sector
    profile is max height per azimuth bin (used for yaw estimation).
    """
    n = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = jnp.sqrt(x * x + y * y)
    rv = jnp.where(mask, r, 0.0)
    if max_range is None:
        # robust extent: ~90th percentile of ranges (static shapes: sort)
        rs = jnp.sort(jnp.where(mask, r, -1.0))
        count = jnp.maximum(mask.sum(), 1)
        q = jnp.maximum(
            rs[jnp.minimum((n - count) + (count * 9) // 10, n - 1)], 1e-3
        )
    else:
        q = jnp.float32(max_range)

    ring = jnp.clip(
        (rv / q * n_rings).astype(jnp.int32), 0, n_rings - 1
    )
    theta = jnp.arctan2(y, x)  # [-pi, pi]
    sector = jnp.clip(
        ((theta + jnp.pi) / (2.0 * jnp.pi) * n_sectors).astype(jnp.int32),
        0,
        n_sectors - 1,
    )

    w = mask.astype(jnp.float32)
    zm = jnp.where(mask, z, 0.0)
    cnt = jnp.zeros((n_rings,), jnp.float32).at[ring].add(w)
    sz = jnp.zeros((n_rings,), jnp.float32).at[ring].add(zm)
    szz = jnp.zeros((n_rings,), jnp.float32).at[ring].add(zm * zm)
    zmax = jnp.full((n_rings,), -jnp.inf, jnp.float32).at[ring].max(
        jnp.where(mask, z, -jnp.inf)
    )
    safe = jnp.maximum(cnt, 1.0)
    mean_z = sz / safe
    var_z = jnp.maximum(szz / safe - mean_z * mean_z, 0.0)
    total = jnp.maximum(w.sum(), 1.0)
    ring_desc = jnp.stack(
        [
            cnt / total,
            mean_z,
            jnp.sqrt(var_z),
            jnp.where(jnp.isfinite(zmax), zmax, 0.0),
        ],
        axis=1,
    )

    sec_max = jnp.full((n_sectors,), -jnp.inf, jnp.float32).at[sector].max(
        jnp.where(mask, z, -jnp.inf)
    )
    sector_profile = jnp.where(jnp.isfinite(sec_max), sec_max, 0.0)
    return ring_desc, sector_profile


def cloud_descriptor(cloud: PointCloud, **kw):
    return place_descriptor(cloud.xyz, cloud.mask, **kw)


@jax.jit
def descriptor_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """Scale-normalized L2 over ring descriptors (lower = more similar)."""
    scale = jnp.maximum(
        jnp.sqrt(jnp.mean(a * a) + jnp.mean(b * b)), 1e-6
    )
    return jnp.sqrt(jnp.mean((a - b) ** 2)) / scale


@jax.jit
def relative_yaw(profile_a: jax.Array, profile_b: jax.Array) -> jax.Array:
    """Yaw that best aligns cloud b onto cloud a via circular
    cross-correlation of sector profiles.

    Returns the angle (radians) such that Rz(yaw) @ b ~ a. Convention
    verified by tests/test_placerec.py::test_relative_yaw_recovers_rotation.
    """
    s = profile_a.shape[0]
    a = profile_a - jnp.mean(profile_a)
    b = profile_b - jnp.mean(profile_b)
    idx = (jnp.arange(s)[None, :] + jnp.arange(s)[:, None]) % s
    corr = (b[idx] * a[None, :]).sum(axis=1)  # corr[k] = sum a(i) b(i+k)
    shift = jnp.argmax(corr)
    yaw = 2.0 * jnp.pi * shift.astype(jnp.float32) / s
    # wrap to (-pi, pi]
    return jnp.where(yaw > jnp.pi, yaw - 2.0 * jnp.pi, yaw)
