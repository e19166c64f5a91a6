"""Global map maintenance: fixed-capacity voxel-deduplicated accumulation.

Completes the scan-to-map half of the odometry engine (the partitioned
map of distributed/map_ep.py feeds from this): keyframe clouds are
transformed into the world frame and merged into a bounded map that keeps
at most one point per voxel, preferring the OLDEST point (map stability —
new observations of a mapped voxel don't churn it).

Static shapes throughout: the map has a fixed capacity; each insert
processes (capacity + frame) rows with two sorts and recompacts. For the
distributed version, `icpx.distributed.map_ep.partition_map` splits the
result into expert blocks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from icpx import struct

from icpx.cloud import PAD_COORD, PointCloud
from icpx.geometry.se3 import SE3


@struct.dataclass
class VoxelMap:
    """Bounded world-frame map with voxel-unique points."""

    xyz: jax.Array  # (M, 3), PAD_COORD rows invalid
    normals: jax.Array  # (M, 3)
    mask: jax.Array  # (M,)
    age: jax.Array  # (M,) int32 insertion counter (lower = older)
    cell_size: jax.Array  # scalar
    counter: jax.Array  # scalar int32, monotonically increasing
    # optional (M, D) payload channels (intensity/rgb/...), carried from
    # inserted scans; None when scans carry none
    feats: Optional[jax.Array] = None
    feat_names: Optional[tuple] = struct.field(
        pytree_node=False, default=None
    )

    @classmethod
    def create(
        cls,
        capacity: int,
        cell_size: float,
        *,
        feat_names: Optional[tuple] = None,
    ) -> "VoxelMap":
        return cls(
            xyz=jnp.full((capacity, 3), PAD_COORD, jnp.float32),
            normals=jnp.zeros((capacity, 3), jnp.float32),
            mask=jnp.zeros((capacity,), bool),
            age=jnp.full((capacity,), jnp.iinfo(jnp.int32).max, jnp.int32),
            cell_size=jnp.float32(cell_size),
            counter=jnp.int32(0),
            feats=(
                jnp.zeros((capacity, len(feat_names)), jnp.float32)
                if feat_names
                else None
            ),
            feat_names=tuple(feat_names) if feat_names else None,
        )

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_valid(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    def as_cloud(self) -> PointCloud:
        return PointCloud(
            xyz=self.xyz,
            mask=self.mask,
            normals=self.normals,
            feats=self.feats,
            feat_names=self.feat_names,
        )


_BIGC = 2**30  # out-of-range cell coord marking invalid rows (sorts last)


def _voxel_coords(
    xyz: jax.Array, inv_cell: jax.Array, mask: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Integer cell coords per axis (int32; exact, no 64-bit packing —
    this config has x64 disabled, so a packed key would silently truncate
    and collide)."""
    c = jnp.floor(xyz * inv_cell).astype(jnp.int32)
    cx = jnp.where(mask, c[:, 0], _BIGC)
    cy = jnp.where(mask, c[:, 1], _BIGC)
    cz = jnp.where(mask, c[:, 2], _BIGC)
    return cx, cy, cz


@jax.jit
def insert_scan(
    vmap: VoxelMap,
    scan: PointCloud,
    pose: SE3,
) -> VoxelMap:
    """Merge a sensor-frame scan (with normals) at `pose` into the map.

    Keeps at most one point per voxel (oldest wins — a mapped voxel's
    representative doesn't churn); when the merged set exceeds capacity,
    the OLDEST points are evicted (sliding-window behavior: the map
    follows the vehicle instead of pinning to the start and losing
    tracking when the trajectory leaves the initial region).
    """
    if scan.normals is None:
        raise ValueError("scan must carry normals")
    if (vmap.feat_names or scan.feat_names) and (
        scan.feat_names != vmap.feat_names
    ):
        raise ValueError(
            f"map payload channels {vmap.feat_names} != scan's "
            f"{scan.feat_names}; create the map with matching feat_names "
            "(silently dropping a channel would be worse)"
        )
    w_xyz = pose.apply(scan.xyz)
    w_nrm = pose.rotate(scan.normals)

    all_xyz = jnp.concatenate([vmap.xyz, w_xyz])
    all_nrm = jnp.concatenate([vmap.normals, w_nrm])
    all_feat = (
        jnp.concatenate([vmap.feats, scan.feats])
        if vmap.feats is not None
        else None
    )
    all_mask = jnp.concatenate([vmap.mask, scan.mask])
    new_age = jnp.full(
        (scan.capacity,), vmap.counter + 1, jnp.int32
    )
    all_age = jnp.concatenate([vmap.age, new_age])

    inv_cell = 1.0 / vmap.cell_size
    cx, cy, cz = _voxel_coords(all_xyz, inv_cell, all_mask)

    # Lexicographic sort by (cx, cy, cz, age) via chained stable sorts
    # (each stable sort preserves the previous ordering within ties), so
    # equal-voxel runs are contiguous with the oldest point first.
    order = jnp.argsort(all_age, stable=True)
    order = order[jnp.argsort(cz[order], stable=True)]
    order = order[jnp.argsort(cy[order], stable=True)]
    order = order[jnp.argsort(cx[order], stable=True)]
    sx, sy, sz = cx[order], cy[order], cz[order]
    same = (sx[1:] == sx[:-1]) & (sy[1:] == sy[:-1]) & (sz[1:] == sz[:-1])
    is_first = jnp.concatenate([jnp.ones((1,), bool), ~same])
    keep = is_first & (sx < _BIGC)

    # Compact keepers to the front, NEWEST first, so the capacity cut
    # evicts the oldest points; invalid rows sort last.
    sort_key = jnp.where(keep, -all_age[order], jnp.int32(2**31 - 1))
    order2 = jnp.argsort(sort_key, stable=True)
    sel = order[order2][: vmap.capacity]
    kept = keep[order2][: vmap.capacity]

    return VoxelMap(
        xyz=jnp.where(kept[:, None], all_xyz[sel], PAD_COORD),
        normals=jnp.where(kept[:, None], all_nrm[sel], 0.0),
        mask=kept,
        age=jnp.where(kept, all_age[sel], jnp.int32(2**31 - 1)),
        cell_size=vmap.cell_size,
        counter=vmap.counter + 1,
        feats=(
            jnp.where(kept[:, None], all_feat[sel], 0.0)
            if all_feat is not None
            else None
        ),
        feat_names=vmap.feat_names,
    )
