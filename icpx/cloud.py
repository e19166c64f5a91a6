"""Point-cloud container: a static-shape, mask-padded pytree.

Design notes
------------
The reference keeps clouds as PCL objects and dense Eigen matrices
(`myicp.h:26-28`, `myicp.cpp:109-111`). Under `jit` everything must have
static shapes, so a cloud is a fixed-capacity ``(N, 3)`` array plus a
validity mask; all kernels (kNN, normal estimation, ICP reductions) respect
the mask. Capacity is padded to a power-of-two-friendly multiple so kernel
tiling never sees ragged edges.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from icpx import struct

# Padding multiple: N a multiple of 128 keeps every tiling (KD tiles of
# 64/128 points, GPU kernel blocks of power-of-two rows) free of ragged
# edges.
PAD_MULTIPLE = 128

# Coordinate used for padded (invalid) rows.  A large-but-finite sentinel so
# squared distances stay finite in fp32 (1e8**2 = 1e16 << 3.4e38) and padded
# points are never anyone's nearest neighbor even without masking.
PAD_COORD = 1.0e8


def round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    return ((n + m - 1) // m) * m


@struct.dataclass
class PointCloud:
    """A padded point cloud.

    Attributes:
      xyz:     (N, 3) float32 coordinates; rows with ``mask == False`` hold
               the PAD_COORD sentinel.
      mask:    (N,) bool — True for real points.
      normals: optional (N, 3) float32 unit normals (zero rows where unknown).
    """

    xyz: jax.Array
    mask: jax.Array
    normals: Optional[jax.Array] = None
    # optional (N, 3, 3) regularized neighborhood covariances (GICP)
    covs: Optional[jax.Array] = None
    # optional (N, D) float32 per-point payload channels (intensity /
    # reflectance, packed rgb, labels, curvature, ring index, ...). They
    # ride along rigid transforms unchanged; `feat_names` (static pytree
    # metadata) names the columns.
    feats: Optional[jax.Array] = None
    feat_names: Optional[tuple] = struct.field(
        pytree_node=False, default=None
    )

    # ---- construction ------------------------------------------------------

    @classmethod
    def create(
        cls,
        xyz,
        normals=None,
        *,
        capacity: Optional[int] = None,
        pad_multiple: int = PAD_MULTIPLE,
        feats=None,
        feat_names: Optional[tuple] = None,
    ) -> "PointCloud":
        """Build a padded cloud from an (n, 3) array (numpy or jax)."""
        xyz = jnp.asarray(xyz, dtype=jnp.float32)
        if xyz.ndim != 2 or xyz.shape[1] != 3:
            raise ValueError(f"xyz must be (n, 3), got {xyz.shape}")
        n = xyz.shape[0]
        cap = capacity if capacity is not None else round_up(max(n, 1), pad_multiple)
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")
        pad = cap - n
        xyz_p = jnp.concatenate(
            [xyz, jnp.full((pad, 3), PAD_COORD, dtype=jnp.float32)], axis=0
        )
        mask = jnp.concatenate(
            [jnp.ones((n,), dtype=bool), jnp.zeros((pad,), dtype=bool)], axis=0
        )
        nrm_p = None
        if normals is not None:
            normals = jnp.asarray(normals, dtype=jnp.float32)
            if normals.shape != (n, 3):
                raise ValueError(f"normals must be (n, 3)={n}, got {normals.shape}")
            nrm_p = jnp.concatenate(
                [normals, jnp.zeros((pad, 3), dtype=jnp.float32)], axis=0
            )
        feats_p = None
        if feats is not None:
            feats = jnp.asarray(feats, dtype=jnp.float32)
            if feats.ndim == 1:
                feats = feats[:, None]
            if feats.shape[0] != n:
                raise ValueError(
                    f"feats must have {n} rows, got {feats.shape}"
                )
            if feat_names is not None and len(feat_names) != feats.shape[1]:
                raise ValueError(
                    f"{len(feat_names)} feat_names for {feats.shape[1]} "
                    "feature columns"
                )
            feats_p = jnp.concatenate(
                [feats, jnp.zeros((pad, feats.shape[1]), jnp.float32)],
                axis=0,
            )
        return cls(
            xyz=xyz_p,
            mask=mask,
            normals=nrm_p,
            feats=feats_p,
            feat_names=tuple(feat_names) if feat_names else None,
        )

    # ---- properties --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_valid(self) -> jax.Array:
        """Traced count of real points."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def has_normals(self) -> bool:
        return self.normals is not None

    # ---- transforms --------------------------------------------------------

    def with_xyz(self, xyz: jax.Array) -> "PointCloud":
        return self.replace(xyz=jnp.where(self.mask[:, None], xyz, self.xyz))

    def with_normals(self, normals: jax.Array) -> "PointCloud":
        return self.replace(
            normals=jnp.where(self.mask[:, None], normals, jnp.zeros_like(normals))
        )

    def pad_to(self, capacity: int) -> "PointCloud":
        """Grow capacity (static) keeping mask/sentinel discipline."""
        if capacity < self.capacity:
            raise ValueError("pad_to cannot shrink; use take/compact on host")
        extra = capacity - self.capacity
        if extra == 0:
            return self
        xyz = jnp.concatenate(
            [self.xyz, jnp.full((extra, 3), PAD_COORD, jnp.float32)], axis=0
        )
        mask = jnp.concatenate([self.mask, jnp.zeros((extra,), bool)], axis=0)
        normals = None
        if self.normals is not None:
            normals = jnp.concatenate(
                [self.normals, jnp.zeros((extra, 3), jnp.float32)], axis=0
            )
        covs = None
        if self.covs is not None:
            eye = jnp.broadcast_to(
                jnp.eye(3, dtype=jnp.float32), (extra, 3, 3)
            )
            covs = jnp.concatenate([self.covs, eye], axis=0)
        feats = None
        if self.feats is not None:
            feats = jnp.concatenate(
                [
                    self.feats,
                    jnp.zeros((extra, self.feats.shape[1]), jnp.float32),
                ],
                axis=0,
            )
        return PointCloud(
            xyz=xyz,
            mask=mask,
            normals=normals,
            covs=covs,
            feats=feats,
            feat_names=self.feat_names,
        )

    def centroid(self) -> jax.Array:
        """Masked mean of valid points, (3,)."""
        w = self.mask.astype(jnp.float32)
        denom = jnp.maximum(jnp.sum(w), 1.0)
        return jnp.sum(self.xyz * w[:, None], axis=0) / denom

    def extent(self) -> jax.Array:
        """Bounding-box diagonal length over valid points."""
        big = jnp.float32(PAD_COORD)
        lo = jnp.min(jnp.where(self.mask[:, None], self.xyz, big), axis=0)
        hi = jnp.max(jnp.where(self.mask[:, None], self.xyz, -big), axis=0)
        any_valid = jnp.any(self.mask)
        return jnp.where(any_valid, jnp.linalg.norm(hi - lo), 0.0)

    # ---- host-side helpers -------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Valid points only, host numpy (n, 3). Not jittable."""
        mask = np.asarray(self.mask)
        return np.asarray(self.xyz)[mask]

    def normals_to_numpy(self) -> Optional[np.ndarray]:
        if self.normals is None:
            return None
        mask = np.asarray(self.mask)
        return np.asarray(self.normals)[mask]

    def feat(self, name: str) -> jax.Array:
        """One named payload column, (N,) in padded layout (jittable)."""
        if self.feats is None or self.feat_names is None:
            raise KeyError(f"cloud has no payload features (want {name!r})")
        if name not in self.feat_names:
            raise KeyError(
                f"no feature {name!r}; have {list(self.feat_names)}"
            )
        return self.feats[:, self.feat_names.index(name)]

    def feats_to_numpy(self) -> Optional[np.ndarray]:
        if self.feats is None:
            return None
        mask = np.asarray(self.mask)
        return np.asarray(self.feats)[mask]


def concat(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two clouds (capacity adds; masks preserved)."""
    if (a.normals is None) != (b.normals is None):
        raise ValueError("both clouds must agree on having normals")
    if (a.covs is None) != (b.covs is None):
        raise ValueError("both clouds must agree on having covariances")
    if (a.feats is None) != (b.feats is None) or a.feat_names != b.feat_names:
        raise ValueError("both clouds must agree on payload features")
    return PointCloud(
        xyz=jnp.concatenate([a.xyz, b.xyz], axis=0),
        mask=jnp.concatenate([a.mask, b.mask], axis=0),
        normals=(
            None
            if a.normals is None
            else jnp.concatenate([a.normals, b.normals], axis=0)
        ),
        covs=(
            None
            if a.covs is None
            else jnp.concatenate([a.covs, b.covs], axis=0)
        ),
        feats=(
            None
            if a.feats is None
            else jnp.concatenate([a.feats, b.feats], axis=0)
        ),
        feat_names=a.feat_names,
    )
