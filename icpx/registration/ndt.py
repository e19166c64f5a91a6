"""NDT — normal-distributions-transform registration (Biber & Strasser
2003; Magnusson 2009), point-to-distribution form.

The reference has no NDT (its only finished objective is symmetric ICP,
`myicp.cpp:100-150`); this extends the framework's objective family by REUSING the existing machinery instead of growing a
new pipeline:

  * cells: the target's KD tiles double as NDT cells — density-adaptive
    (equal-count) instead of fixed voxels, so empty-cell bookkeeping and
    dynamic shapes never arise. Per-cell Gaussians are one masked moment
    reduction over the already-built (T, S, 3) tile tensor.
  * matching + solve: a source point scored against its nearest cell's
    Gaussian is exactly the GICP Mahalanobis objective with the source
    covariance shrunk to eps*I — so NDT runs through `register()` with
    `objective="gicp"`, inheriting auto-centering, the block/brute NN
    auto-switch, the coarse-to-fine schedule, robust weights, and every
    distributed execution mode.

Cell covariances use Magnusson's regularization: eigenvalues clamped to
>= `eig_floor` * lambda_max so near-planar/linear cells stay invertible
without flattening genuine structure.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from icpx.cloud import PAD_COORD, PointCloud
from icpx.geometry.se3 import SE3
from icpx.kernels.eigh3 import eigh3x3
from icpx.registration.icp import ICPConfig, ICPResult, register


def ndt_cells(
    tgt: PointCloud,
    *,
    cell_size: int = 64,
    eig_floor: float = 1e-2,
    min_points: int = 5,
) -> PointCloud:
    """Collapse a cloud into its NDT cell Gaussians.

    Returns a PointCloud of cell means whose `covs` carry the
    regularized per-cell covariances; cells with fewer than `min_points`
    points are masked out (their distribution is meaningless).
    """
    from icpx.kernels.blocknn import build_kd_index

    # center before the moment expansion: fp32 second moments at
    # UTM-scale coordinate magnitudes (1e5+) lose the cell structure
    # entirely (coordinate resolution ~0.06 m at 1e6); the shift is
    # added back to the returned means
    center = tgt.centroid()
    idx = build_kd_index(
        tgt.xyz - center[None, :], tgt.mask, tile_size=cell_size
    )
    tiles = idx.tiles  # (T, S, 3)
    valid = (idx.order >= 0).reshape(tiles.shape[0], tiles.shape[1])
    cnt = valid.sum(axis=1).astype(jnp.float32)  # (T,)
    safe = jnp.maximum(cnt, 1.0)
    mu = jnp.where(valid[..., None], tiles, 0.0).sum(axis=1) / safe[:, None]
    # cell-centered second moments (fp32-safe: coordinates are already
    # centered by register(); tiles span ~cell extents)
    d = jnp.where(valid[..., None], tiles - mu[:, None, :], 0.0)
    cov = jnp.einsum("tsi,tsj->tij", d, d) / safe[:, None, None]
    # Magnusson regularization: lambda_i >= eig_floor * lambda_max
    lam, V = eigh3x3(cov)  # ascending eigenvalues
    lam_max = jnp.maximum(lam[..., 2:3], 1e-12)
    lam_r = jnp.maximum(lam, eig_floor * lam_max)
    cov_r = jnp.einsum("tik,tk,tjk->tij", V, lam_r, V)
    ok = cnt >= float(min_points)
    return PointCloud(
        xyz=jnp.where(ok[:, None], mu + center[None, :], PAD_COORD),
        mask=ok,
        covs=cov_r,
    )


def register_ndt(
    src: PointCloud,
    tgt: PointCloud,
    config: Optional[ICPConfig] = None,
    init: Optional[SE3] = None,
    *,
    cell_size: int = 64,
    eig_floor: float = 1e-2,
    point_cov: float = 1e-4,
    mode: str = "p2d",
) -> ICPResult:
    """Register src onto tgt's NDT cell distributions.

    `mode="p2d"` (default) scores every source POINT against its nearest
    target cell Gaussian (`point_cov` = isotropic source covariance, a
    measurement-noise floor in the Mahalanobis weights). `mode="d2d"`
    (Stoyanov et al. 2012) collapses BOTH clouds to cells and matches
    distribution-to-distribution — ~cell_size x fewer correspondences
    per iteration, natural for map-to-map alignment. Any `config`
    objective is overridden to the GICP solve; NN/robust/coarse settings
    pass through.
    """
    if mode not in ("p2d", "d2d"):
        raise ValueError("mode must be p2d|d2d")
    if config is None:
        config = ICPConfig(
            max_iters=30,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
        )
    cells = ndt_cells(tgt, cell_size=cell_size, eig_floor=eig_floor)
    if mode == "d2d":
        src_c = ndt_cells(src, cell_size=cell_size, eig_floor=eig_floor)
    else:
        n = src.capacity
        eye = jnp.broadcast_to(
            jnp.float32(point_cov) * jnp.eye(3, dtype=jnp.float32),
            (n, 3, 3),
        )
        src_c = src.replace(covs=eye)
    cfg = dataclasses.replace(config, objective="gicp")
    return register(src_c, cells, cfg, init)
