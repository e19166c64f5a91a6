"""kNN + PCA surface-normal estimation.

The batched equivalent of `pcl::NormalEstimation` with `setKSearch(k)`
(`myicp.cpp:152-172`, k=10 at `myicp.cpp:160`): for each point, gather its
k nearest neighbors (self included, matching PCL's kNN semantics), form the
3x3 neighborhood covariance, and take the smallest-eigenvalue direction via
the closed-form solver — all batched over the whole cloud, no KD-tree.

Two kNN paths: brute-force (exact, O(N^2), small clouds) and the Morton
block index (O(N*K*S), the 1M+ path). Neighbors with infinite distance
(misses, masked refs, k > n) are excluded from the covariance by weight.

Normals are oriented toward the viewpoint (PCL default viewpoint (0,0,0)),
which is what makes the symmetric objective's n_p + n_q sums coherent
across the two clouds.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icpx.cloud import PointCloud
from icpx.kernels.eigh3 import smallest_eigenvector_3x3
from icpx.kernels.knn import knn

_EPS = 1e-12
BLOCK_THRESHOLD = 32768


@partial(jax.jit, static_argnames=("k", "method"))
def estimate_normals_xyz(
    xyz: jax.Array,
    mask: Optional[jax.Array] = None,
    *,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
) -> Tuple[jax.Array, jax.Array]:
    """Estimate normals for (N, 3) points.

    Returns (normals (N, 3) unit, curvature (N,)) where curvature is PCL's
    surface-variation lambda_0 / (lambda_0+lambda_1+lambda_2).

    method="brute" is exact k-NN PCA; method="block" (auto above 32768
    points) is radius PCA with the radius derived from k (the radius that
    holds ~k surface neighbors) — same statistics, different neighborhood
    definition; see `_block_radius_cov`.
    """
    n = xyz.shape[0]
    mask = jnp.ones((n,), bool) if mask is None else mask
    if method == "auto":
        method = "block" if n >= BLOCK_THRESHOLD else "brute"

    if method == "block":
        cnt, cov = _block_radius_cov(xyz, mask, k)
        normal, ev = smallest_eigenvector_3x3(cov)
        total = jnp.maximum(ev[..., 0] + ev[..., 1] + ev[..., 2], 1e-20)
        curv = jnp.maximum(ev[..., 0], 0.0) / total
        vp = jnp.asarray(viewpoint, xyz.dtype)
        flip = jnp.sum(normal * (vp[None, :] - xyz), axis=-1) < 0.0
        normal = jnp.where(flip[:, None], -normal, normal)
        # degenerate neighborhoods (< 3 points in radius): no normal
        ok = cnt >= 3.0
        normals = jnp.where(ok[:, None], normal, 0.0)
        curv = jnp.where(ok, curv, 0.0)
    else:
        d2, idx = knn(xyz, xyz, k, ref_mask=mask)
        normals, curv = _pca_normals(xyz, xyz[idx], d2, viewpoint)

    normals = jnp.where(mask[:, None], normals, 0.0)
    curv = jnp.where(mask, curv, 0.0)
    return normals, curv


def _block_radius_cov(xyz, mask, k):
    """Shared large-cloud neighborhood covariance: gather-free radius
    moments in ORIGINAL point order.

    The k parameter maps to an equivalent search radius (~ the radius
    containing k neighbors on a surface: spacing * 3 * sqrt(k/10), which
    matches the kNN path at the default k=10) — PCL's `setRadiusSearch`
    mode (cf. the rejected alternative at `myicp.cpp:161`).

    Returns (count (N,), cov (N, 3, 3)).
    """
    from icpx.kernels.blocknn import block_radius_moments, build_kd_index
    from icpx.kernels.voxel import auto_cell_size

    n = xyz.shape[0]
    # KD-split self-query tiles: the index tiles double as query tiles (a
    # tile is always its own best candidate), and compact boxes keep the
    # candidate set tight (see build_kd_index).
    idx = build_kd_index(xyz, mask, tile_size=128)
    scale = 3.0 * float(np.sqrt(max(k, 1) / 10.0))
    radius = auto_cell_size(xyz, mask, scale=scale)
    cnt_s, _, cov_s = block_radius_moments(
        idx.tiles, idx, radius, k_tiles=8
    )
    # unsort: sorted position -> original row (pads dropped)
    order = idx.order
    safe = jnp.where(order >= 0, order, n)
    cov = (
        jnp.zeros((n + 1, 3, 3), jnp.float32)
        .at[safe]
        .set(cov_s, mode="drop")[:n]
    )
    cnt = (
        jnp.zeros((n + 1,), jnp.float32)
        .at[safe]
        .set(cnt_s, mode="drop")[:n]
    )
    return cnt, cov


def _pca_normals(query, neigh, d2, viewpoint):
    """Weighted-PCA normal per query from (N, k, 3) neighbors; neighbors
    with infinite distance are excluded."""
    w = jnp.isfinite(d2).astype(jnp.float32)  # (N, k)
    wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1.0)
    mean = jnp.sum(neigh * w[..., None], axis=1, keepdims=True) / wsum[..., None]
    centered = (neigh - mean) * w[..., None]
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / wsum[..., None]
    normal, ev = smallest_eigenvector_3x3(cov)
    total = jnp.maximum(ev[..., 0] + ev[..., 1] + ev[..., 2], 1e-20)
    curvature = jnp.maximum(ev[..., 0], 0.0) / total
    vp = jnp.asarray(viewpoint, query.dtype)
    flip = jnp.sum(normal * (vp[None, :] - query), axis=-1) < 0.0
    normal = jnp.where(flip[:, None], -normal, normal)
    return normal, curvature


def estimate_normals(
    cloud: PointCloud,
    *,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    method: str = "auto",
) -> PointCloud:
    """Return the cloud with PCA normals attached (k=10 default, matching
    the reference's `setKSearch(10)`)."""
    normals, _ = estimate_normals_xyz(
        cloud.xyz, cloud.mask, k=k, viewpoint=viewpoint, method=method
    )
    return cloud.replace(normals=normals)


@partial(jax.jit, static_argnames=("k", "method"))
def _covariances_xyz(xyz, mask, *, k, epsilon, method):
    from icpx.kernels.eigh3 import eigh3x3

    n = xyz.shape[0]
    if method == "auto":
        method = "block" if n >= BLOCK_THRESHOLD else "brute"
    if method == "block":
        count, cov = _block_radius_cov(xyz, mask, k)
    else:
        d2, idx = knn(xyz, xyz, k, ref_mask=mask)
        neigh = xyz[idx]
        wv = jnp.isfinite(d2).astype(jnp.float32)
        wsum = jnp.maximum(jnp.sum(wv, axis=1, keepdims=True), 1.0)
        mean = (
            jnp.sum(neigh * wv[..., None], axis=1, keepdims=True)
            / wsum[..., None]
        )
        centered = (neigh - mean) * wv[..., None]
        cov = jnp.einsum("nki,nkj->nij", centered, centered) / wsum[..., None]
        count = jnp.sum(wv, axis=1)

    # GICP plane-to-plane regularization: replace eigenvalues with
    # (epsilon, 1, 1) — confident along the surface, soft along the normal.
    w, V = eigh3x3(cov)
    d = jnp.stack(
        [jnp.full_like(w[..., 0], epsilon), jnp.ones_like(w[..., 0]),
         jnp.ones_like(w[..., 0])],
        axis=-1,
    )
    reg = jnp.einsum("nik,nk,njk->nij", V, d, V)
    # degenerate neighborhoods: isotropic identity (no orientation info)
    ok = (count >= 3.0) & mask
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), reg.shape)
    reg = jnp.where(ok[:, None, None], reg, eye)
    normal = V[..., 0]  # smallest-eigenvalue direction
    normal = jnp.where(ok[:, None], normal, 0.0)
    return reg, normal


def estimate_covariances(
    cloud: PointCloud,
    *,
    k: int = 20,
    epsilon: float = 1e-3,
    method: str = "auto",
) -> PointCloud:
    """Attach GICP-regularized neighborhood covariances (Segal et al.
    2009): eigenvalues replaced by (epsilon, 1, 1) so each point carries a
    'plane-to-plane' information model. Also fills normals if absent."""
    covs, normal = _covariances_xyz(
        cloud.xyz, cloud.mask, k=k, epsilon=epsilon, method=method
    )
    out = cloud.replace(covs=covs)
    if out.normals is None:
        out = out.replace(
            normals=jnp.where(cloud.mask[:, None], normal, 0.0)
        )
    return out
