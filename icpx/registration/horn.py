"""Closed-form rigid registration with known correspondences (Horn/Kabsch).

Batched JAX rebuild of the reference's header-only `registrateNPoint`
(`regist.h:8-72`): weighted centroids, 3x3 cross-covariance, SVD with the
reflection (det) fix, t = q_bar - R p_bar. Unlike the reference (which maps
dst onto src with a transposed convention, `regist.h:7`), this maps
src -> dst: q ~= R p + t — and supports weights and batching, serving both
as the unit-test oracle and as the inner solve of point-to-point ICP.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from icpx.geometry.se3 import SE3

_EPS = 1e-12


def horn_align(
    src: jax.Array,
    dst: jax.Array,
    weights: Optional[jax.Array] = None,
) -> SE3:
    """Least-squares rigid fit: argmin_{R,t} sum_i w_i ||R p_i + t - q_i||^2.

    Args:
      src: (..., N, 3) source points p.
      dst: (..., N, 3) corresponding destination points q.
      weights: optional (..., N) nonnegative weights (0 drops a pair).

    Returns: SE3 mapping src into dst.
    """
    R, t, _ = _weighted_kabsch(src, dst, weights, with_scale=False)
    return SE3(R=R, t=t)


def umeyama_align(
    src: jax.Array,
    dst: jax.Array,
    weights: Optional[jax.Array] = None,
) -> Tuple[SE3, jax.Array]:
    """Similarity fit (Umeyama): returns (SE3, scale) with q ~= s R p + t.

    Used by odometry evaluation (ATE alignment) and as a scale-aware oracle.
    """
    R, t, s = _weighted_kabsch(src, dst, weights, with_scale=True)
    return SE3(R=R, t=t), s


def _weighted_kabsch(src, dst, weights, *, with_scale: bool):
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    n = src.shape[-2]
    if weights is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    else:
        w = jnp.asarray(weights, src.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), _EPS)
    wn = w / wsum  # (..., N)

    p_bar = jnp.einsum("...n,...ni->...i", wn, src)
    q_bar = jnp.einsum("...n,...ni->...i", wn, dst)
    pc = src - p_bar[..., None, :]
    qc = dst - q_bar[..., None, :]

    # Cross-covariance S = sum_i w_i q_c p_c^T  (3x3)
    S = jnp.einsum("...n,...ni,...nj->...ij", wn, qc, pc)
    U, sig, Vt = jnp.linalg.svd(S)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    D = jnp.ones(S.shape[:-2] + (3,), S.dtype)
    D = D.at[..., 2].set(jnp.sign(det) + (det == 0.0))  # det fix, 0-safe
    R = jnp.einsum("...ik,...k,...kj->...ij", U, D, Vt)

    if with_scale:
        var_p = jnp.einsum("...n,...ni,...ni->...", wn, pc, pc)
        s = jnp.sum(sig * D, axis=-1) / jnp.maximum(var_p, _EPS)
    else:
        s = jnp.ones(S.shape[:-2], S.dtype)
    t = q_bar - s[..., None] * jnp.einsum("...ij,...j->...i", R, p_bar)
    return R, t, s
