"""Closed-form 3x3 symmetric eigendecomposition, batched & branchless.

The reference gets its normal PCA from PCL (`pcl::NormalEstimation`,
`myicp.cpp:157-167`), which uses a closed-form 3x3 solver internally. A
LAPACK-style iterative eigensolver is a poor fit for batched SIMD; the analytic
trigonometric method (Smith 1961 / Eberly) is pure elementwise math that
`vmap`s over millions of neighborhoods. fp32 throughout.

Layout note: the core runs in SoA (structure-of-arrays) form — six (N,)
component vectors in, (N,) component math throughout — so its ~40
temporaries are contiguous (N,) vectors instead of (N, 3, 3)/(N, 3)
arrays with tiny minor dimensions. The (..., 3, 3) wrappers below keep
the public API.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-12


def _unpack(A: jax.Array):
    return (
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )


def eigvalsh3x3_soa(a00, a01, a02, a11, a12, a22):
    """Eigenvalues (ascending, 3-tuple of (...,)) of the symmetric
    matrices [[a00,a01,a02],[a01,a11,a12],[a02,a12,a22]] via the
    trigonometric closed form (branchless, diag-safe)."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    p_safe = jnp.maximum(p, _EPS)
    # det(B)/2 with B = (A - qI)/p
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p_safe * p_safe * p_safe)
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # Degenerate (p ~ 0): matrix is (numerically) q*I.
    isdiag = p < _EPS
    e_lo = jnp.where(isdiag, q, e_lo)
    e_mid = jnp.where(isdiag, q, e_mid)
    e_hi = jnp.where(isdiag, q, e_hi)
    return e_lo, e_mid, e_hi


def _eigenvector_soa(a00, a01, a02, a11, a12, a22, lam):
    """Unit eigenvector for eigenvalue lam, all-(N,) math.

    Rows of (A - lam I) span the orthogonal complement of the
    eigenvector, so cross products of row pairs all lie along it; take
    the largest for numerical robustness, with a fixed fallback for the
    isotropic case. Returns (vx, vy, vz) components."""
    b00, b11, b22 = a00 - lam, a11 - lam, a22 - lam
    # rows: r0=(b00,a01,a02) r1=(a01,b11,a12) r2=(a02,a12,b22)
    c01x = a01 * a12 - a02 * b11
    c01y = a02 * a01 - b00 * a12
    c01z = b00 * b11 - a01 * a01
    c02x = a01 * b22 - a02 * a12
    c02y = a02 * a02 - b00 * b22
    c02z = b00 * a12 - a01 * a02
    c12x = b11 * b22 - a12 * a12
    c12y = a12 * a02 - a01 * b22
    c12z = a01 * a12 - b11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)

    def pick(x01, x02, x12):
        return jnp.where(use01, x01, jnp.where(use02, x02, x12))

    vx = pick(c01x, c02x, c12x)
    vy = pick(c01y, c02y, c12y)
    vz = pick(c01z, c02z, c12z)
    # Scale-invariant normalization: covariances of millimeter-spacing
    # neighborhoods have cross products ~1e-12, at/below any absolute
    # epsilon (an earlier version thresholded the SQUARED norm
    # there and sent every 1M-cloud normal to the isotropic fallback,
    # diverging the registration; the AoS original's `/max(nrm, 1e-12)`
    # also under-normalized at that scale). Dividing by the largest
    # component first puts the norm in [1, sqrt(3)] — exact for any
    # representable input.
    m = jnp.maximum(
        jnp.maximum(jnp.abs(vx), jnp.abs(vy)), jnp.abs(vz)
    )
    ok = m > 1e-30
    m_safe = jnp.where(ok, m, 1.0)
    ux, uy, uz = vx / m_safe, vy / m_safe, vz / m_safe
    inv = 1.0 / jnp.sqrt(ux * ux + uy * uy + uz * uz)
    # Isotropic fallback: any unit vector is an eigenvector.
    vx = jnp.where(ok, ux * inv, 0.0)
    vy = jnp.where(ok, uy * inv, 0.0)
    vz = jnp.where(ok, uz * inv, 1.0)
    return vx, vy, vz


def smallest_eigenvector_3x3_soa(a00, a01, a02, a11, a12, a22):
    """((vx, vy, vz), (e_lo, e_mid, e_hi)) — the SoA fast path for
    producers that hold covariance COMPONENTS (e.g. moment folds):
    never materializes an (N, 3, 3) tensor."""
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(a00, a01, a02, a11, a12, a22)
    v = _eigenvector_soa(a00, a01, a02, a11, a12, a22, e_lo)
    return v, (e_lo, e_mid, e_hi)


def eigh3x3(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices.

    Returns (eigvals (..., 3) ascending, eigvecs (..., 3, 3) with
    eigvecs[..., :, i] the i-th eigenvector).
    """
    comps = _unpack(A)
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(*comps)
    v0 = jnp.stack(_eigenvector_soa(*comps, e_lo), axis=-1)
    v2 = jnp.stack(_eigenvector_soa(*comps, e_hi), axis=-1)
    # Middle eigenvector: orthogonal complement (robust for distinct eigs;
    # for repeated eigs any orthonormal completion is valid).
    v1 = jnp.cross(v2, v0)
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), _EPS)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1), V


def eigvalsh3x3(A: jax.Array) -> jax.Array:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) via the
    trigonometric closed form (branchless, diag-safe)."""
    e_lo, e_mid, e_hi = eigvalsh3x3_soa(*_unpack(jnp.asarray(A)))
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def smallest_eigenvector_3x3(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(unit eigenvector for smallest eigenvalue, eigenvalues ascending).

    The normal-estimation primitive: the smallest-eigenvalue direction of a
    neighborhood covariance is the surface normal.
    """
    comps = _unpack(jnp.asarray(A))
    (vx, vy, vz), (e_lo, e_mid, e_hi) = smallest_eigenvector_3x3_soa(
        *comps
    )
    return (
        jnp.stack([vx, vy, vz], axis=-1),
        jnp.stack([e_lo, e_mid, e_hi], axis=-1),
    )
