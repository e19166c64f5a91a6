"""Closed-form 3x3 symmetric eigensolver vs numpy (oracle)."""

import numpy as np

from icpx.kernels.eigh3 import eigh3x3, eigvalsh3x3, smallest_eigenvector_3x3


def _random_sym(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


def test_eigvals_match_numpy(rng):
    A = _random_sym(rng, 256)
    w = np.asarray(eigvalsh3x3(A))
    w_np = np.linalg.eigvalsh(A)
    assert np.allclose(w, w_np, atol=2e-4)


def test_eigvecs_are_eigvecs(rng):
    A = _random_sym(rng, 128)
    w, V = eigh3x3(A)
    w, V = np.asarray(w), np.asarray(V)
    for i in range(3):
        Av = np.einsum("nij,nj->ni", A, V[:, :, i])
        lv = w[:, i : i + 1] * V[:, :, i]
        assert np.allclose(Av, lv, atol=5e-3)


def test_smallest_eigenvector_plane(rng):
    """Covariance of points on the z=0 plane -> smallest eig dir = +-z."""
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    pts[:, 2] = 0.001 * pts[:, 2]
    C = (pts - pts.mean(0)).T @ (pts - pts.mean(0)) / len(pts)
    v, w = smallest_eigenvector_3x3(C[None])
    v = np.asarray(v)[0]
    assert abs(abs(v[2]) - 1.0) < 1e-3


def test_isotropic_degenerate():
    A = np.eye(3, dtype=np.float32)[None] * 2.0
    w = np.asarray(eigvalsh3x3(A))
    assert np.allclose(w, 2.0, atol=1e-6)
    v, _ = smallest_eigenvector_3x3(A)
    assert np.isfinite(np.asarray(v)).all()
    assert abs(np.linalg.norm(np.asarray(v)[0]) - 1.0) < 1e-5


def test_repeated_eigenvalues():
    A = np.diag([1.0, 1.0, 5.0]).astype(np.float32)[None]
    w, V = eigh3x3(A)
    # fp32 trig method: ~1e-3 absolute accuracy at repeated eigenvalues
    assert np.allclose(np.asarray(w)[0], [1.0, 1.0, 5.0], atol=2e-3)
    # eigenvector for 5.0 must be +-z
    v2 = np.asarray(V)[0, :, 2]
    assert abs(abs(v2[2]) - 1.0) < 1e-4


def test_small_scale_covariances_no_fallback():
    """Millimeter-spacing neighborhoods produce covariance entries
    ~1e-6 whose eigenvector cross products have norms ~1e-12: the
    solver must normalize them, not hit the isotropic fallback (an
    earlier version thresholded the SQUARED norm and sent every
    1M-cloud normal to [0,0,1], diverging the registration)."""
    import numpy as np

    from icpx.kernels.eigh3 import smallest_eigenvector_3x3

    rng = np.random.default_rng(0)
    # planar neighborhoods at 1e-3 spacing: cov ~ diag(s^2, s^2, tiny)
    # rotated randomly; the normal must be the plane normal, not z-hat
    s = 1e-3
    normals = rng.normal(size=(256, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    covs = []
    for nrm in normals:
        # orthonormal frame with nrm as the third axis
        a = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(nrm[0]) > 0.9:
            a = np.array([0.0, 1.0, 0.0], np.float32)
        u = np.cross(nrm, a); u /= np.linalg.norm(u)
        v = np.cross(nrm, u)
        C = s * s * (np.outer(u, u) + np.outer(v, v)) \
            + (0.01 * s) ** 2 * np.outer(nrm, nrm)
        covs.append(C.astype(np.float32))
    covs = np.stack(covs)
    vec, w = smallest_eigenvector_3x3(covs)
    vec = np.asarray(vec)
    # every returned vector is unit and aligned with the plane normal
    nn = np.linalg.norm(vec, axis=1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-4)
    dots = np.abs(np.sum(vec * normals, axis=1))
    assert dots.min() > 0.999, float(dots.min())
