"""SE(3) rigid transforms as a functional pytree.

The reference threads `Eigen::Affine3f` through its pipeline
(`func.cpp:76-121`, `myicp.cpp:134-138`). Here a rigid transform is a pytree
``SE3(R, t)`` with batch-friendly leading dims, differentiable and usable
inside `jit`/`scan`/`shard_map`. Composition order matches Eigen/matrix
convention: ``(a @ b).apply(x) == a.apply(b.apply(x))``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from icpx import struct

_EPS = 1e-9
# Tiny bias inside sqrt so norms are differentiable at 0 (autodiff of
# ||x|| at x=0 is NaN otherwise; exp/log get jacfwd'd at zero twists by
# the pose-graph linearization). Primal error is sqrt(1e-24) = 1e-12.
_NORM_TINY = 1e-24


def _safe_norm(x, axis=-1, keepdims=False):
    return jnp.sqrt(jnp.sum(x * x, axis=axis, keepdims=keepdims) + _NORM_TINY)


@struct.dataclass
class SE3:
    """Rigid transform y = R @ x + t. R: (..., 3, 3), t: (..., 3)."""

    R: jax.Array
    t: jax.Array

    # ---- constructors ------------------------------------------------------

    @classmethod
    def identity(cls, batch_shape=(), dtype=jnp.float32) -> "SE3":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        t = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return cls(R=R, t=t)

    @classmethod
    def from_matrix(cls, m: jax.Array) -> "SE3":
        """From a (..., 4, 4) homogeneous matrix."""
        return cls(R=m[..., :3, :3], t=m[..., :3, 3])

    @classmethod
    def from_axis_angle(cls, axis, angle, t=None) -> "SE3":
        R = rotation_from_axis_angle(axis, angle)
        if t is None:
            t = jnp.zeros(R.shape[:-2] + (3,), R.dtype)
        return cls(R=R, t=jnp.asarray(t, R.dtype))

    @classmethod
    def from_rotvec(cls, rotvec, t=None) -> "SE3":
        """Axis-angle vector (angle = |rotvec|)."""
        rotvec = jnp.asarray(rotvec, jnp.float32)
        angle = jnp.linalg.norm(rotvec, axis=-1)
        axis = rotvec / jnp.maximum(angle[..., None], _EPS)
        return cls.from_axis_angle(axis, angle, t)

    @classmethod
    def exp(cls, twist: jax.Array) -> "SE3":
        """SE(3) exponential of a (..., 6) twist [omega, v]."""
        omega, v = twist[..., :3], twist[..., 3:]
        theta = _safe_norm(omega, keepdims=True)
        K = skew(omega / jnp.maximum(theta, _EPS))
        th = theta[..., None]
        s, c = jnp.sin(th), jnp.cos(th)
        eye = jnp.eye(3, dtype=twist.dtype)
        R = eye + s * K + (1.0 - c) * (K @ K)
        # V = I + ((1-cos θ)/θ) K + ((θ - sin θ)/θ) K²   (K built from unit axis)
        small = theta[..., None] < 1e-5
        th_safe = jnp.maximum(th, _EPS)
        V = eye + ((1.0 - c) / th_safe) * K + (1.0 - s / th_safe) * (K @ K)
        V = jnp.where(small, eye, V)
        R = jnp.where(small, eye + skew(omega), R)
        t = jnp.einsum("...ij,...j->...i", V, v)
        return cls(R=R, t=t)

    def log(self) -> jax.Array:
        """(..., 6) twist [omega, v] with SE3.exp(log(T)) == T."""
        omega = rotation_log(self.R)
        theta = _safe_norm(omega, keepdims=True)
        K = skew(omega / jnp.maximum(theta, _EPS))
        th = theta[..., None]
        half = 0.5 * th
        # V^{-1} = I - θ/2 K + (1 - θ/2 cot(θ/2)) K²
        cot_term = 1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)
        eye = jnp.eye(3, dtype=self.R.dtype)
        Vinv = eye - half * K + cot_term * (K @ K)
        Vinv = jnp.where(th < 1e-5, eye - 0.5 * skew(omega), Vinv)
        v = jnp.einsum("...ij,...j->...i", Vinv, self.t)
        return jnp.concatenate([omega, v], axis=-1)

    @classmethod
    def random(cls, key, batch_shape=(), max_angle=jnp.pi, max_trans=1.0) -> "SE3":
        k1, k2, k3 = jax.random.split(key, 3)
        axis = jax.random.normal(k1, (*batch_shape, 3))
        axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
        angle = jax.random.uniform(k2, batch_shape, minval=0.0, maxval=max_angle)
        t = jax.random.uniform(
            k3, (*batch_shape, 3), minval=-max_trans, maxval=max_trans
        )
        return cls.from_axis_angle(axis, angle, t)

    # ---- ops ---------------------------------------------------------------

    def apply(self, points: jax.Array) -> jax.Array:
        """Transform (..., N, 3) points: R @ p + t."""
        return (
            jnp.einsum("...ij,...nj->...ni", self.R, points) + self.t[..., None, :]
        )

    def rotate(self, vectors: jax.Array) -> jax.Array:
        """Rotate direction vectors / normals — no translation.

        The reference buggily translates normals too (`myicp.cpp:137` →
        `func.cpp:110-120` pads with 1); this is the correct path.
        """
        return jnp.einsum("...ij,...nj->...ni", self.R, vectors)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first."""
        return SE3(
            R=self.R @ other.R,
            t=jnp.einsum("...ij,...j->...i", self.R, other.t) + self.t,
        )

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return SE3(R=Rt, t=-jnp.einsum("...ij,...j->...i", Rt, self.t))

    def matrix(self) -> jax.Array:
        """(..., 4, 4) homogeneous matrix."""
        batch = self.t.shape[:-1]
        m = jnp.zeros((*batch, 4, 4), self.R.dtype)
        m = m.at[..., :3, :3].set(self.R)
        m = m.at[..., :3, 3].set(self.t)
        m = m.at[..., 3, 3].set(1.0)
        return m

    # ---- metrics -----------------------------------------------------------

    def rotation_angle(self) -> jax.Array:
        """Geodesic rotation magnitude in radians."""
        tr = jnp.trace(self.R, axis1=-2, axis2=-1)
        return jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))

    def distance_to(self, other: "SE3"):
        """(rotation angle, translation distance) between two transforms."""
        rel = self.inverse() @ other
        return rel.rotation_angle(), jnp.linalg.norm(rel.t, axis=-1)


# ---- free functions ---------------------------------------------------------


def skew(v: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def rotation_from_axis_angle(axis, angle) -> jax.Array:
    """Rodrigues: unit axis (..., 3), angle (...) -> (..., 3, 3)."""
    axis = jnp.asarray(axis, jnp.float32)
    angle = jnp.asarray(angle, jnp.float32)
    K = skew(axis)
    s = jnp.sin(angle)[..., None, None]
    c = jnp.cos(angle)[..., None, None]
    eye = jnp.eye(3, dtype=axis.dtype)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotation_log(R: jax.Array) -> jax.Array:
    """SO(3) log map -> (..., 3) rotation vector.

    Safe near 0 and pi, including under autodiff: theta comes from atan2
    (finite derivatives at identity, unlike arccos whose derivative blows
    up at cos=1) with a guarded norm for the skew part.
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    # Generic: omega_hat = θ/(2 sinθ) (R - Rᵀ)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = 0.5 * _safe_norm(w)
    theta = jnp.arctan2(sin_theta, cos_theta)
    scale = jnp.where(
        theta[..., None] < 1e-5,
        0.5 + theta[..., None] ** 2 / 12.0,  # series of θ/(2 sinθ)
        theta[..., None] / jnp.maximum(2.0 * sin_theta[..., None], _EPS),
    )
    generic = scale * w
    # Near pi: recover the axis from the columns of R + I (each is
    # 2 cos^2(θ/2)-scaled axis at θ=π); pick the largest for stability.
    A = R + jnp.eye(3, dtype=R.dtype)
    col = jnp.argmax(jnp.linalg.norm(A, axis=-2), axis=-1)
    axis_pi = jnp.take_along_axis(A, col[..., None, None], axis=-1)[..., 0]
    axis_pi = axis_pi / jnp.maximum(
        jnp.linalg.norm(axis_pi, axis=-1, keepdims=True), _EPS
    )
    # Fix sign with the skew part (zero exactly at π; any sign is correct there)
    sign = jnp.where(jnp.sum(axis_pi * w, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    near_pi = (jnp.pi - theta)[..., None] < 1e-3
    return jnp.where(near_pi, sign * axis_pi * theta[..., None], generic)
