"""Shared per-iteration ICP core, parameterized over the reduction.

One function serves both execution modes:
  * single device — `reduce` is the identity;
  * sharded over a `points` mesh axis (SURVEY.md §2.3 P2) — `reduce` is
    `lax.psum(..., axis_name)`, so the 6x6 normal equations, centroids and
    convergence scalars are the ONLY cross-device traffic per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from icpx.geometry.se3 import SE3
from icpx.registration.linearize import (
    build_normal_equations_p2plane,
    build_normal_equations_symmetric,
    mad_scale,
    robust_weight,
)
from icpx.registration.solve import (
    reconstruct_p2plane_transform,
    reconstruct_symmetric_transform,
    solve_damped_6x6,
)

_EPS = 1e-12


def identity_reduce(x):
    """The single-device `reduce` (shared sentinel: robust statistics
    switch to reduced-histogram quantiles iff `reduce` is not this)."""
    return x


class StepStats(NamedTuple):
    diff: jax.Array  # evalDiff-style sum of corresponded distances
    rmse: jax.Array  # inlier euclidean RMSE (post-update)
    inlier_count: jax.Array


def correspondence_weights(
    config,
    p: jax.Array,
    n_p: jax.Array,
    q: jax.Array,
    n_q: jax.Array,
    dist: jax.Array,
    src_mask: jax.Array,
    reduce: Callable = identity_reduce,
) -> jax.Array:
    """Validity gate + robust IRLS weights for the current correspondences.

    With a collective `reduce` (sharded mode), the MAD scale and trim
    quantile are computed over the GLOBAL correspondence set via psum'd
    histograms (`_reduced_quantile`), so robust weights are
    shard-count-independent by construction (the
    per-shard statistics made results depend on the mesh layout).
    """
    sharded = reduce is not identity_reduce
    valid = src_mask & (dist <= config.max_corr_dist) & jnp.isfinite(dist)
    vmask = valid.astype(jnp.float32)
    trim = getattr(config, "trim_fraction", 1.0)
    if trim < 1.0:
        # Trimmed ICP (Chetverikov): keep only the closest `trim` fraction
        # of correspondences — robust to partial overlap without tuning a
        # distance gate.
        if sharded:
            thr = _reduced_quantile(dist, vmask, trim, reduce)
        else:
            thr = _masked_quantile(dist, vmask, trim)
        valid = valid & (dist <= thr)
        vmask = valid.astype(jnp.float32)
    if config.robust == "none":
        return vmask
    if config.objective == "symmetric":
        r_w = jnp.abs(jnp.sum((p - q) * (n_p + n_q), axis=-1))
    elif config.objective == "p2plane":
        r_w = jnp.abs(jnp.sum((p - q) * n_q, axis=-1))
    else:
        r_w = dist
    if config.robust_scale > 0:
        scale = jnp.float32(config.robust_scale)
    elif sharded:
        med = _reduced_quantile(r_w, vmask, 0.5, reduce)
        dev = jnp.abs(r_w - jnp.where(jnp.isfinite(med), med, 0.0))
        mad = _reduced_quantile(dev, vmask, 0.5, reduce)
        mad = jnp.where(jnp.isfinite(mad), mad, 1.0)
        scale = 1.4826 * jnp.maximum(mad, _EPS)
    else:
        scale = mad_scale(r_w, vmask)
    return vmask * robust_weight(r_w, config.robust, scale)


def _reduced_quantile(
    x: jax.Array,
    vmask: jax.Array,
    q: float,
    reduce: Callable,
    n_bins: int = 128,
) -> jax.Array:
    """Masked quantile over ALL shards: two-level psum'd histogram.

    Range comes from reduced moments (mean + 8 sigma upper bound — values
    above clamp into the last bin, so extreme-tail quantiles saturate
    there); two refinement levels give resolution range/n_bins^2, ~1e-4
    relative, far below robust-weight sensitivity. Deterministic in the
    global point set: bin counts psum identically under any shard layout.
    Returns +inf when no entry is valid.
    """
    v = vmask > 0
    xs = jnp.where(v, x, 0.0)
    vf = v.astype(jnp.float32)
    cnt, s1, s2 = reduce(
        (jnp.sum(vf), jnp.sum(xs), jnp.sum(xs * xs))
    )
    cntc = jnp.maximum(cnt, 1.0)
    mean = s1 / cntc
    var = jnp.maximum(s2 / cntc - mean * mean, 0.0)
    hi = mean + 8.0 * jnp.sqrt(var) + jnp.float32(_EPS)
    lo = jnp.float32(0.0)
    rank = jnp.float32(q) * cnt

    for _ in range(2):
        width = jnp.maximum(hi - lo, jnp.float32(_EPS))
        idx = jnp.clip(
            ((xs - lo) / width * n_bins).astype(jnp.int32), 0, n_bins - 1
        )
        h = reduce(jnp.zeros((n_bins,), jnp.float32).at[idx].add(vf))
        csum = jnp.cumsum(h)
        b = jnp.argmax(csum >= rank).astype(jnp.int32)
        b = jnp.where(csum[n_bins - 1] >= rank, b, n_bins - 1)
        below = jnp.where(b > 0, csum[jnp.maximum(b - 1, 0)], 0.0)
        step = width / n_bins
        lo, hi = lo + b.astype(jnp.float32) * step, lo + (
            b.astype(jnp.float32) + 1.0
        ) * step
        rank = rank - below
    return jnp.where(cnt > 0, hi, jnp.float32(jnp.inf))


def _masked_quantile(x: jax.Array, w_valid: jax.Array, q: float) -> jax.Array:
    """Quantile of x over entries with w_valid > 0 (static shapes)."""
    n = x.shape[0]
    vals = jnp.sort(jnp.where(w_valid > 0, x, jnp.inf))
    cnt = jnp.sum((w_valid > 0).astype(jnp.int32))
    idx = jnp.clip((cnt.astype(jnp.float32) * q).astype(jnp.int32), 0, n - 1)
    v = vals[idx]
    return jnp.where(jnp.isfinite(v), v, jnp.float32(jnp.inf))


def estimate_increment(
    config,
    p: jax.Array,
    q: jax.Array,
    n_p: jax.Array,
    n_q: jax.Array,
    w: jax.Array,
    reduce: Callable = lambda x: x,
) -> SE3:
    """One Gauss-Newton / closed-form update from weighted correspondences.

    `reduce` must sum pytrees of arrays across the points axis partition
    (identity on a single device). All participating devices return the
    same increment, keeping the accumulated transform replicated.
    """
    # Global weighted centroids (two-phase: local sums -> reduce).
    local = (
        jnp.sum(w),
        jnp.sum(p * w[:, None], axis=0),
        jnp.sum(q * w[:, None], axis=0),
    )
    wsum, p_num, q_num = reduce(local)
    denom = jnp.maximum(wsum, _EPS)
    p_bar, q_bar = p_num / denom, q_num / denom

    if config.objective == "p2p":
        # Weighted Kabsch from reduced sufficient statistics: the 3x3
        # cross-covariance psums exactly like the 6x6 JtJ.
        pc = p - p_bar[None, :]
        qc = q - q_bar[None, :]
        S_local = jnp.einsum("n,ni,nj->ij", w, qc, pc)
        S = reduce(S_local) / denom
        U, _, Vt = jnp.linalg.svd(S)
        det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
        D = jnp.ones((3,), S.dtype).at[2].set(jnp.sign(det) + (det == 0.0))
        R = jnp.einsum("ik,k,kj->ij", U, D, Vt)
        t = q_bar - R @ p_bar
        return SE3(R=R, t=t)

    if config.objective == "gicp":
        from icpx.registration.linearize import build_normal_equations_gicp
        from icpx.registration.solve import reconstruct_about_point

        ne = build_normal_equations_gicp(
            p,
            q,
            n_p.reshape(-1, 3, 3),
            n_q.reshape(-1, 3, 3),
            w,
            p_bar,
        )
        JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
        x = solve_damped_6x6(
            JtJ, Jtr, config.damping,
            getattr(config, "degeneracy_clamp", 0.0),
        )
        return reconstruct_about_point(x, p_bar)

    if config.objective == "symmetric":
        ne = build_normal_equations_symmetric(p, q, n_p, n_q, w, p_bar, q_bar)
        JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
        x = solve_damped_6x6(
            JtJ, Jtr, config.damping,
            getattr(config, "degeneracy_clamp", 0.0),
        )
        return reconstruct_symmetric_transform(x, p_bar, q_bar)

    ne = build_normal_equations_p2plane(p, q, n_q, w)
    JtJ, Jtr = reduce((ne.JtJ, ne.Jtr))
    x = solve_damped_6x6(
        JtJ, Jtr, config.damping, getattr(config, "degeneracy_clamp", 0.0)
    )
    return reconstruct_p2plane_transform(x)


def step_stats(
    config,
    p_new: jax.Array,
    q: jax.Array,
    dist_old: jax.Array,
    src_mask: jax.Array,
    reduce: Callable = lambda x: x,
) -> StepStats:
    """Convergence metrics vs the iteration's correspondences."""
    valid = src_mask & (dist_old <= config.max_corr_dist) & jnp.isfinite(dist_old)
    vmask = valid.astype(jnp.float32)
    d_new = jnp.linalg.norm(p_new - q, axis=-1)
    local = (
        jnp.sum(jnp.where(valid, d_new, 0.0)),
        jnp.sum(vmask * d_new * d_new),
        jnp.sum(vmask),
    )
    diff, sq, count = reduce(local)
    # clamp only the divisor: the reported count must stay truthful (a
    # zero-inlier iteration is a failure signal callers rely on)
    return StepStats(
        diff=diff,
        rmse=jnp.sqrt(sq / jnp.maximum(count, 1.0)),
        inlier_count=count,
    )
