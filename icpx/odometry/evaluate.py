"""Trajectory evaluation: ATE and RPE (standard odometry metrics).

The reference has no quantitative evaluation beyond printing a transform
(`myicp.cpp:146-149`); these are the formal replacements used by the
bench/odometry configs (the ATE gate of bench.py --odometry).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from icpx.geometry.se3 import SE3
from icpx.registration.horn import horn_align


def _stack(poses: Sequence[SE3]) -> SE3:
    if isinstance(poses, SE3):
        return poses
    return SE3(
        R=jnp.stack([p.R for p in poses]), t=jnp.stack([p.t for p in poses])
    )


def ate_rmse(
    est: Sequence[SE3], gt: Sequence[SE3], *, align: bool = True
) -> float:
    """Absolute trajectory error: RMSE of position residuals after an
    optional rigid SE(3) alignment."""
    est_s, gt_s = _stack(est), _stack(gt)
    p, q = est_s.t, gt_s.t
    if align:
        # rigid (SE(3)) alignment — a similarity fit would leave a
        # centroid-dependent residual when its scale is discarded
        T = horn_align(p, q)
        p = T.apply(p)
    err = np.asarray(jnp.linalg.norm(p - q, axis=-1))
    return float(np.sqrt((err**2).mean()))


def rpe(
    est: Sequence[SE3], gt: Sequence[SE3], *, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame intervals.

    Returns (translation RMSE, rotation RMSE in radians).
    """
    est_s, gt_s = _stack(est), _stack(gt)
    m = est_s.t.shape[0]
    if m <= delta:
        return 0.0, 0.0
    idx_a = jnp.arange(0, m - delta)
    idx_b = idx_a + delta

    def rel(T: SE3, a, b) -> SE3:
        Ta = SE3(R=T.R[a], t=T.t[a])
        Tb = SE3(R=T.R[b], t=T.t[b])
        return Ta.inverse() @ Tb

    rel_est = rel(est_s, idx_a, idx_b)
    rel_gt = rel(gt_s, idx_a, idx_b)
    err = rel_gt.inverse() @ rel_est
    t_err = np.asarray(jnp.linalg.norm(err.t, axis=-1))
    r_err = np.asarray(err.rotation_angle())
    return float(np.sqrt((t_err**2).mean())), float(np.sqrt((r_err**2).mean()))


def kitti_relative_error(
    est: Sequence[SE3],
    gt: Sequence[SE3],
    *,
    lengths: Sequence[float] = (100.0, 200.0, 300.0, 400.0, 500.0,
                                600.0, 700.0, 800.0),
    step: int = 10,
) -> Tuple[float, float]:
    """The KITTI odometry benchmark metric (Geiger et al. 2012):
    translational error (fraction, i.e. 0.01 = 1%) and rotational error
    (rad/m), averaged over all subsequences of the standard lengths.

    Subsequence starts are sampled every `step` frames; lengths with no
    reachable end frame are skipped. Returns (nan, nan) when the
    trajectory is shorter than the shortest length (use `rpe` then).
    """
    est_s, gt_s = _stack(est), _stack(gt)
    gt_t = np.asarray(gt_s.t)
    n = gt_t.shape[0]
    # cumulative gt path length per frame
    seg = np.linalg.norm(np.diff(gt_t, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])

    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            target = cum[first] + length
            last = int(np.searchsorted(cum, target))
            if last >= n:
                continue
            gt_rel = SE3(
                R=gt_s.R[first], t=gt_s.t[first]
            ).inverse() @ SE3(R=gt_s.R[last], t=gt_s.t[last])
            est_rel = SE3(
                R=est_s.R[first], t=est_s.t[first]
            ).inverse() @ SE3(R=est_s.R[last], t=est_s.t[last])
            err = est_rel.inverse() @ gt_rel
            t_errs.append(float(jnp.linalg.norm(err.t)) / length)
            r_errs.append(float(err.rotation_angle()) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))
