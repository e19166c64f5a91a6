"""Data-parallel odometry: every consecutive scan pair registers
SIMULTANEOUSLY across the device mesh, then relative poses compose into
the trajectory on the host.

The sequential frontend (`frontend.run_odometry`) is latency-ordered —
frame k needs frame k-1's pose for its motion-model init. But when
inter-frame motion is small relative to the scene (the common mapping /
offline-processing case), each pair registers fine from identity, and
the whole sequence becomes one embarrassingly-parallel batch: the
SURVEY §2.3 P1 pattern at its purest. F frames = F-1 independent
registrations = one `sharded_register_pairs` call over the ``pairs``
mesh axis (optionally x ``points`` TP within each pair).

Compared to the sequential paths: no constant-velocity init (pairs must
converge from identity), no keyframe gating (every frame is kept), and
composition accumulates drift exactly like scan-to-scan odometry. The
measured relative transforms feed the same pose-graph backend.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig


def batched_pair_seed(
    sx: jnp.ndarray,  # (B, N, 3) source scans (sensor frame)
    sm: jnp.ndarray,  # (B, N)
    tx: jnp.ndarray,  # (B, N, 3) target scans
    tm: jnp.ndarray,  # (B, N)
    *,
    n_rings: int = 12,
    n_sectors: int = 48,
    translation: str = "none",
) -> SE3:
    """Cheap global YAW init per pair for identity-init batched
    registration: sector-profile correlation
    (`placerec.relative_yaw` — the same seed loop-closure verification
    uses for drift-corrupted candidates). One vmapped descriptor pass +
    one (B,) correlation: a few percent of one ICP iteration.

    `translation="centroid"` adds the rotated centroid delta — correct
    for full-overlap pairs (two samplings of the same surface), but
    MEASURED BIASED for range-limited LiDAR scans: every global
    statistic of a ring-limited scan is anchored to the sensor origin,
    so the centroid tracks the origin, not the world (sector
    range-profile projection measured the same failure: estimates
    0.1-0.6 m scattered against a 0.8 m ground truth). The default
    therefore seeds yaw only; translation convergence is what the
    annealed schedule handles.

    Returns batched SE3 (B,) mapping source -> target frame.
    """
    from icpx.odometry.placerec import place_descriptor, relative_yaw

    desc = jax.vmap(
        lambda x, m: place_descriptor(
            x, m, n_rings=n_rings, n_sectors=n_sectors
        )
    )
    _, prof_s = desc(sx, sm)
    _, prof_t = desc(tx, tm)
    # register(src -> tgt): same convention as loopclosure._initial_guess
    # (target profile first; tgt ~ Rz(-yaw) src)
    yaw = jax.vmap(relative_yaw)(prof_t, prof_s)  # (B,)
    c, s = jnp.cos(-yaw), jnp.sin(-yaw)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    R = jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )  # (B, 3, 3)

    if translation == "centroid":
        def centroid(x, m):
            denom = jnp.maximum(m.sum(axis=1), 1.0)[:, None]
            return jnp.where(m[:, :, None], x, 0.0).sum(axis=1) / denom

        cs = centroid(sx, sm.astype(jnp.float32))
        ct = centroid(tx, tm.astype(jnp.float32))
        t = ct - jnp.einsum("bij,bj->bi", R, cs)
    else:
        t = jnp.zeros((sx.shape[0], 3), jnp.float32)
    return SE3(R=R, t=t)


def parallel_odometry(
    frames: Sequence[PointCloud],
    config: ICPConfig,
    mesh,
    *,
    pairs_axis: str = "pairs",
    points_axis: str = "points",
) -> Tuple[List[SE3], List[Tuple[int, int, SE3]], jnp.ndarray]:
    """Register all consecutive pairs in parallel; returns
    (world poses per frame, measured edges [(i, i+1, i_T_{i+1})], per-pair
    final RMSE array).

    Frames must share one capacity; the pair count (F-1) must be
    divisible by the `pairs_axis` mesh size (pad by repeating the last
    frame if needed — duplicated pairs cost one extra slot and their
    identity result is discarded here).
    """
    from icpx.distributed.sharded_icp import sharded_register_pairs

    f = len(frames)
    if f < 2:
        return [SE3.identity()] * f, [], jnp.zeros((0,), jnp.float32)
    if config.objective == "gicp":
        from icpx.kernels.normals import estimate_covariances

        frames = [
            fr
            if fr.covs is not None
            else estimate_covariances(fr, k=max(config.k_normals, 15))
            for fr in frames
        ]

        def aux(fr):
            return fr.covs.reshape(fr.capacity, 9)

    else:
        frames = [
            fr
            if fr.normals is not None
            else estimate_normals(fr, k=config.k_normals)
            for fr in frames
        ]

        def aux(fr):
            return fr.normals

    n_pairs = f - 1
    dp = mesh.shape[pairs_axis]
    pad = (-n_pairs) % dp
    srcs = list(frames[1:]) + [frames[-1]] * pad
    tgts = list(frames[:-1]) + [frames[-1]] * pad

    res = sharded_register_pairs(
        jnp.stack([fr.xyz for fr in srcs]),
        jnp.stack([fr.mask for fr in srcs]),
        jnp.stack([aux(fr) for fr in srcs]),
        jnp.stack([fr.xyz for fr in tgts]),
        jnp.stack([fr.mask for fr in tgts]),
        jnp.stack([aux(fr) for fr in tgts]),
        config,
        mesh,
        pairs_axis=pairs_axis,
        points_axis=points_axis,
    )

    poses = [SE3.identity()]
    edges: List[Tuple[int, int, SE3]] = []
    for k in range(n_pairs):
        rel = SE3(R=res.transform.R[k], t=res.transform.t[k])
        edges.append((k, k + 1, rel))
        poses.append(poses[-1] @ rel)
    return poses, edges, res.final_rmse[:n_pairs]
