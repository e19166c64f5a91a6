"""Loop-closure detection & verification for the pose graph.

Candidates come from TWO channels (position-only detection makes
closures undiscoverable once drift exceeds the gate):

  * believed-position distance (cheap, works while drift is small);
  * appearance: Scan-Context-style ring descriptors (`placerec`), which
    find revisits regardless of accumulated drift; the sector-profile
    correlation supplies a yaw initial guess since the believed relative
    pose is exactly what drift has corrupted.

Verification is BATCHED: all candidate pairs run as one vmapped
`register_batch` executable (per-pair inits), so wall time is sublinear
in the candidate count; accepted closures become weighted pose-graph
edges whose optimization pulls the drifted trajectory back
(tests/test_slam.py shows the ATE drop end-to-end).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.registration.icp import ICPConfig, register, register_batch


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    min_separation: int = 5  # keyframes apart (time)
    max_candidate_dist: float = 3.0  # meters between believed positions
    # appearance channel: ring-descriptor distance below this admits a
    # candidate even when believed positions disagree by any amount
    # (<= 0 disables the appearance channel)
    max_descriptor_dist: float = 0.12
    n_rings: int = 12
    n_sectors: int = 48
    # verification budget per detection pass: the best-scored candidates
    # are verified; overflow is WARNED about (never silently dropped) and
    # survives to later passes if its keyframes stay candidates. <= 0
    # lifts the cap (verify everything; batched cost grows linearly).
    max_candidates: int = 10
    icp: ICPConfig = ICPConfig(
        objective="symmetric",
        max_iters=15,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
    )
    # batched verification (one vmapped executable over all candidates);
    # False falls back to sequential coarse-to-fine registrations.
    verify_batched: bool = True
    # The believed relative pose carries the accumulated drift the closure
    # exists to fix — the sequential path verifies coarse-to-fine.
    pyramid_levels: int = 2
    # Acceptance: rmse below max(accept_rmse, spacing_factor x the cloud's
    # own NN spacing). Two sparse scans of the same surface floor out at
    # the sampling spacing, not at the sensor noise — an absolute
    # threshold alone would reject perfect alignments of sparse scans.
    accept_rmse: float = 0.1
    accept_spacing_factor: float = 1.5
    min_inlier_frac: float = 0.5
    edge_weight: float = 1.0


def _descriptors(keyframe_clouds, config):
    """Ring descriptors + sector profiles for every keyframe cloud.

    Equal-capacity clouds (the common case: a frontend's keyframes all
    share one scan capacity) run as ONE vmapped `place_descriptor`
    executable instead of M sequential dispatches (host-side
    per-keyframe loops stop scaling in the thousands)."""
    from icpx.odometry.placerec import cloud_descriptor, place_descriptor

    caps = {c.capacity for c in keyframe_clouds}
    if len(caps) == 1:
        xyz = jnp.stack([c.xyz for c in keyframe_clouds])
        mask = jnp.stack([c.mask for c in keyframe_clouds])
        descs, profiles = jax.vmap(
            lambda x, mk: place_descriptor(
                x, mk, n_rings=config.n_rings, n_sectors=config.n_sectors
            )
        )(xyz, mask)
        return descs, list(profiles)
    descs, profiles = [], []
    for c in keyframe_clouds:
        d, p = cloud_descriptor(
            c, n_rings=config.n_rings, n_sectors=config.n_sectors
        )
        descs.append(d)
        profiles.append(p)
    return jnp.stack(descs), profiles


def _candidates(
    keyframe_poses, keyframe_clouds, config
) -> Tuple[List[Tuple[float, int, int, bool]], list]:
    """Rank candidate pairs by both channels.

    Returns ([(score, i, j, from_position)], sector profiles)."""
    m = len(keyframe_poses)
    pos = np.stack([np.asarray(p.t) for p in keyframe_poses])
    descs, profiles = _descriptors(keyframe_clouds, config)
    # pairwise scale-normalized descriptor distance — ONE device op
    # (||a-b||^2 = ||a||^2 + ||b||^2 - 2<a,b> expansion), not a host
    # (M, M, R, 4) broadcast: stays flat to thousands of keyframes
    #.
    Dj = descs.reshape(m, -1)  # (M, R*4)
    f = Dj.shape[1]
    sq = jnp.sum(Dj * Dj, axis=1)
    d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * Dj @ Dj.T, 0.0)
    diff = jnp.sqrt(d2 / f)
    nrm2 = sq / f
    scale = jnp.maximum(jnp.sqrt(nrm2[:, None] + nrm2[None, :]), 1e-6)
    desc_d = np.asarray(diff / scale)

    # Gate + score every (i, j) pair VECTORIZED (the former Python double
    # loop was O(M^2) interpreter iterations — millions at thousands of
    # keyframes before any verification started).
    pd = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=2)  # (M,M)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    sep_ok = jj >= ii + config.min_separation  # upper triangle, separated
    by_pos_m = pd < config.max_candidate_dist
    by_desc_m = (
        (desc_d < config.max_descriptor_dist)
        if config.max_descriptor_dist > 0
        else np.zeros_like(by_pos_m)
    )
    admit = sep_ok & (by_pos_m | by_desc_m)
    score_m = np.minimum(
        pd / max(config.max_candidate_dist, 1e-9),
        desc_d / max(config.max_descriptor_dist, 1e-9),
    )
    sel = np.argwhere(admit)
    scores = score_m[admit]
    # same ordering as sorting (score, i, j) tuples: score, then i, then j
    order = np.lexsort((sel[:, 1], sel[:, 0], scores))
    cands = [
        (
            float(scores[k]),
            int(sel[k, 0]),
            int(sel[k, 1]),
            bool(by_pos_m[sel[k, 0], sel[k, 1]]),
        )
        for k in order
    ]
    if config.max_candidates > 0 and len(cands) > config.max_candidates:
        import logging

        logging.getLogger("icpx.loopclosure").warning(
            "loop closure: %d candidates exceed max_candidates=%d; "
            "verifying the %d best-scored, dropping %d (raise "
            "max_candidates or <=0 to lift the cap)",
            len(cands),
            config.max_candidates,
            config.max_candidates,
            len(cands) - config.max_candidates,
        )
        cands = cands[: config.max_candidates]
    return cands, profiles


def _initial_guess(i, j, by_pos, keyframe_poses, profiles, config) -> SE3:
    """Seed for verifying register(cloud_j -> cloud_i)."""
    believed = keyframe_poses[i].inverse() @ keyframe_poses[j]
    if by_pos:
        return believed
    # appearance-only candidate: the believed pose is drift-corrupted;
    # seed from the sector-profile yaw (cloud_i ~ Rz(-yaw_ij) cloud_j)
    from icpx.odometry.placerec import relative_yaw

    yaw = float(relative_yaw(profiles[i], profiles[j]))
    return SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), -yaw, jnp.zeros((3,), jnp.float32)
    )


def detect_loop_closures(
    keyframe_poses: Sequence[SE3],
    keyframe_clouds: Sequence[PointCloud],
    config: LoopClosureConfig = LoopClosureConfig(),
) -> List[Tuple[int, int, SE3, float]]:
    """Find verified loop closures among keyframes.

    Returns [(i, j, i_T_j, rmse)] edges in KEYFRAME indices, suitable for
    `PoseGraph.from_edge_list` after remapping.
    """
    m = len(keyframe_poses)
    if m < 2:
        return []

    from icpx.kernels.normals import estimate_normals
    from icpx.kernels.voxel import auto_cell_size

    keyframe_clouds = [
        c if c.normals is not None else estimate_normals(c, k=10)
        for c in keyframe_clouds
    ]

    spacing = float(
        np.asarray(
            auto_cell_size(
                keyframe_clouds[0].xyz, keyframe_clouds[0].mask, scale=1.0
            )
        )
    )
    accept = max(config.accept_rmse, config.accept_spacing_factor * spacing)

    cands, profiles = _candidates(keyframe_poses, keyframe_clouds, config)
    if not cands:
        return []

    inits = [
        _initial_guess(i, j, by_pos, keyframe_poses, profiles, config)
        for (_, i, j, by_pos) in cands
    ]

    if config.verify_batched:
        sx = jnp.stack([keyframe_clouds[j].xyz for (_, _, j, _) in cands])
        sm = jnp.stack([keyframe_clouds[j].mask for (_, _, j, _) in cands])
        sn = jnp.stack(
            [keyframe_clouds[j].normals for (_, _, j, _) in cands]
        )
        tx = jnp.stack([keyframe_clouds[i].xyz for (_, i, _, _) in cands])
        tm = jnp.stack([keyframe_clouds[i].mask for (_, i, _, _) in cands])
        tn = jnp.stack(
            [keyframe_clouds[i].normals for (_, i, _, _) in cands]
        )
        init_b = SE3(
            R=jnp.stack([t.R for t in inits]),
            t=jnp.stack([t.t for t in inits]),
        )
        res = register_batch(sx, sm, sn, tx, tm, tn, config.icp, init_b)
        edges = []
        for k, (_, i, j, _) in enumerate(cands):
            rmse = float(res.final_rmse[k])
            n_valid = float(np.asarray(keyframe_clouds[j].num_valid()))
            inlier = float(res.inlier_count[k]) / max(n_valid, 1.0)
            if rmse < accept and inlier > config.min_inlier_frac:
                edges.append(
                    (
                        i,
                        j,
                        SE3(R=res.transform.R[k], t=res.transform.t[k]),
                        rmse,
                    )
                )
        return edges

    # sequential fallback: coarse-to-fine per candidate
    edges = []
    for k, (_, i, j, _) in enumerate(cands):
        init = inits[k]
        if config.pyramid_levels > 1:
            from icpx.registration.pyramid import (
                PyramidConfig,
                register_pyramid,
            )

            res, _ = register_pyramid(
                keyframe_clouds[j],
                keyframe_clouds[i],
                PyramidConfig(levels=config.pyramid_levels, base=config.icp),
                init=init,
            )
        else:
            res = register(
                keyframe_clouds[j], keyframe_clouds[i], config.icp, init=init
            )
        rmse = float(res.final_rmse)
        n_valid = float(np.asarray(keyframe_clouds[j].num_valid()))
        inlier_frac = float(res.inlier_count) / max(n_valid, 1.0)
        if rmse < accept and inlier_frac > config.min_inlier_frac:
            edges.append((i, j, res.transform, rmse))
    return edges
