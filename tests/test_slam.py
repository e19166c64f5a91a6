"""End-to-end SLAM: odometry drift -> loop closure -> pose-graph
optimization reduces ATE; scan-to-map mode drifts less than
scan-to-keyframe."""

import jax.numpy as jnp
import numpy as np
import pytest

from icpx.geometry.se3 import SE3
from icpx.odometry.evaluate import ate_rmse
from icpx.odometry.frontend import OdometryConfig, run_odometry
from icpx.odometry.kitti import make_world, simulate_scans
from icpx.odometry.loopclosure import LoopClosureConfig, detect_loop_closures
from icpx.odometry.posegraph import PoseGraph, optimize_pose_graph
from icpx.registration.icp import ICPConfig


def _loop_trajectory(n_frames: int, radius: float = 6.0, laps: float = 2.0):
    """Multiple laps of a circle: every second-lap pose revisits a
    first-lap location, so loop closures exist all along the trajectory
    (a single closed circle cancels symmetric drift by itself and a lone
    end-closure would be vacuous)."""
    poses = []
    for k in range(n_frames):
        th = laps * 2 * np.pi * k / (n_frames - 1)
        c, s = np.cos(th), np.sin(th)
        R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = np.asarray(
            [radius * np.sin(th), radius * (1 - np.cos(th)), 1.2], np.float32
        )
        poses.append(SE3(R=jnp.asarray(R), t=jnp.asarray(t)))
    return poses


@pytest.fixture(scope="module")
def slam_setup():
    world = make_world(n_points=80000, extent=25.0, seed=2)
    gt = _loop_trajectory(30, laps=2.0)
    frames = simulate_scans(
        world, gt, max_range=14.0, points_per_scan=2048, noise=0.02, seed=3
    )
    # odometry reports poses in the first sensor frame: normalize GT to
    # the same gauge so unaligned ATE measures drift, not the convention
    gt = [gt[0].inverse() @ g for g in gt]
    return frames, gt


def _odo_config(mode):
    return OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=15,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=3.0,
        ),
        keyframe_trans=1.5,
        keyframe_rot=0.3,
        pyramid_levels=2,
        mode=mode,
        map_capacity=65536,
        map_cell=0.15,
    )


def test_loop_closure_pose_graph_reduces_ate(slam_setup):
    frames, gt = slam_setup
    res = run_odometry(frames, _odo_config("scan_to_keyframe"))
    ate_before = ate_rmse(res.poses, gt, align=False)

    kf = res.keyframe_indices
    kf_poses = [res.poses[i] for i in kf]
    kf_clouds = [frames[i] for i in kf]
    closures = detect_loop_closures(
        kf_poses,
        kf_clouds,
        LoopClosureConfig(
            min_separation=4,
            max_candidate_dist=4.0,
            accept_rmse=0.12,
            icp=ICPConfig(
                objective="symmetric",
                max_iters=15,
                diff_threshold=0.0,
                rmse_change_tol=1e-6,
                robust="huber",
                max_corr_dist=2.0,
            ),
        ),
    )
    assert closures, "no loop closures found on a closed loop"

    remap = {f: i for i, f in enumerate(kf)}
    edges = [
        (remap[i], remap[j], T) for (i, j, T) in res.edges if i in remap and j in remap
    ]
    edges += [(i, j, T) for (i, j, T, _) in closures]
    graph = PoseGraph.from_edge_list(
        SE3(
            R=jnp.stack([p.R for p in kf_poses]),
            t=jnp.stack([p.t for p in kf_poses]),
        ),
        edges,
    )
    opt, chi2 = optimize_pose_graph(graph, iters=10)
    gt_kf = [gt[i] for i in kf]
    opt_list = [SE3(R=opt.R[i], t=opt.t[i]) for i in range(len(kf))]
    ate_kf_before = ate_rmse(kf_poses, gt_kf, align=False)
    ate_kf_after = ate_rmse(opt_list, gt_kf, align=False)
    assert ate_kf_after < ate_kf_before * 0.7, (
        f"pose graph didn't help: {ate_kf_before:.3f} -> {ate_kf_after:.3f}"
    )


def test_scan_to_map_stays_bounded():
    """Scan-to-map on a gentle single-lap sequence: finite, accurate, and
    the motion sanity gate keeps divergence impossible even when the map
    gets revisited (the hard 2-lap case is covered by the loop-closure
    path; dense-revisit scan-to-map with conflicting drifted geometry is
    a known failure mode that the gate converts into dead-reckoning)."""
    world = make_world(n_points=80000, extent=25.0, seed=2)
    gt = _loop_trajectory(14, laps=0.75)
    frames = simulate_scans(
        world, gt, max_range=14.0, points_per_scan=2048, noise=0.02, seed=3
    )
    gt = [gt[0].inverse() @ g for g in gt]
    res_map = run_odometry(frames, _odo_config("scan_to_map"))
    ts = np.stack([np.asarray(p.t) for p in res_map.poses])
    assert np.isfinite(ts).all()
    ate_map = ate_rmse(res_map.poses, gt, align=False)
    assert ate_map < 0.7, f"map-mode ATE {ate_map:.3f}"

def test_closure_found_beyond_drift_gate():
    """closures discoverable when accumulated
    drift exceeds max_candidate_dist (position gating alone can never
    find these), via the appearance (ring-descriptor) channel + yaw
    seeding; verification is batched."""
    world = make_world(n_points=80000, extent=25.0, seed=5)
    # two keyframes at the SAME true place, second with a yaw offset
    a = SE3.identity().replace(t=jnp.asarray([0.0, 0.0, 1.2]))
    yaw = 0.9
    c, s = np.cos(yaw), np.sin(yaw)
    b = SE3(
        R=jnp.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], jnp.float32),
        t=jnp.asarray([0.3, -0.2, 1.2]),
    )
    # a few in-between keyframes elsewhere (distractors)
    mids = [
        SE3.identity().replace(
            t=jnp.asarray([6.0 + 2.0 * k, 4.0, 1.2], jnp.float32)
        )
        for k in range(5)
    ]
    true_poses = [a] + mids + [b]
    frames = simulate_scans(
        world, true_poses, max_range=14.0, points_per_scan=2048,
        noise=0.02, seed=7,
    )
    # believed poses: drift of 8 m on the revisit (>> 3 m gate)
    believed = list(true_poses)
    believed[-1] = believed[-1].replace(
        t=believed[-1].t + jnp.asarray([8.0, 3.0, 0.0])
    )
    cfg = LoopClosureConfig(
        min_separation=3,
        max_candidate_dist=3.0,
        max_descriptor_dist=0.25,
        accept_rmse=0.12,
    )
    edges = detect_loop_closures(believed, frames, cfg)
    pair_ids = [(i, j) for (i, j, _, _) in edges]
    assert (0, len(frames) - 1) in pair_ids, pair_ids
    # verified transform must match the TRUE relative pose
    for (i, j, T, rmse) in edges:
        if (i, j) == (0, len(frames) - 1):
            true_rel = a.inverse() @ b
            rot_err, t_err = T.distance_to(true_rel)
            assert float(rot_err) < 0.05 and float(t_err) < 0.15
    # position-only config must NOT find it (the round-1 failure mode)
    cfg_pos = LoopClosureConfig(
        min_separation=3, max_candidate_dist=3.0, max_descriptor_dist=0.0
    )
    edges_pos = detect_loop_closures(believed, frames, cfg_pos)
    assert (0, len(frames) - 1) not in [(i, j) for (i, j, _, _) in edges_pos]
