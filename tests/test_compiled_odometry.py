"""Whole-sequence compiled odometry matches the host-driven frontend."""

import jax
import jax.numpy as jnp
import numpy as np

from icpx.kernels.normals import estimate_normals
from icpx.odometry.compiled import run_odometry_compiled
from icpx.odometry.evaluate import ate_rmse
from icpx.odometry.frontend import OdometryConfig, run_odometry
from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans
from icpx.registration.icp import ICPConfig


def test_compiled_matches_host_loop():
    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(10, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1
    )
    frames = [estimate_normals(f, k=10) for f in frames]
    icp_cfg = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
    )
    host = run_odometry(
        frames,
        OdometryConfig(icp=icp_cfg, keyframe_trans=1.0, keyframe_rot=0.2),
    )
    comp = run_odometry_compiled(
        jnp.stack([f.xyz for f in frames]),
        jnp.stack([f.mask for f in frames]),
        jnp.stack([f.normals for f in frames]),
        icp_cfg,
        keyframe_trans=1.0,
        keyframe_rot=0.2,
    )
    poses, is_kf = comp.poses, comp.is_keyframe
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ate_host = ate_rmse(host.poses, gt_rel, align=False)
    ate_comp = ate_rmse(
        [jax.tree_util.tree_map(lambda x: x[i], poses) for i in range(10)],
        gt_rel,
        align=False,
    )
    # sparse scans (~0.9 m spacing) drift: what matters is that the
    # compiled program reproduces the host loop exactly
    assert ate_comp < 0.35, f"compiled ATE {ate_comp}"
    assert abs(ate_comp - ate_host) < 0.02, (ate_comp, ate_host)
    # same keyframe pattern
    assert list(np.asarray(is_kf)) == host.is_keyframe
    assert np.isfinite(np.asarray(poses.t)).all()
    # MEASURED edges match the host frontend's edge list: same (i, j) pairs and near-identical measured transforms
    comp_edges = comp.edge_list()
    assert [(i, j) for (i, j, _) in comp_edges] == [
        (i, j) for (i, j, _) in host.edges
    ]
    for (ci, cj, cT), (_, _, hT) in zip(comp_edges, host.edges):
        rot_err, t_err = cT.distance_to(hT)
        assert float(rot_err) < 1e-3 and float(t_err) < 1e-3, (ci, cj)

def test_compiled_gicp_runs():
    """GICP covariance plumbing through the compiled whole-sequence path: finite trajectory, sane ATE."""
    from icpx.kernels.normals import estimate_covariances

    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(6, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1
    )
    frames = [estimate_covariances(f, k=15) for f in frames]
    cfg = ICPConfig(
        objective="gicp",
        max_iters=10,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
    )
    comp = run_odometry_compiled(
        jnp.stack([f.xyz for f in frames]),
        jnp.stack([f.mask for f in frames]),
        jnp.stack([f.covs.reshape(f.capacity, 9) for f in frames]),
        cfg,
        keyframe_trans=1.0,
        keyframe_rot=0.2,
    )
    assert np.isfinite(np.asarray(comp.poses.t)).all()
    gt_rel = [gt[0].inverse() @ g for g in gt]
    plist = [
        jax.tree_util.tree_map(lambda x: x[i], comp.poses)
        for i in range(len(frames))
    ]
    assert ate_rmse(plist, gt_rel, align=False) < 0.35


def test_compiled_block_nn_matches_brute():
    """Large-scan compiled odometry uses tile-index NN inside the scan
    body (the compiled path was brute-only and
    silently O(N^2)-per-frame at big scans). The block variant must
    track the brute trajectory."""
    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(6, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1
    )
    frames = [estimate_normals(f, k=10) for f in frames]
    base = dict(
        objective="symmetric", max_iters=12, diff_threshold=0.0,
        rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0,
    )
    fx = jnp.stack([f.xyz for f in frames])
    fm = jnp.stack([f.mask for f in frames])
    fn = jnp.stack([f.normals for f in frames])
    brute = run_odometry_compiled(
        fx, fm, fn, ICPConfig(nn_method="brute", **base),
        keyframe_trans=1.0, keyframe_rot=0.2,
    )
    block = run_odometry_compiled(
        fx, fm, fn,
        ICPConfig(nn_method="block", block_tile=64, block_q_tile=32,
                  block_k=6, coarse_iters=0, **base),
        keyframe_trans=1.0, keyframe_rot=0.2,
    )
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ate_brute = ate_rmse(
        [jax.tree_util.tree_map(lambda x: x[i], brute.poses)
         for i in range(6)], gt_rel, align=False)
    ate_block = ate_rmse(
        [jax.tree_util.tree_map(lambda x: x[i], block.poses)
         for i in range(6)], gt_rel, align=False)
    assert ate_block < 0.35, f"block ATE {ate_block}"
    assert abs(ate_block - ate_brute) < 0.05, (ate_block, ate_brute)
    assert list(np.asarray(block.is_keyframe)) == list(
        np.asarray(brute.is_keyframe)
    )


def test_frozen_frame_candidates_track_unfrozen():
    """freeze_candidates=True (rank candidate tiles once per frame at the
    warm init) must track the per-iteration-ranking trajectory: the
    constant-velocity init leaves residual motion well under a tile
    extent (the scan-scale analogue of the single-pair
    frozen refine candidates)."""
    world = make_world(n_points=60000, extent=30.0, seed=2)
    gt = make_trajectory(6, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=3
    )
    frames = [estimate_normals(f, k=10) for f in frames]
    cfg = ICPConfig(
        objective="symmetric", max_iters=12, diff_threshold=0.0,
        rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0,
        nn_method="block", block_tile=64, block_q_tile=32, block_k=6,
    )
    fx = jnp.stack([f.xyz for f in frames])
    fm = jnp.stack([f.mask for f in frames])
    fn = jnp.stack([f.normals for f in frames])
    runs = {
        frz: run_odometry_compiled(
            fx, fm, fn, cfg, keyframe_trans=1.0, keyframe_rot=0.2,
            freeze_candidates=frz,
        )
        for frz in (True, False)
    }
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ates = {
        frz: ate_rmse(
            [jax.tree_util.tree_map(lambda x: x[i], r.poses)
             for i in range(6)], gt_rel, align=False)
        for frz, r in runs.items()
    }
    assert ates[True] < 0.35, ates
    assert abs(ates[True] - ates[False]) < 0.03, ates
    assert list(np.asarray(runs[True].is_keyframe)) == list(
        np.asarray(runs[False].is_keyframe)
    )


def test_refine_stride_tracks_full_res():
    """Explicit `refine_stride` > 1 (multi-resolution refine inside each
    per-frame registration: bulk iterations on a within-tile row
    subsample, `refine_full_iters` at full resolution) must track the
    stride-1 trajectory — the tile boxes and frozen candidate lists stay
    valid for the subsample, and pose accuracy needs statistical mass,
    not every point."""
    import dataclasses

    world = make_world(n_points=60000, extent=30.0, seed=4)
    gt = make_trajectory(6, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=5
    )
    frames = [estimate_normals(f, k=10) for f in frames]
    cfg = ICPConfig(
        objective="symmetric", max_iters=12, diff_threshold=0.0,
        rmse_change_tol=1e-6, robust="huber", max_corr_dist=2.0,
        nn_method="block", block_tile=64, block_q_tile=32, block_k=6,
    )
    fx = jnp.stack([f.xyz for f in frames])
    fm = jnp.stack([f.mask for f in frames])
    fn = jnp.stack([f.normals for f in frames])
    runs = {
        s: run_odometry_compiled(
            fx, fm, fn, dataclasses.replace(cfg, refine_stride=s),
            keyframe_trans=1.0, keyframe_rot=0.2,
        )
        for s in (1, 2, 4)
    }
    gt_rel = [gt[0].inverse() @ g for g in gt]
    ates = {
        s: ate_rmse(
            [jax.tree_util.tree_map(lambda x: x[i], r.poses)
             for i in range(6)], gt_rel, align=False)
        for s, r in runs.items()
    }
    assert ates[1] < 0.35, ates
    for s in (2, 4):
        assert abs(ates[s] - ates[1]) < 0.03, ates
        assert list(np.asarray(runs[s].is_keyframe)) == list(
            np.asarray(runs[1].is_keyframe)
        )


def test_odo_resolvers_contract():
    """The odometry auto ladders and their override precedence (review
    r5): explicit q_tile wins; an explicitly tuned config.block_q_tile
    is honored (the ladder must not silently override user tiling);
    otherwise the measured scan-regime ladder applies."""
    import dataclasses

    from icpx.odometry.compiled import (
        resolve_odo_freeze,
        resolve_odo_q_tile,
        resolve_odo_refine_stride,
    )

    cfg_default = ICPConfig()
    assert resolve_odo_q_tile(cfg_default, 131072) == 256
    assert resolve_odo_q_tile(cfg_default, 65536) == 256
    assert resolve_odo_q_tile(cfg_default, 16384) == 128
    assert resolve_odo_q_tile(cfg_default, 8192) == 128
    assert resolve_odo_q_tile(cfg_default, 4096) == \
        cfg_default.resolve_q_tile(4096)
    # explicit q_tile wins over everything
    assert resolve_odo_q_tile(cfg_default, 131072, q_tile=64) == 64
    # explicitly tuned config tiling is honored, not laddered away
    cfg_tuned = ICPConfig(block_q_tile=32)
    assert resolve_odo_q_tile(cfg_tuned, 16384) == 32
    assert resolve_odo_freeze(8192) is False
    assert resolve_odo_freeze(16384) is True
    assert resolve_odo_freeze(8192, True) is True
    assert resolve_odo_freeze(131072, False) is False
    # refine-stride ladder: 4 from 131k scans, 2 from 65k, else off
    assert resolve_odo_refine_stride(cfg_default, 131072) == 4
    assert resolve_odo_refine_stride(cfg_default, 65536) == 2
    assert resolve_odo_refine_stride(cfg_default, 32768) == 1
    assert resolve_odo_refine_stride(cfg_default, 8192) == 1
    # explicit stride wins over everything
    assert resolve_odo_refine_stride(cfg_default, 131072, stride=2) == 2
    # explicitly tuned config stride honored, not laddered away
    cfg_stride = dataclasses.replace(cfg_default, refine_stride=2)
    assert resolve_odo_refine_stride(cfg_stride, 131072) == 2
    cfg_off = dataclasses.replace(cfg_default, refine_stride=1)
    assert resolve_odo_refine_stride(cfg_off, 131072) == 1
