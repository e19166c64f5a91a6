"""End-to-end odometry on a simulated LiDAR sequence: trajectory recovery
(ATE), keyframing, pose-graph refinement, and the KITTI ingest formats."""

import numpy as np
import pytest

from icpx.geometry.se3 import SE3
from icpx.odometry.evaluate import ate_rmse, rpe
from icpx.odometry.frontend import OdometryConfig, run_odometry
from icpx.odometry.kitti import (
    load_kitti_poses,
    load_kitti_scan,
    make_trajectory,
    make_world,
    simulate_scans,
)
from icpx.odometry.posegraph import PoseGraph, optimize_pose_graph
from icpx.registration.icp import ICPConfig


@pytest.fixture(scope="module")
def sim_sequence():
    world = make_world(n_points=60000, extent=30.0, seed=0)
    traj = make_trajectory(10, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, traj, max_range=18.0, points_per_scan=3072, noise=0.01, seed=1
    )
    return frames, traj


def test_odometry_recovers_trajectory(sim_sequence):
    frames, gt = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=1.0,
        keyframe_rot=0.2,
    )
    res = run_odometry(frames, cfg)
    assert len(res.poses) == len(frames)
    ate = ate_rmse(res.poses, gt)
    assert ate < 0.05, f"ATE {ate}"
    t_rpe, r_rpe = rpe(res.poses, gt)
    assert t_rpe < 0.05 and r_rpe < 0.02
    assert res.is_keyframe[0]
    assert len(res.edges) >= 1


def test_odometry_bounded_under_sensor_pathologies():
    """Round-4 with the LiDAR-realistic simulator switches on
    — beam-grid occlusion (nearest return per angular cell) AND 20%
    per-ray dropout — odometry ATE stays bounded. Also sanity-checks the
    pathology models themselves: occlusion thins dense directions, the
    intensity channel is present and varies."""
    world = make_world(n_points=60000, extent=30.0, seed=0)
    traj = make_trajectory(10, speed=0.6, turn=0.04)
    frames = simulate_scans(
        world, traj, max_range=18.0, points_per_scan=3072, noise=0.01,
        seed=1, occlusion=True, dropout=0.2, with_intensity=True,
    )
    # intensity channel exists and is non-degenerate
    inten = frames[0].feat("intensity")
    valid = np.asarray(frames[0].mask)
    iv = np.asarray(inten)[valid]
    assert iv.std() > 0.02  # albedo spread survived
    # occlusion + dropout leave fewer returns than the raw cut
    raw = simulate_scans(
        world, traj[:1], max_range=18.0, points_per_scan=3072,
        noise=0.01, seed=1,
    )
    assert valid.sum() <= np.asarray(raw[0].mask).sum()
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=1.0,
        keyframe_rot=0.2,
    )
    res = run_odometry(frames, cfg)
    ate = ate_rmse(res.poses, traj)
    assert ate < 0.15, f"ATE {ate} under occlusion + 20% dropout"


def test_odometry_posegraph_refinement(sim_sequence):
    frames, gt = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=10,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=0.4,  # denser keyframes -> more edges
    )
    res = run_odometry(frames, cfg)
    import jax.numpy as jnp

    kf = res.keyframe_indices
    if len(kf) < 3 or len(res.edges) < 2:
        pytest.skip("not enough keyframes for a graph")
    kf_poses = SE3(
        R=jnp.stack([res.poses[i].R for i in kf]),
        t=jnp.stack([res.poses[i].t for i in kf]),
    )
    remap = {f: i for i, f in enumerate(kf)}
    edges = [
        (remap[i], remap[j], T)
        for (i, j, T) in res.edges
        if i in remap and j in remap
    ]
    graph = PoseGraph.from_edge_list(kf_poses, edges)
    opt, chi2 = optimize_pose_graph(graph, iters=5)
    assert np.isfinite(np.asarray(chi2)).all()
    assert float(chi2[-1]) <= float(chi2[0]) + 1e-6


def test_kitti_scan_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(500, 4)).astype(np.float32)
    path = tmp_path / "000000.bin"
    pts.tofile(path)
    back = load_kitti_scan(path)
    assert back.shape == (500, 3)
    assert np.allclose(back, pts[:, :3])


def test_kitti_poses_roundtrip(tmp_path, key):
    poses = SE3.random(key, batch_shape=(5,))
    lines = []
    for k in range(5):
        m = np.concatenate(
            [np.asarray(poses.R[k]), np.asarray(poses.t[k])[:, None]], axis=1
        )
        lines.append(" ".join(f"{v:.9g}" for v in m.reshape(-1)))
    path = tmp_path / "00.txt"
    path.write_text("\n".join(lines) + "\n")
    back = load_kitti_poses(path)
    assert len(back) == 5
    assert np.allclose(np.asarray(back[2].R), np.asarray(poses.R[2]), atol=1e-6)


def test_ate_invariance(key):
    """ATE after alignment is invariant to a global rigid motion."""
    import jax

    k1, k2 = jax.random.split(key)
    gt = [SE3.random(k) for k in jax.random.split(k1, 6)]
    offset = SE3.random(k2)
    est = [offset @ p for p in gt]
    assert ate_rmse(est, gt) < 1e-4

def test_smooth_ground_runaway_defaults_bounded():
    """The degenerate smooth-ground world (registration error feeds the
    constant-velocity init, IRLS bias follows it, error doubles per
    frame) must stay bounded with the
    DEFAULT mitigation config. The adaptive innovation-scaled velocity
    EMA (on by default) breaks the feedback loop; measured here: raw
    model max rel err ~10 m (divergence), adaptive ~0.42 m (two frames
    that genuinely see no structure), mean ~0.07 m."""
    world = make_world(
        n_points=60000, extent=40.0, seed=4, n_posts=3, ground_frac=0.95
    )
    gt = make_trajectory(30, speed=1.0, turn=0.02)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.02, seed=5
    )
    gt0 = [gt[0].inverse() @ g for g in gt]
    icp = ICPConfig(
        objective="symmetric",
        max_iters=15,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=3.0,
    )

    def rel_errs(poses):
        errs = []
        for k in range(1, len(poses)):
            est_rel = poses[k - 1].inverse() @ poses[k]
            gt_rel = gt0[k - 1].inverse() @ gt0[k]
            errs.append(float(est_rel.distance_to(gt_rel)[1]))
        return errs

    # default config (adaptive velocity smoothing ON) stays bounded
    res = run_odometry(
        frames, OdometryConfig(icp=icp, keyframe_trans=1.5, keyframe_rot=0.3)
    )
    errs = rel_errs(res.poses)
    assert max(errs) < 0.6, f"max rel err {max(errs):.3f}"
    assert float(np.mean(errs)) < 0.15, f"mean rel err {np.mean(errs):.3f}"

    # the raw constant-velocity model diverges on the same data — the
    # scenario actually exercises the failure mode being mitigated.
    # The divergence MAGNITUDE is chaotic (it amplifies fp-level normal
    # noise: the round-5 SoA eigensolver moved it from ~10 m to ~1.9 m
    # on identical data), so the contract is RELATIVE: raw must be
    # several times worse than mitigated, not a fixed absolute.
    res_raw = run_odometry(
        frames,
        OdometryConfig(
            icp=icp,
            keyframe_trans=1.5,
            keyframe_rot=0.3,
            adaptive_velocity=False,
        ),
    )
    raw_max = max(rel_errs(res_raw.poses))
    assert raw_max > 1.0 and raw_max > 2.5 * max(errs), (
        raw_max, max(errs)
    )


def test_resume_matches_uninterrupted(sim_sequence):
    """SURVEY §5.4 resume-mid-sequence: a checkpoint taken mid-run plus
    the remaining frames reproduces the uninterrupted trajectory and edge
    list exactly (motion-model state is checkpointed, not re-derived)."""
    from icpx.utils.checkpoint import OdometryCheckpoint

    frames, _ = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=1.0,
        keyframe_rot=0.2,
    )
    full = run_odometry(frames, cfg)

    cut = 6
    part = run_odometry(frames[:cut], cfg)
    ck = OdometryCheckpoint.from_result(part)
    resumed = run_odometry(frames, cfg, resume=ck)

    assert len(resumed.poses) == len(full.poses)
    for pf, pr in zip(full.poses, resumed.poses):
        # matrix-entry comparison: distance_to's arccos is ill-conditioned
        # near identity and reports ~5e-4 rad for bit-identical rotations
        np.testing.assert_allclose(np.asarray(pf.R), np.asarray(pr.R),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(pf.t), np.asarray(pr.t),
                                   atol=1e-6)
    assert resumed.is_keyframe == full.is_keyframe
    assert [(i, j) for (i, j, _) in resumed.edges] == [
        (i, j) for (i, j, _) in full.edges
    ]
    for (_, _, Tr), (_, _, Tf) in zip(resumed.edges, full.edges):
        np.testing.assert_allclose(np.asarray(Tr.R), np.asarray(Tf.R),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(Tr.t), np.asarray(Tf.t),
                                   atol=1e-6)


def test_sliding_window_backend_wired(sim_sequence):
    """the incremental sliding-window backend
    runs DURING odometry — keyframes/edges stream into it, marginalization
    triggers automatically past the window length, and refined poses feed
    back into the frontend chain."""
    frames, gt = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=0.5,  # every frame spawns (speed 0.6/frame)
        keyframe_rot=0.15,
        backend="sliding_window",
        window=3,
    )
    res = run_odometry(frames, cfg)
    assert len(res.keyframe_indices) > 3  # marginalization actually ran
    ts = np.stack([np.asarray(p.t) for p in res.poses])
    assert np.isfinite(ts).all()
    ate = ate_rmse(res.poses, gt)
    # odometry-chain-only window optimization must not hurt accuracy
    res_none = run_odometry(
        frames,
        OdometryConfig(
            icp=cfg.icp,
            keyframe_trans=0.5,
            keyframe_rot=0.15,
        ),
    )
    ate_none = ate_rmse(res_none.poses, gt)
    assert ate < ate_none + 0.05, (ate, ate_none)


def test_dynamic_object_rejection():
    """A moving object rides through the scene; with dynamic_sigma the
    frontend scrubs it from keyframes (residual outliers vs the previous
    keyframe). The object must move further than its own extent per
    frame to be per-pair detectable (self-aliasing is documented)."""
    import jax.numpy as jnp

    from icpx.cloud import PointCloud
    from icpx.odometry.frontend import _mask_dynamic, _register_pair
    from icpx.geometry.se3 import SE3
    from icpx.kernels.normals import estimate_normals

    world = make_world(n_points=60000, extent=30.0, seed=0)
    traj = make_trajectory(8, speed=0.8, turn=0.03)
    rng = np.random.default_rng(9)
    blob0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32) * np.asarray(
        [0.4, 0.4, 0.4], np.float32
    ) + np.asarray([6.0, 4.0, 1.0], np.float32)
    # one stable world subset: scans see exactly the subset points in
    # range, so consecutive frames SHARE their overlap's surface points
    # (like dense real LiDAR) and static residuals are noise-limited,
    # not sampling-limited
    world_sub = world[rng.choice(len(world), 12000, replace=False)]
    frames = []
    n_world = []
    cap = 5504
    for k, pose in enumerate(traj):
        center = np.asarray(pose.t)
        d2 = ((world_sub - center[None, :]) ** 2).sum(1)
        near = np.where(d2 < 324)[0][: cap - 300]
        blob_k = blob0 + np.asarray([0.0, -1.8, 0.0], np.float32) * k
        pts_w = np.concatenate([world_sub[near], blob_k])
        pts_s = np.array(pose.inverse().apply(jnp.asarray(pts_w)))
        pts_s += rng.normal(0, 0.01, pts_s.shape).astype(np.float32)
        n_world.append(len(near))
        frames.append(PointCloud.create(pts_s.astype(np.float32),
                                        capacity=cap))
    icp = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
    )
    gt = [traj[0].inverse() @ g for g in traj]

    # unit-level: the scrub removes the moving object, keeps the world
    f0 = estimate_normals(frames[0], k=10)
    f1 = estimate_normals(frames[1], k=10)
    res01 = _register_pair(f1, f0, OdometryConfig(icp=icp), SE3.identity())
    masked = _mask_dynamic(f1, f0, res01.transform, 3.0, 0.5)
    keep = np.asarray(masked.mask)
    nw = n_world[1]
    assert keep[nw : nw + 300].mean() < 0.10, "moving object survived"
    assert keep[:nw].mean() > 0.90, "static world over-scrubbed"

    # end-to-end: rejection must not hurt the trajectory
    res_dyn = run_odometry(
        frames,
        OdometryConfig(
            icp=icp, keyframe_trans=0.5, keyframe_rot=0.15,
            dynamic_sigma=3.0,
        ),
    )
    res_raw = run_odometry(
        frames, OdometryConfig(icp=icp, keyframe_trans=0.5,
                               keyframe_rot=0.15)
    )
    ate_dyn = ate_rmse(res_dyn.poses, gt, align=False)
    ate_raw = ate_rmse(res_raw.poses, gt, align=False)
    assert ate_dyn <= ate_raw + 0.02, (ate_dyn, ate_raw)
    assert ate_dyn < 0.35, ate_dyn


def test_kitti_relative_error_metric(key):
    """Segment metric: exact trajectory -> ~0 error; a constant 1%-per-
    meter translational drift is measured as ~1%."""
    from icpx.odometry.evaluate import kitti_relative_error
    import jax.numpy as jnp

    n = 400
    poses = []
    drifted = []
    for k in range(n):
        t = jnp.asarray([1.0 * k, 0.0, 0.0], jnp.float32)
        poses.append(SE3.identity().replace(t=t))
        drifted.append(
            SE3.identity().replace(
                t=t + jnp.asarray([0.0, 0.01 * k, 0.0], jnp.float32)
            )
        )
    t_err, r_err = kitti_relative_error(poses, poses, lengths=(100.0, 200.0))
    assert t_err < 1e-6 and r_err < 1e-6
    t_err, r_err = kitti_relative_error(drifted, poses,
                                        lengths=(100.0, 200.0))
    assert 0.005 < t_err < 0.02, t_err
    # too-short trajectory -> nan signal
    t_err, _ = kitti_relative_error(poses[:5], poses[:5])
    assert np.isnan(t_err)


def test_resume_with_dynamic_scrub_matches(sim_sequence):
    """Resume must reproduce dynamic-object-scrubbed runs too: keyframe
    masks are checkpointed and reapplied (a resumed run otherwise
    registers against unscrubbed reference geometry)."""
    from icpx.utils.checkpoint import OdometryCheckpoint

    frames, _ = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=1.0,
        keyframe_rot=0.2,
        dynamic_sigma=3.0,
    )
    full = run_odometry(frames, cfg)
    assert full.keyframe_masks is not None

    part = run_odometry(frames[:6], cfg)
    ck = OdometryCheckpoint.from_result(part)
    assert ck.kf_masks is not None
    resumed = run_odometry(frames, cfg, resume=ck)
    for pf, pr in zip(full.poses, resumed.poses):
        np.testing.assert_allclose(np.asarray(pf.R), np.asarray(pr.R),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(pf.t), np.asarray(pr.t),
                                   atol=1e-6)


def test_sliding_window_trajectory_consistency(sim_sequence):
    """Window refinement moves keyframes AND re-anchors the non-keyframe
    poses chained off them: each frame's placement relative to its
    keyframe is identical with and without the backend."""
    frames, _ = sim_sequence
    base = dict(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=1.0,  # ~every other frame spawns (speed 0.6)
        keyframe_rot=0.2,
    )
    res_w = run_odometry(frames, OdometryConfig(
        backend="sliding_window", window=3, **base))
    res_0 = run_odometry(frames, OdometryConfig(**base))
    assert res_w.keyframe_indices == res_0.keyframe_indices
    kf = res_w.keyframe_indices
    anchor = 0
    for f in range(len(frames)):
        if f in kf:
            anchor = f
            continue
        rel_w = res_w.poses[anchor].inverse() @ res_w.poses[f]
        rel_0 = res_0.poses[anchor].inverse() @ res_0.poses[f]
        np.testing.assert_allclose(np.asarray(rel_w.t), np.asarray(rel_0.t),
                                   atol=1e-4)


def test_resume_sliding_window_bit_exact(sim_sequence, tmp_path):
    """backend="sliding_window" resume is bit-exact: the MarginalPrior + active window survive the checkpoint
    round-trip, so the resumed run linearizes at exactly the same points
    as the uninterrupted one. Goes through save()/load() on disk to cover
    the npz plumbing."""
    from icpx.utils.checkpoint import OdometryCheckpoint

    frames, _ = sim_sequence
    cfg = OdometryConfig(
        icp=ICPConfig(
            objective="symmetric",
            max_iters=12,
            diff_threshold=0.0,
            rmse_change_tol=1e-6,
            robust="huber",
            max_corr_dist=2.0,
        ),
        keyframe_trans=0.5,  # every frame spawns -> marginalization runs
        keyframe_rot=0.15,
        backend="sliding_window",
        window=3,
    )
    full = run_odometry(frames, cfg)
    assert full.window is not None and full.window.prior is not None

    cut = 7
    part = run_odometry(frames[:cut], cfg)
    assert part.window.prior is not None  # prior exists at the cut point
    p = tmp_path / "win.ckpt.npz"
    OdometryCheckpoint.from_result(part).save(p)
    ck = OdometryCheckpoint.load(p)
    assert ck.win_active0 is not None and ck.win_prior_H is not None
    resumed = run_odometry(frames, cfg, resume=ck)

    assert len(resumed.poses) == len(full.poses)
    assert resumed.is_keyframe == full.is_keyframe
    for pf, pr in zip(full.poses, resumed.poses):
        np.testing.assert_allclose(np.asarray(pf.R), np.asarray(pr.R),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(pf.t), np.asarray(pr.t),
                                   atol=1e-6)
    # the restored window itself matches: same prior linearization
    np.testing.assert_allclose(
        np.asarray(resumed.window.prior.H),
        np.asarray(full.window.prior.H),
        atol=1e-4,
    )


def test_batched_pair_seed_recovers_yaw_and_translation():
    """The global batched-pair seed (sector-profile yaw) recovers inter-frame yaw to within ~2 sector widths on
    simulated LiDAR pairs, and its translation stays the identity
    (global statistics of range-limited scans are origin-anchored —
    centroid/range-profile translation estimates measured biased, see
    batched_pair_seed docstring)."""
    import jax.numpy as jnp

    from icpx.kernels.normals import estimate_normals  # noqa: F401
    from icpx.odometry.kitti import (
        make_trajectory,
        make_world,
        simulate_scans,
    )
    from icpx.odometry.parallel import batched_pair_seed

    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(8, speed=0.8, turn=0.08)  # turning: yaw matters
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1
    )
    sx = jnp.stack([f.xyz for f in frames[1:]])
    sm = jnp.stack([f.mask for f in frames[1:]])
    tx = jnp.stack([f.xyz for f in frames[:-1]])
    tm = jnp.stack([f.mask for f in frames[:-1]])
    seed = batched_pair_seed(sx, sm, tx, tm)
    sector = 2 * np.pi / 48
    for k in range(len(frames) - 1):
        rel_gt = gt[k].inverse() @ gt[k + 1]
        s_k = SE3(R=seed.R[k], t=seed.t[k])
        rot_err, _ = s_k.distance_to(rel_gt)
        assert float(rot_err) < 2.0 * sector, (k, float(rot_err))
        np.testing.assert_allclose(np.asarray(seed.t[k]), 0.0)
