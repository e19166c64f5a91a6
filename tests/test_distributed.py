"""Sharded-vs-single-device equivalence on the faked 8-device CPU mesh
(SURVEY §4 'Distributed' plan): psum'd normal equations and ring NN must
reproduce the single-device result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx.cloud import PointCloud
from icpx.distributed.mesh import make_mesh, mesh_shape_for
from icpx.distributed.ring import ring_nearest_neighbor
from icpx.distributed.sharded_icp import sharded_register, sharded_register_pairs
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.knn import nearest_neighbor
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig, register


def _pair(n=1024, seed=0, angle=0.2, trans=0.15):
    xyz = synthetic_surface(n, seed=seed)
    src = PointCloud.create(xyz)
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.3, 0.954]) / np.linalg.norm([0.0, 0.3, 0.954]),
        angle,
        jnp.asarray([trans, 0.0, -trans]),
    )
    rng = np.random.default_rng(seed + 5)
    tgt_np = np.asarray(gt.apply(src.xyz))[:n][rng.permutation(n)]
    return src, PointCloud.create(tgt_np), gt


def test_mesh_shape_for():
    assert mesh_shape_for(8) == (1, 8)
    assert mesh_shape_for(8, n_pairs=4) == (4, 2)
    assert mesh_shape_for(8, n_pairs=3) == (2, 4)
    assert mesh_shape_for(6, n_pairs=12) == (6, 1)


def test_ring_nn_matches_bruteforce():
    mesh = make_mesh(axis_names=("points",))
    n_dev = 8
    rng = np.random.default_rng(0)
    q = rng.normal(size=(256, 3)).astype(np.float32)
    r = rng.normal(size=(512, 3)).astype(np.float32)
    r_mask = np.ones(512, bool)

    from functools import partial

    from jax.sharding import PartitionSpec as P

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P("points", None), P("points")),
        out_specs=(P("points"), P("points")),
        check_vma=False,
    )
    def run(qq, rr, mm):
        d, i, _ = ring_nearest_neighbor(
            qq, rr, mm, "points", tile_q=64, tile_r=64
        )
        # every device computes the same full answer; emit 1/n_dev each
        me = jax.lax.axis_index("points")
        sl = 256 // n_dev
        return (
            jax.lax.dynamic_slice_in_dim(d, me * sl, sl),
            jax.lax.dynamic_slice_in_dim(i, me * sl, sl),
        )

    d, i = run(q, r, r_mask)
    d_ref, i_ref = nearest_neighbor(q, r)
    assert np.allclose(np.asarray(d), np.asarray(d_ref), atol=1e-5)
    picked = ((q - r[np.asarray(i)]) ** 2).sum(-1)
    assert np.allclose(picked, np.asarray(d_ref), atol=1e-4)


@pytest.mark.parametrize("ring", [False, True])
def test_sharded_register_matches_single_device(ring):
    src, tgt, gt = _pair()
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=10,
        diff_threshold=1e-5,
        tile_q=256,
        tile_r=256,
    )
    # Pre-estimate normals once so both paths see identical inputs.
    src = estimate_normals(src, k=cfg.k_normals)
    tgt = estimate_normals(tgt, k=cfg.k_normals)
    res_single = register(src, tgt, cfg)
    mesh = make_mesh(axis_names=("points",))
    res_sharded = sharded_register(src, tgt, cfg, mesh, ring=ring)

    # elementwise comparison: fp32 arccos in distance_to can't resolve
    # sub-5e-4 rad angles, but R/t entries compare directly
    assert np.allclose(
        np.asarray(res_single.transform.R),
        np.asarray(res_sharded.transform.R),
        atol=1e-5,
    )
    assert np.allclose(
        np.asarray(res_single.transform.t),
        np.asarray(res_sharded.transform.t),
        atol=1e-5,
    )
    assert np.allclose(
        np.asarray(res_single.final_rmse),
        np.asarray(res_sharded.final_rmse),
        atol=1e-6,
    )
    # and the sharded run still solves the problem
    rot_err, t_err = res_sharded.transform.distance_to(gt)
    assert float(rot_err) < 5e-3 and float(t_err) < 5e-3


def test_sharded_register_pairs_dp():
    mesh = make_mesh(shape=(2, 4), axis_names=("pairs", "points"))
    b, n = 4, 512
    srcs, tgts, gts = [], [], []
    for i in range(b):
        s, t, g = _pair(n=n, seed=10 + i, angle=0.15, trans=0.1)
        s = estimate_normals(s, k=8)
        t = estimate_normals(t, k=8)
        srcs.append(s)
        tgts.append(t)
        gts.append(g)
    stack = lambda cs, f: jnp.stack([f(c) for c in cs])
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=10,
        diff_threshold=1e-5,
        k_normals=8,
        tile_q=128,
        tile_r=128,
    )
    res = sharded_register_pairs(
        stack(srcs, lambda c: c.xyz),
        stack(srcs, lambda c: c.mask),
        stack(srcs, lambda c: c.normals),
        stack(tgts, lambda c: c.xyz),
        stack(tgts, lambda c: c.mask),
        stack(tgts, lambda c: c.normals),
        cfg,
        mesh,
    )
    assert res.transform.R.shape == (b, 3, 3)
    for i in range(b):
        one = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot_err, t_err = one.distance_to(gts[i])
        assert float(rot_err) < 5e-3, f"pair {i}: rot {float(rot_err)}"
        assert float(t_err) < 5e-3, f"pair {i}: t {float(t_err)}"


@pytest.mark.parametrize("ring", [False, True])
def test_sharded_block_nn_register(ring):
    """Block (tile-index) NN inside shard_map — the scalable P3 path: per-shard KD sort + tile index, ring
    rotation of index+payload when the target is sharded. Must solve the
    same problem the brute sharded path does."""
    src, tgt, gt = _pair(n=4096, seed=3)
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=1e-6,
        nn_method="block",
        block_tile=64,
        block_q_tile=32,
        block_k=6,
        robust="huber",
    )
    src = estimate_normals(src, k=cfg.k_normals)
    tgt = estimate_normals(tgt, k=cfg.k_normals)
    mesh = make_mesh(axis_names=("points",))
    res = sharded_register(src, tgt, cfg, mesh, ring=ring)
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3, float(rot_err)
    assert float(t_err) < 5e-3, float(t_err)
    # and it agrees with the single-device block path to NN-miss noise
    res_single = register(src, tgt, cfg)
    assert np.allclose(
        np.asarray(res_single.transform.t),
        np.asarray(res.transform.t),
        atol=5e-4,
    )


def test_sharded_gicp_register():
    """GICP sharded: covariance payloads plumb through the points mesh
    (the sharded path used to refuse gicp)."""
    src, tgt, gt = _pair(n=1024, seed=7, angle=0.15, trans=0.1)
    cfg = ICPConfig(
        objective="gicp",
        max_iters=12,
        diff_threshold=1e-6,
        tile_q=256,
        tile_r=256,
    )
    mesh = make_mesh(axis_names=("points",))
    res = sharded_register(src, tgt, cfg, mesh, ring=False)
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3, float(rot_err)
    assert float(t_err) < 5e-3, float(t_err)
    # ring variant: covariances ride the ring payload (12 channels)
    res_ring = sharded_register(src, tgt, cfg, mesh, ring=True)
    assert np.allclose(
        np.asarray(res.transform.t),
        np.asarray(res_ring.transform.t),
        atol=1e-5,
    )


def test_sharded_robust_stats_shard_independent():
    """Auto (MAD) robust scale + trim quantile must be shard-count
    independent: psum'd histogram statistics.
    Compare 8-shard vs single-device with robust='huber', robust_scale=0
    and trimming enabled — round 1 documented these as divergent."""
    src, tgt, gt = _pair(n=2048, seed=11)
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=10,
        diff_threshold=1e-6,
        robust="huber",
        robust_scale=0.0,
        trim_fraction=0.9,
        tile_q=256,
        tile_r=256,
    )
    src = estimate_normals(src, k=cfg.k_normals)
    tgt = estimate_normals(tgt, k=cfg.k_normals)
    res_single = register(src, tgt, cfg)
    mesh = make_mesh(axis_names=("points",))
    res_sharded = sharded_register(src, tgt, cfg, mesh, ring=False)
    # histogram quantiles have ~1e-4 relative resolution, so allow small
    # weight-driven differences — but the solves must agree far tighter
    # than the round-1 per-shard statistics allowed
    assert np.allclose(
        np.asarray(res_single.transform.R),
        np.asarray(res_sharded.transform.R),
        atol=1e-4,
    )
    assert np.allclose(
        np.asarray(res_single.transform.t),
        np.asarray(res_sharded.transform.t),
        atol=1e-4,
    )
    rot_err, t_err = res_sharded.transform.distance_to(gt)
    assert float(rot_err) < 5e-3 and float(t_err) < 5e-3


def test_sharded_ndt_register():
    """NDT cells are a plain PointCloud-with-covariances, so the sharded
    GICP path registers against them unchanged: sharded == single."""
    from icpx.registration.ndt import ndt_cells

    src, tgt, gt = _pair()
    cells = ndt_cells(tgt, cell_size=32)
    n = src.capacity
    src_c = src.replace(
        covs=jnp.broadcast_to(
            1e-4 * jnp.eye(3, dtype=jnp.float32), (n, 3, 3)
        )
    )
    # robust="none": the auto MAD scale is an exact quantile on one
    # device but a psum'd histogram when sharded (shard-layout-stable,
    # not bit-equal to the exact one) — equivalence needs matching math
    cfg = ICPConfig(
        objective="gicp",
        max_iters=15,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        tile_q=256,
        tile_r=256,
    )
    res_single = register(src_c, cells, cfg)
    mesh = make_mesh(axis_names=("points",))
    res_sharded = sharded_register(src_c, cells, cfg, mesh, ring=False)
    assert np.allclose(
        np.asarray(res_single.transform.R),
        np.asarray(res_sharded.transform.R),
        atol=1e-5,
    )
    assert np.allclose(
        np.asarray(res_single.transform.t),
        np.asarray(res_sharded.transform.t),
        atol=1e-5,
    )
    rot_err, t_err = res_sharded.transform.distance_to(gt)
    assert float(rot_err) < 1e-2 and float(t_err) < 3e-2


def test_parallel_odometry_matches_sequential():
    """DP odometry (all consecutive pairs at once over the pairs axis)
    recovers the same trajectory class as the sequential frontend on a
    small-motion sequence."""
    from icpx.odometry.evaluate import ate_rmse
    from icpx.odometry.frontend import OdometryConfig, run_odometry
    from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans
    from icpx.odometry.parallel import parallel_odometry

    world = make_world(n_points=60000, extent=30.0, seed=0)
    gt = make_trajectory(9, speed=0.5, turn=0.03)
    frames = simulate_scans(
        world, gt, max_range=18.0, points_per_scan=2048, noise=0.01, seed=1
    )
    gt0 = [gt[0].inverse() @ g for g in gt]
    icp = ICPConfig(
        objective="symmetric",
        max_iters=12,
        diff_threshold=0.0,
        rmse_change_tol=1e-6,
        robust="huber",
        max_corr_dist=2.0,
        tile_q=512,
        tile_r=512,
    )
    mesh = make_mesh(axis_names=("pairs", "points"), shape=(4, 2))
    # identity init needs a larger iteration budget than the motion-model
    # seeded sequential path
    import dataclasses

    poses, edges, rmse = parallel_odometry(
        frames, dataclasses.replace(icp, max_iters=30), mesh
    )
    assert len(poses) == 9 and len(edges) == 8
    ate_par = ate_rmse(poses, gt0, align=False)
    seq = run_odometry(
        frames, OdometryConfig(icp=icp, keyframe_trans=0.4, keyframe_rot=0.1)
    )
    ate_seq = ate_rmse(seq.poses, gt0, align=False)
    assert ate_par < max(2.0 * ate_seq, 0.08), (ate_par, ate_seq)
    assert np.isfinite(np.asarray(rmse)).all()


def test_pairs_aux_width_validated():
    """The pairs aux channel is width-checked: GICP needs (B, N, 9)
    covariances, normals objectives need (B, N, 3) — a mismatch fails
    loudly instead of mis-reshaping."""
    mesh = make_mesh(axis_names=("pairs", "points"), shape=(2, 4))
    z3 = jnp.zeros((2, 256, 3))
    z9 = jnp.zeros((2, 256, 9))
    m = jnp.ones((2, 256), bool)
    with pytest.raises(ValueError, match="covariances"):
        sharded_register_pairs(
            z3, m, z3, z3, m, z3, ICPConfig(objective="gicp"), mesh
        )
    with pytest.raises(ValueError, match="aux channel width"):
        sharded_register_pairs(
            z3, m, z9, z3, m, z9, ICPConfig(objective="symmetric"), mesh
        )


def test_sharded_pairs_gicp_matches_single():
    """GICP on the DP pairs path (aux width 9 + per-pair covariance
    rotation) recovers each pair's GT and matches single-device register
    (the carve-out is gone)."""
    from icpx.kernels.normals import estimate_covariances

    mesh = make_mesh(shape=(2, 4), axis_names=("pairs", "points"))
    b, n = 2, 1024
    cfg = ICPConfig(
        objective="gicp", max_iters=12, diff_threshold=1e-6,
        tile_q=256, tile_r=256,
    )
    srcs, tgts, gts = [], [], []
    for i in range(b):
        s, t, g = _pair(n=n, seed=20 + i, angle=0.15, trans=0.1)
        srcs.append(estimate_covariances(s, k=15))
        tgts.append(estimate_covariances(t, k=15))
        gts.append(g)
    res = sharded_register_pairs(
        jnp.stack([c.xyz for c in srcs]),
        jnp.stack([c.mask for c in srcs]),
        jnp.stack([c.covs.reshape(n, 9) for c in srcs]),
        jnp.stack([c.xyz for c in tgts]),
        jnp.stack([c.mask for c in tgts]),
        jnp.stack([c.covs.reshape(n, 9) for c in tgts]),
        cfg,
        mesh,
    )
    for i in range(b):
        one = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot_err, t_err = one.distance_to(gts[i])
        assert float(rot_err) < 5e-3, f"pair {i}: rot {float(rot_err)}"
        assert float(t_err) < 5e-3, f"pair {i}: t {float(t_err)}"
        single = register(srcs[i], tgts[i], cfg)
        assert np.allclose(
            np.asarray(single.transform.t),
            np.asarray(res.transform.t[i]),
            atol=5e-4,
        )


def test_parallel_odometry_gicp():
    """parallel_odometry with objective='gicp' estimates covariances per
    frame and runs the pairs path."""
    from icpx.odometry.parallel import parallel_odometry

    cfg = ICPConfig(
        objective="gicp", max_iters=10, diff_threshold=1e-6,
        tile_q=256, tile_r=256,
    )
    world = synthetic_surface(4096, seed=4)
    motion = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.02, jnp.asarray([0.05, 0.0, 0.0])
    )
    frames, cur = [], np.asarray(world)
    for k in range(3):
        frames.append(PointCloud.create(cur))
        cur = np.asarray(motion.apply(jnp.asarray(cur)))
    mesh = make_mesh(axis_names=("pairs", "points"), shape=(2, 4))
    poses, edges, rmse = parallel_odometry(frames, cfg, mesh)
    assert len(poses) == 3 and len(edges) == 2
    for k, (_, _, rel) in enumerate(edges):
        rot_err, t_err = rel.inverse().distance_to(motion)
        assert float(rot_err) < 5e-3, (k, float(rot_err))
        assert float(t_err) < 5e-3, (k, float(t_err))


@pytest.mark.parametrize("ring", [False, True])
def test_sharded_feat_nn_register(ring):
    """feat_nn rides the sharded block path:
    the degenerate-plane scenario only solvable with the 4D metric, at 8
    shards, both replicated-target and ring modes; matches single-device."""
    n = 8192
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    inten = 3.0 * xy[:, 0]
    shift = np.asarray([0.15, 0.0, 0.0], np.float32)
    src = PointCloud.create(xyz, feats=inten, feat_names=("intensity",))
    tgt = PointCloud.create(
        xyz + shift, feats=inten, feat_names=("intensity",)
    )
    cfg = ICPConfig(
        objective="p2p", max_iters=25, diff_threshold=0.0,
        rmse_change_tol=1e-7, nn_method="block", block_tile=64,
        block_q_tile=32, feat_nn="intensity", feat_nn_weight=1.0,
    )
    mesh = make_mesh(axis_names=("points",))
    res = sharded_register(src, tgt, cfg, mesh, ring=ring)
    gt = SE3.identity().replace(t=jnp.asarray(shift))
    _, t_err = res.transform.distance_to(gt)
    assert float(t_err) < 0.02, float(t_err)
    res_single = register(src, tgt, cfg)
    assert np.allclose(
        np.asarray(res_single.transform.t),
        np.asarray(res.transform.t),
        atol=2e-3,
    )
