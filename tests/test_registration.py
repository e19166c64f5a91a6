"""End-to-end ICP integration tests — the §4 golden plan: converge with
REAL NN correspondences on SHUFFLED targets (strictly stronger than the
reference, whose correspondence step is a TODO at `myicp.cpp:128-131`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.geometry.transforms import make_rigid_perturbation, transform_cloud
from icpx.io.loaders import has_reference_data, load_cat_pair, synthetic_surface
from icpx.registration.icp import ICPConfig, format_trace, register

needs_ref = pytest.mark.skipif(
    not has_reference_data(), reason="reference fixtures unavailable"
)


def _surface_pair(n=2000, seed=0, angle=0.25, trans=0.2, shuffle=True):
    xyz = synthetic_surface(n, seed=seed)
    src = PointCloud.create(xyz)
    gt = SE3.from_axis_angle(
        jnp.asarray([0.3, -0.2, 0.93]) / np.linalg.norm([0.3, -0.2, 0.93]),
        angle,
        jnp.asarray([trans, -trans / 2, trans / 3]),
    )
    tgt_xyz = np.asarray(gt.apply(src.xyz))[: n]
    if shuffle:
        rng = np.random.default_rng(seed + 1)
        tgt_xyz = tgt_xyz[rng.permutation(n)]
    tgt = PointCloud.create(tgt_xyz)
    return src, tgt, gt


def _check(result, gt, rot_tol=2e-3, t_tol=2e-3):
    rot_err, t_err = result.transform.distance_to(gt)
    assert float(rot_err) < rot_tol, f"rot err {float(rot_err)}"
    assert float(t_err) < t_tol, f"t err {float(t_err)}"


def test_symmetric_converges_shuffled():
    src, tgt, gt = _surface_pair()
    cfg = ICPConfig(objective="symmetric", max_iters=15, diff_threshold=1e-4)
    res = register(src, tgt, cfg)
    _check(res, gt)


def test_p2plane_converges_shuffled():
    src, tgt, gt = _surface_pair()
    cfg = ICPConfig(objective="p2plane", max_iters=20, diff_threshold=1e-4)
    res = register(src, tgt, cfg)
    _check(res, gt, rot_tol=5e-3, t_tol=5e-3)


def test_p2p_converges_shuffled():
    src, tgt, gt = _surface_pair(angle=0.15, trans=0.1)
    cfg = ICPConfig(objective="p2p", max_iters=30, diff_threshold=1e-4)
    res = register(src, tgt, cfg)
    _check(res, gt, rot_tol=2e-2, t_tol=2e-2)


def test_symmetric_with_init():
    src, tgt, gt = _surface_pair(angle=1.1, trans=0.5)
    # Large perturbation: give a rough init, ICP refines it.
    init = gt @ SE3.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.1)
    cfg = ICPConfig(max_iters=15, diff_threshold=1e-4)
    res = register(src, tgt, cfg, init=init)
    _check(res, gt, rot_tol=5e-3, t_tol=5e-3)


def test_robust_with_outliers():
    src, tgt, gt = _surface_pair(n=1500)
    # Inject 10% outlier points into the target.
    rng = np.random.default_rng(3)
    outliers = rng.uniform(-3, 3, size=(150, 3)).astype(np.float32)
    tgt_np = np.concatenate([tgt.to_numpy(), outliers], 0)
    tgt2 = PointCloud.create(tgt_np)
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=20,
        diff_threshold=1e-4,
        robust="tukey",
        max_corr_dist=0.5,
    )
    res = register(src, tgt2, cfg)
    _check(res, gt, rot_tol=5e-3, t_tol=5e-3)


def test_diff_history_decreases():
    src, tgt, gt = _surface_pair()
    cfg = ICPConfig(max_iters=8, diff_threshold=0.0)
    res = register(src, tgt, cfg)
    diffs = np.asarray(res.diff_history)
    valid = diffs[~np.isnan(diffs)]
    assert valid[-1] < valid[0] * 0.1


def test_trace_format():
    src, tgt, _ = _surface_pair(n=500)
    res = register(src, tgt, ICPConfig(max_iters=3, diff_threshold=0.0))
    txt = format_trace(res)
    assert "iters#1 / diff:" in txt


def test_identity_pair_converges_immediately():
    xyz = synthetic_surface(800, seed=2)
    src = PointCloud.create(xyz)
    tgt = PointCloud.create(xyz.copy())
    res = register(src, tgt, ICPConfig(max_iters=5, diff_threshold=1e-3))
    assert bool(res.converged)
    rot_err, t_err = res.transform.distance_to(SE3.identity())
    assert float(rot_err) < 1e-4 and float(t_err) < 1e-4


def test_bunny_line_fixture_rank_deficient_registration():
    """The second reference fixture ("bunny pairs"): the 93-pt cloud from za.txt via the txt->pcd converter
    (`/root/reference/ICP/test.cpp` analogue) is in fact a 1-D LINE
    scan — extent (0.358, 0.0034, 0.0023) — so a full 6-DoF pose is
    UNOBSERVABLE from it (rotation about + translation along the line
    are null directions, so ANY element of that 2-parameter group
    composed with the true transform fits the data equally well —
    comparing the result to one particular gt is meaningless;
    measured: the recovered pose sits ~2 units away in SE3 while every
    point residual is small). The meaningful contract, pinned here:
    registration on this rank-deficient real fixture stays finite and
    converges in the OBSERVABLE subspace — the registered points land
    back on the line, with final rmse well under the 0.36-unit
    extent."""
    from pathlib import Path

    from icpx.io import load_cloud

    bunny = load_cloud(
        Path(__file__).parent / "data" / "txt2pcd_bunny1.pcd"
    )
    assert int(bunny.num_valid()) == 93
    gt = make_rigid_perturbation(
        angle=0.1, translation=(0.02, -0.01, 0.01)
    )
    rng = np.random.default_rng(5)
    valid_np = bunny.to_numpy()  # transform VALID rows only: applying
    # gt to padded sentinel rows would mint 1e8-scale "points"
    tgt_np = np.asarray(gt.apply(jnp.asarray(valid_np)))
    tgt = PointCloud.create(tgt_np[rng.permutation(len(tgt_np))])
    cfg = ICPConfig(
        objective="p2p",  # normals on a line are themselves degenerate
        max_iters=40,
        diff_threshold=0.0,
        rmse_change_tol=1e-10,
        degeneracy_clamp=0.01,
    )
    res = register(bunny, tgt, cfg)
    R = np.asarray(res.transform.R)
    t = np.asarray(res.transform.t)
    assert np.isfinite(R).all() and np.isfinite(t).all()
    # observable component: registered source lies back on the target
    # line (residual well under the line's own extent)
    assert float(res.final_rmse) < 0.036  # < 10% of the 0.36 extent


@needs_ref
def test_cat_pair_shuffled_recovers_gt():
    """The headline golden test: cat.pcd -> cat_out.pcd with SHUFFLED rows
    recovers Rz(pi/4) + (2.5,0,0) — strictly stronger than the reference,
    which depends on index alignment."""
    src, tgt = load_cat_pair()
    rng = np.random.default_rng(0)
    tgt_np = tgt.to_numpy()
    tgt_shuffled = PointCloud.create(tgt_np[rng.permutation(len(tgt_np))])
    gt = make_rigid_perturbation()  # Rz(pi/4), t=(2.5,0,0)
    cfg = ICPConfig(
        objective="symmetric",
        max_iters=20,
        diff_threshold=1.0,  # reference threshold (myicp.cpp:6)
        max_corr_dist=50.0,
        robust="huber",
    )
    res = register(src, tgt_shuffled, cfg)
    rot_err, t_err = res.transform.distance_to(gt)
    # cat extent ~199 units; demand sub-0.5% alignment
    assert float(rot_err) < 5e-3
    assert float(t_err) < 0.5
    # RMSE against true correspondence (unshuffled target, same row order)
    pred = res.transform.apply(src.xyz)
    err = np.linalg.norm(
        np.asarray(pred)[np.asarray(src.mask)] - tgt.to_numpy(), axis=1
    )
    assert float(np.sqrt((err**2).mean())) < 0.5


def test_ndt_registration_recovers_gt():
    """NDT (point-to-cell-distribution) converges on a synthetic pair:
    cells are KD tiles, the solve rides the GICP Mahalanobis path."""
    import numpy as np

    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface
    from icpx.registration.ndt import ndt_cells, register_ndt

    n = 20000
    xyz = synthetic_surface(n, seed=3)
    src = PointCloud.create(xyz)
    gt = make_rigid_perturbation(angle=0.12, translation=(0.08, -0.04, 0.02))
    rng = np.random.default_rng(4)
    tgt_np = np.asarray(gt.apply(src.xyz))[:n]
    tgt = PointCloud.create(tgt_np[rng.permutation(n)])

    cells = ndt_cells(tgt, cell_size=64)
    assert int(cells.num_valid()) >= n // 64 - 2
    # cell covariances are SPD (regularized)
    covs = np.asarray(cells.covs)[np.asarray(cells.mask)]
    eig = np.linalg.eigvalsh(covs)
    assert (eig > 0).all()

    res = register_ndt(src, tgt, cell_size=64)
    rot_err, t_err = res.transform.distance_to(gt)
    # NDT converges to cell-quantization accuracy, not point accuracy
    assert float(rot_err) < 5e-3 and float(t_err) < 2e-2, (
        float(rot_err), float(t_err))


def test_ndt_large_coordinate_offsets():
    """ndt_cells centers before its fp32 moment expansion: a UTM-scale
    offset must not corrupt cell covariances or the registration."""
    import numpy as np

    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface
    from icpx.registration.ndt import ndt_cells, register_ndt

    n = 10000
    off = np.asarray([1.0e5, -2.0e5, 300.0], np.float32)
    xyz = synthetic_surface(n, seed=6) + off
    src = PointCloud.create(xyz)
    gt = make_rigid_perturbation(angle=0.08, translation=(0.05, -0.03, 0.01))
    # rotate about the cloud, not the distant origin
    import jax.numpy as jnp
    from icpx.geometry.se3 import SE3

    c = jnp.asarray(off)
    gt = (SE3.identity().replace(t=c) @ gt
          @ SE3.identity().replace(t=-c))
    rng = np.random.default_rng(7)
    tgt_np = np.asarray(gt.apply(src.xyz))[:n]
    tgt = PointCloud.create(tgt_np[rng.permutation(n)])

    cells = ndt_cells(tgt, cell_size=64)
    covs = np.asarray(cells.covs)[np.asarray(cells.mask)]
    eig = np.linalg.eigvalsh(covs)
    assert (eig > 0).all() and np.isfinite(eig).all()
    # covariance scale ~ cell extents, not coordinate-resolution noise
    assert np.median(eig[:, 2]) < 1.0, np.median(eig[:, 2])

    res = register_ndt(src, tgt, cell_size=64)
    # quality measured as displacement ON the cloud: comparing global
    # transforms at a 2e5 lever arm turns fp32 rotation noise (~5e-4
    # rad, below arccos resolution) into tens of meters of apparent
    # translation difference
    est_pts = np.asarray(res.transform.apply(src.xyz))[:n]
    disp = np.linalg.norm(est_pts - tgt_np, axis=1)
    assert float(np.median(disp)) < 0.05, float(np.median(disp))


def test_src_weight_prior():
    """Per-point source weights steer the solve: with all weight on a
    rigidly-consistent subset, a corrupted remainder cannot bias the
    transform (weights zero its votes)."""
    import numpy as np

    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface

    n = 4096
    xyz = synthetic_surface(n, seed=8)
    gt = make_rigid_perturbation(angle=0.1, translation=(0.06, -0.02, 0.01))
    tgt_np = np.asarray(gt.apply(jnp.asarray(xyz)))
    src_np = xyz.copy()
    # corrupt the last quarter of the SOURCE (consistent outlier shift:
    # plain robust IRLS converges to a compromise; zero weights must not)
    src_np[3 * n // 4 :] += np.asarray([0.5, 0.5, 0.0], np.float32)
    src = PointCloud.create(src_np)
    tgt = PointCloud.create(tgt_np)
    cfg = ICPConfig(
        objective="p2p", max_iters=20, diff_threshold=0.0,
        rmse_change_tol=1e-7, nn_method="brute",
    )
    w = np.ones(n, np.float32)
    w[3 * n // 4 :] = 0.0
    res_w = register(src, tgt, cfg, src_weight=jnp.asarray(w))
    rot_w, t_w = res_w.transform.distance_to(gt)
    assert float(t_w) < 5e-3, float(t_w)
    res_raw = register(src, tgt, cfg)
    _, t_raw = res_raw.transform.distance_to(gt)
    assert float(t_raw) > 5.0 * float(t_w), (float(t_raw), float(t_w))


def test_feature_matching_pins_degenerate_plane():
    """A flat plane with an intensity gradient: pure-geometry ICP cannot
    observe in-plane translation (every correspondence slides); with
    feat_nn the 4D metric pairs physically-identical points and the
    in-plane shift is recovered."""
    import numpy as np

    n = 8192
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    xyz = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    inten = 3.0 * xy[:, 0]  # gradient along x only
    shift = np.asarray([0.15, 0.0, 0.0], np.float32)

    src = PointCloud.create(xyz, feats=inten, feat_names=("intensity",))
    tgt = PointCloud.create(
        xyz + shift, feats=inten, feat_names=("intensity",)
    )
    base = dict(
        objective="p2p", max_iters=25, diff_threshold=0.0,
        rmse_change_tol=1e-7, nn_method="block",
    )
    res_geo = register(src, tgt, ICPConfig(**base))
    res_feat = register(
        src, tgt, ICPConfig(feat_nn="intensity", feat_nn_weight=1.0, **base)
    )
    gt = SE3.identity().replace(t=jnp.asarray(shift))
    _, t_geo = res_geo.transform.distance_to(gt)
    _, t_feat = res_feat.transform.distance_to(gt)
    assert float(t_feat) < 0.02, float(t_feat)
    # geometry alone leaves a large fraction of the in-plane shift
    # unrecovered (finite-plane edge effects give partial observability)
    assert float(t_geo) > 3.0 * float(t_feat), (
        float(t_geo), float(t_feat))


def test_ndt_d2d_mode():
    """Distribution-to-distribution NDT: both clouds collapse to cells,
    registration still recovers the transform from ~n/cell_size
    correspondences."""
    import numpy as np

    from icpx.geometry.transforms import make_rigid_perturbation
    from icpx.io.loaders import synthetic_surface
    from icpx.registration.ndt import register_ndt

    n = 20000
    xyz = synthetic_surface(n, seed=3)
    src = PointCloud.create(xyz)
    gt = make_rigid_perturbation(angle=0.1, translation=(0.06, -0.03, 0.02))
    rng = np.random.default_rng(5)
    tgt = PointCloud.create(np.asarray(gt.apply(src.xyz))[:n][
        rng.permutation(n)])
    res = register_ndt(src, tgt, cell_size=64, mode="d2d")
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 1e-2 and float(t_err) < 3e-2, (
        float(rot_err), float(t_err))
