"""Failure handling: shard loss, corrupted points, stall watchdog,
NaN audits, shard-equivalence reporting (SURVEY §5.2/5.3)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpx.cloud import PointCloud
from icpx.distributed.fault import (
    HeartbeatMonitor,
    corrupt_points,
    drop_shard,
)
from icpx.distributed.mesh import make_mesh
from icpx.distributed.sharded_icp import sharded_register
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.kernels.normals import estimate_normals
from icpx.registration.icp import ICPConfig, register
from icpx.utils.debug import (
    assert_all_finite,
    nan_checks,
    shard_equivalence_report,
)


def _pair(n=1024, seed=0):
    xyz = synthetic_surface(n, seed=seed)
    src = PointCloud.create(xyz)
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.12, jnp.asarray([0.06, 0.0, 0.02])
    )
    rng = np.random.default_rng(seed + 1)
    tgt = PointCloud.create(np.asarray(gt.apply(src.xyz))[:n][rng.permutation(n)])
    return src, tgt, gt


def test_survives_dropped_shard():
    """Losing 1/8 of the source points still registers correctly."""
    src, tgt, gt = _pair()
    src = src.replace(mask=drop_shard(src.mask, 2, 8))
    res = register(src, tgt, ICPConfig(max_iters=12, diff_threshold=1e-5))
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3 and float(t_err) < 5e-3


def test_sharded_with_empty_device_shard():
    """A device whose whole point shard is masked out must not poison the
    psum (its partial sums are zeros)."""
    src, tgt, gt = _pair()
    src = estimate_normals(src, k=8)
    tgt = estimate_normals(tgt, k=8)
    src = src.replace(mask=drop_shard(src.mask, 0, 8))  # device 0 empty
    mesh = make_mesh(axis_names=("points",))
    cfg = ICPConfig(max_iters=10, diff_threshold=1e-5, tile_q=128, tile_r=128)
    res = sharded_register(src, tgt, cfg, mesh)
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 5e-3 and float(t_err) < 5e-3
    assert_all_finite(res.transform, "transform")


def test_corrupted_points_with_robust_gate(key):
    src, tgt, gt = _pair(n=2000)
    bad = corrupt_points(src.xyz, key, fraction=0.05, magnitude=10.0)
    src = src.with_xyz(bad)
    cfg = ICPConfig(
        max_iters=15,
        diff_threshold=1e-5,
        robust="huber",
        max_corr_dist=0.3,
    )
    res = register(src, tgt, cfg)
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 1e-2 and float(t_err) < 1e-2


def test_heartbeat_detects_stall():
    stalls = []
    mon = HeartbeatMonitor(timeout_s=0.3, on_stall=lambda: stalls.append(1))
    with mon:
        mon.beat()
        time.sleep(0.8)
    assert mon.stalled and stalls


def test_heartbeat_no_false_positive():
    mon = HeartbeatMonitor(timeout_s=1.0)
    with mon:
        for _ in range(4):
            time.sleep(0.1)
            mon.beat(jnp.ones(8) * 2)
    assert not mon.stalled


def test_guarded_call_passes_and_raises():
    """guarded_call is the entry-point integration of HeartbeatMonitor
    (bench.py reps, run_odometry per-frame fences): a completing fence
    returns its value, a stalled one raises CollectiveStallError within
    the timeout, and a fence's own exception propagates."""
    from icpx.distributed.fault import CollectiveStallError, guarded_call

    assert guarded_call(lambda: 41 + 1, timeout_s=5.0) == 42
    assert guarded_call(lambda: "inline", timeout_s=0.0) == "inline"

    t0 = time.monotonic()
    with pytest.raises(CollectiveStallError):
        guarded_call(lambda: time.sleep(30.0), timeout_s=0.4)
    assert time.monotonic() - t0 < 5.0  # detected, not waited out

    with pytest.raises(ValueError, match="boom"):
        guarded_call(lambda: (_ for _ in ()).throw(ValueError("boom")),
                     timeout_s=5.0)


def test_odometry_frontend_runs_under_watchdog():
    """run_odometry with an explicit stall_timeout_s completes normally
    (per-frame fences beat)."""
    from icpx.odometry.frontend import OdometryConfig, run_odometry
    from icpx.odometry.kitti import make_trajectory, make_world, simulate_scans

    world = make_world(n_points=20000, extent=20.0, seed=0)
    gt = make_trajectory(4, speed=0.5)
    frames = simulate_scans(world, gt, points_per_scan=1024, seed=1)
    cfg = OdometryConfig(
        icp=ICPConfig(max_iters=6, diff_threshold=0.0, rmse_change_tol=1e-6,
                      robust="huber", max_corr_dist=2.0),
        stall_timeout_s=120.0,
    )
    res = run_odometry(frames, cfg)
    assert len(res.poses) == 4
    assert all(np.isfinite(np.asarray(p.t)).all() for p in res.poses)


def test_assert_all_finite_catches():
    with pytest.raises(FloatingPointError):
        assert_all_finite({"a": jnp.asarray([1.0, jnp.nan])})
    assert_all_finite({"a": jnp.ones(3)})  # no raise


def test_shard_equivalence_report():
    a = {"x": jnp.ones(4), "y": jnp.asarray([1.0, 2.0])}
    b = {"x": jnp.ones(4), "y": jnp.asarray([1.0, 2.1])}
    assert shard_equivalence_report(a, a) == {}
    rep = shard_equivalence_report(a, b)
    assert list(rep) == ["['y']"] and abs(rep["['y']"] - 0.1) < 1e-6


def test_nan_checks_context():
    with nan_checks(True):
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
    # outside the scope, NaNs flow silently again
    out = jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0))
    assert np.isnan(np.asarray(out))