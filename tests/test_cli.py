"""CLI subcommands exercised in-process (argparse -> handlers)."""

import json

import numpy as np
import pytest

from icpx.cli import main
from icpx.cloud import PointCloud
from icpx.io import load_cloud, save_cloud
from icpx.io.loaders import synthetic_surface


@pytest.fixture
def cloud_file(tmp_path):
    path = tmp_path / "src.pcd"
    save_cloud(path, PointCloud.create(synthetic_surface(800, seed=0)))
    return path


def test_info(cloud_file, capsys):
    assert main(["info", str(cloud_file)]) == 0
    out = capsys.readouterr().out
    assert "800 points" in out


def test_convert(cloud_file, tmp_path, capsys):
    out = tmp_path / "out.ply"
    assert main(["convert", str(cloud_file), str(out)]) == 0
    back = load_cloud(out)
    assert int(back.num_valid()) == 800


def test_perturb_then_register(cloud_file, tmp_path, capsys):
    tgt = tmp_path / "tgt.pcd"
    assert main([
        "perturb", str(cloud_file), str(tgt),
        "--angle", "0.2", "--translate", "0.1", "0", "0",
    ]) == 0
    aligned = tmp_path / "aligned.pcd"
    metrics = tmp_path / "m.jsonl"
    assert main([
        "register", str(cloud_file), str(tgt),
        "--max-iters", "12", "--diff-threshold", "1e-5",
        "--out", str(aligned), "--metrics", str(metrics),
    ]) == 0
    out = capsys.readouterr().out
    assert "iters#1 / diff:" in out  # reference-format trace
    assert "transform:" in out
    recs = [json.loads(l) for l in metrics.read_text().splitlines()]
    assert recs[-1]["event"] == "icp_done"
    # aligned cloud ~= target
    a = load_cloud(aligned).to_numpy()
    b = load_cloud(tgt).to_numpy()
    d = np.abs(np.sort(a[:, 0]) - np.sort(b[:, 0])).mean()
    assert d < 1e-3


def test_horn(cloud_file, tmp_path, capsys):
    tgt = tmp_path / "t.pcd"
    main(["perturb", str(cloud_file), str(tgt), "--angle", "0.3"])
    assert main(["horn", str(cloud_file), str(tgt)]) == 0
    assert "R:" in capsys.readouterr().out


def test_odometry_synthetic(tmp_path, capsys):
    metrics = tmp_path / "odo.jsonl"
    ck = tmp_path / "odo.npz"
    assert main([
        "odometry", "--synthetic", "--frames", "5",
        "--points-per-scan", "1024",
        "--metrics", str(metrics), "--checkpoint", str(ck),
    ]) == 0
    out = capsys.readouterr().out
    assert "5 frames" in out
    assert ck.exists()
    assert len(metrics.read_text().splitlines()) == 5


def test_register_config_override(cloud_file, tmp_path):
    cfgf = tmp_path / "cfg.json"
    cfgf.write_text(json.dumps({"robust": "huber", "max_iters": 3}))
    assert main([
        "register", str(cloud_file), str(cloud_file), "--config", str(cfgf)
    ]) == 0


def test_bad_odometry_args():
    with pytest.raises(SystemExit):
        main(["odometry"])  # no source given


def test_odometry_cli_resume_matches_full(tmp_path, capsys):
    """icpx odometry --resume continues a killed run to the same
    trajectory (synthetic frames are prefix-stable in --frames)."""
    ck_full = tmp_path / "full.npz"
    ck_part = tmp_path / "part.npz"
    ck_res = tmp_path / "resumed.npz"
    common = ["odometry", "--synthetic", "--points-per-scan", "1024"]
    assert main(common + ["--frames", "8", "--checkpoint", str(ck_full)]) == 0
    assert main(common + ["--frames", "5", "--checkpoint", str(ck_part)]) == 0
    assert main(common + [
        "--frames", "8", "--resume", str(ck_part),
        "--checkpoint", str(ck_res),
    ]) == 0
    assert "resuming from" in capsys.readouterr().out
    from icpx.utils.checkpoint import OdometryCheckpoint

    full = OdometryCheckpoint.load(ck_full)
    res = OdometryCheckpoint.load(ck_res)
    np.testing.assert_allclose(res.poses_t, full.poses_t, atol=1e-6)
    np.testing.assert_allclose(res.poses_R, full.poses_R, atol=1e-6)
    assert [e[:2] for e in res.edges] == [e[:2] for e in full.edges]


def test_register_ndt_objective(cloud_file, tmp_path, capsys):
    tgt = tmp_path / "nt.pcd"
    main(["perturb", str(cloud_file), str(tgt), "--angle", "0.1"])
    assert main([
        "register", str(cloud_file), str(tgt),
        "--objective", "ndt", "--ndt-cell", "32", "--max-iters", "25",
        "--diff-threshold", "0",
    ]) == 0
    assert "converged" in capsys.readouterr().out


def test_compiled_rejects_host_only_flags(tmp_path):
    import pytest

    with pytest.raises(SystemExit, match="--compiled does not support"):
        main([
            "odometry", "--synthetic", "--frames", "4",
            "--points-per-scan", "512", "--compiled",
            "--resume", str(tmp_path / "x.npz"),
        ])
    with pytest.raises(SystemExit, match="dynamic-sigma"):
        main([
            "odometry", "--synthetic", "--frames", "4",
            "--points-per-scan", "512", "--compiled",
            "--dynamic-sigma", "3.0",
        ])


def test_register_ndt_rejects_pyramid(cloud_file, tmp_path):
    import pytest

    tgt = tmp_path / "t2.pcd"
    main(["perturb", str(cloud_file), str(tgt), "--angle", "0.1"])
    with pytest.raises(SystemExit, match="ndt does not compose"):
        main([
            "register", str(cloud_file), str(tgt),
            "--objective", "ndt", "--pyramid-levels", "2",
        ])


def test_odometry_scan_to_map_cli(capsys):
    """--mode scan_to_map drives the voxel-map frontend from the CLI
    (the tested map mode had no CLI surface)."""
    assert main([
        "odometry", "--synthetic", "--frames", "5",
        "--points-per-scan", "1024",
        "--mode", "scan_to_map", "--map-cell", "0.2",
        "--map-capacity", "16384",
    ]) == 0
    assert "5 frames" in capsys.readouterr().out


def test_compiled_rejects_scan_to_map():
    with pytest.raises(SystemExit, match="scan_to_map"):
        main([
            "odometry", "--synthetic", "--frames", "4",
            "--points-per-scan", "512", "--compiled",
            "--mode", "scan_to_map",
        ])


def test_data_dir_env_read_at_call_time(tmp_path, monkeypatch):
    """ICPX_DATA_DIR set AFTER import must take effect (it used to be
    read once at import)."""
    from icpx.io import loaders

    monkeypatch.setenv("ICPX_DATA_DIR", str(tmp_path))
    assert loaders.reference_data_dir() == tmp_path
    assert loaders.REFERENCE_DATA_DIR == tmp_path  # dynamic module attr
    assert not loaders.has_reference_data()  # empty dir: no cat.pcd
    monkeypatch.delenv("ICPX_DATA_DIR")
    assert loaders.has_reference_data()  # vendored fixtures back


def test_odometry_velodyne_dir_end_to_end(tmp_path, capsys):
    """Full KITTI-format path: write byte-exact .bin scans + poses file,
    then run `icpx odometry --velodyne-dir` over them and check the ATE
    the CLI computes against the poses file (.bin ingest -> odometry -> ATE, not just format round-trips)."""
    import jax.numpy as jnp

    from icpx.geometry.se3 import SE3
    from icpx.odometry.kitti import (
        load_kitti_sequence,
        make_trajectory,
        make_world,
        simulate_scans,
        write_kitti_sequence,
    )

    world = make_world(n_points=60000, extent=25.0, seed=0, n_posts=120,
                       ground_frac=0.5)
    gt = make_trajectory(6, speed=0.6, turn=0.02)
    frames = simulate_scans(world, gt, max_range=15.0,
                            points_per_scan=2048, noise=0.01, seed=1)
    # give scans a reflectance channel so the full quadruple round-trips
    frames = [
        f.replace(
            feats=jnp.abs(f.xyz[:, 2:3]) % 1.0, feat_names=("reflectance",)
        )
        for f in frames
    ]
    vel = tmp_path / "velodyne"
    poses_file = tmp_path / "poses.txt"
    # KITTI convention: poses are relative to the first frame
    rel = [gt[0].inverse() @ g for g in gt]
    write_kitti_sequence(vel, frames, rel, poses_path=poses_file)
    assert len(list(vel.glob("*.bin"))) == 6

    # byte-level check: each .bin is raw float32 xyzr quadruples
    raw = np.fromfile(vel / "000000.bin", dtype=np.float32)
    assert raw.size % 4 == 0 and raw.size // 4 == int(frames[0].num_valid())

    # ingest parity: loader reproduces the written geometry
    back = load_kitti_sequence(vel, with_intensity=True)
    assert back[0].feat_names == ("reflectance",)

    assert main([
        "odometry", "--velodyne-dir", str(vel), "--poses", str(poses_file),
        "--frames", "6", "--keyframe-trans", "0.5",
    ]) == 0
    out = capsys.readouterr().out
    assert "6 frames" in out
    ate_line = [l for l in out.splitlines() if l.startswith("ATE")][0]
    ate = float(ate_line.split()[1])
    assert ate < 0.3, out
