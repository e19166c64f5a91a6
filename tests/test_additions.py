"""Trimmed ICP, LZF-compressed PCD, multi-host helpers, CLI loop closure."""

import numpy as np
import pytest

from icpx.cloud import PointCloud
from icpx.geometry.se3 import SE3
from icpx.io.loaders import synthetic_surface
from icpx.registration.icp import ICPConfig, register


def test_trimmed_icp_partial_overlap():
    """Half the source has no counterpart; trimming solves it without a
    hand-tuned distance gate."""
    import jax.numpy as jnp

    xyz = synthetic_surface(3000, seed=0)
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.15, jnp.asarray([0.08, -0.04, 0.02])
    )
    # target covers only points with u > 0 (half the surface)
    tgt_np = np.asarray(gt.apply(jnp.asarray(xyz)))
    tgt = PointCloud.create(tgt_np[xyz[:, 0] > 0])
    src = PointCloud.create(xyz)
    res_plain = register(
        src, tgt, ICPConfig(max_iters=15, diff_threshold=1e-5)
    )
    res_trim = register(
        src, tgt, ICPConfig(max_iters=15, diff_threshold=1e-5, trim_fraction=0.4)
    )
    _, t_plain = res_plain.transform.distance_to(gt)
    _, t_trim = res_trim.transform.distance_to(gt)
    assert float(t_trim) < 5e-3, f"trimmed failed: {float(t_trim)}"
    assert float(t_trim) < float(t_plain)  # and beats untrimmed


def test_pcd_binary_compressed_roundtrip(tmp_path, rng):
    from icpx.io import native
    from icpx.io.pcd import read_pcd, write_pcd

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    xyz = rng.normal(size=(1000, 3)).astype(np.float32) * 10
    nrm = rng.normal(size=(1000, 3)).astype(np.float32)
    p = tmp_path / "c.pcd"
    write_pcd(p, xyz, normals=nrm, compressed=True)
    head = p.read_bytes()[:400]
    assert b"binary_compressed" in head
    rec = read_pcd(p)
    assert np.allclose(rec["xyz"], xyz)
    assert np.allclose(rec["normals"], nrm)


def test_lzf_python_native_agree(rng):
    from icpx.io import native
    from icpx.io.pcd import _lzf_decompress_py

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    data = rng.integers(0, 10, 5000).astype(np.uint8).tobytes()  # compressible
    comp = native.lzf_compress(data)
    assert comp is not None and len(comp) < len(data)
    assert native.lzf_decompress(comp, len(data)) == data
    assert _lzf_decompress_py(comp, len(data)) == data


def test_multihost_helpers_single_process():
    import jax

    from icpx.distributed.multihost import (
        global_mesh,
        host_local_shard,
        init_multihost,
    )

    assert init_multihost() is False  # single process: no-op
    mesh = global_mesh(("hosts", "points"))
    assert mesh.shape["hosts"] == 1
    assert mesh.shape["points"] == jax.device_count()
    arr = np.arange(12).reshape(12, 1)
    assert np.array_equal(host_local_shard(arr), arr)  # 1 host = all


def test_cli_odometry_loop_closure(capsys):
    from icpx.cli import main

    rc = main([
        "odometry", "--synthetic", "--frames", "6",
        "--points-per-scan", "1024", "--loop-closure",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loop closures:" in out

def test_gicp_converges():
    """Generalized ICP (plane-to-plane) recovers the transform."""
    import jax.numpy as jnp

    xyz = synthetic_surface(2500, seed=4)
    src = PointCloud.create(xyz)
    axis = np.array([0.1, -0.2, 0.97])
    axis = axis / np.linalg.norm(axis)
    gt = SE3.from_axis_angle(
        jnp.asarray(axis, jnp.float32), 0.2,
        jnp.asarray([0.1, -0.05, 0.03], jnp.float32),
    )
    rng2 = np.random.default_rng(7)
    tgt = PointCloud.create(
        np.asarray(gt.apply(src.xyz))[:2500][rng2.permutation(2500)]
    )
    res = register(
        src, tgt,
        ICPConfig(objective="gicp", max_iters=20, diff_threshold=1e-5),
    )
    rot_err, t_err = res.transform.distance_to(gt)
    assert float(rot_err) < 3e-3, float(rot_err)
    assert float(t_err) < 3e-3, float(t_err)


def test_gicp_with_normal_direction_noise():
    """Scanner-like noise along the normals: GICP still converges tightly
    (its plane-to-plane information model soft-pedals the normal
    direction)."""
    import jax.numpy as jnp

    from icpx.kernels.normals import estimate_normals

    xyz = synthetic_surface(3000, seed=9)
    pc = estimate_normals(PointCloud.create(xyz), k=10)
    nrm = np.asarray(pc.normals)[:3000]
    rng2 = np.random.default_rng(11)
    noisy = xyz + nrm * rng2.normal(0, 0.01, (3000, 1)).astype(np.float32)
    gt = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.1, jnp.asarray([0.05, 0.02, 0.0])
    )
    src = PointCloud.create(noisy.astype(np.float32))
    tgt = PointCloud.create(np.asarray(gt.apply(jnp.asarray(xyz))))
    res = register(
        src, tgt,
        ICPConfig(objective="gicp", max_iters=25, diff_threshold=0.0,
                  rmse_change_tol=1e-7),
    )
    _, t_err = res.transform.distance_to(gt)
    assert float(t_err) < 5e-3, float(t_err)


def test_register_batch_matches_individual():
    import jax.numpy as jnp

    from icpx.kernels.normals import estimate_normals
    from icpx.registration.icp import register_batch

    b, n = 3, 768
    srcs, tgts, gts = [], [], []
    for i in range(b):
        xyz = synthetic_surface(n, seed=30 + i)
        s = estimate_normals(PointCloud.create(xyz, capacity=n), k=8)
        gt = SE3.from_axis_angle(
            jnp.asarray([0.0, 0.0, 1.0]), 0.1 + 0.05 * i,
            jnp.asarray([0.05, -0.02 * i, 0.0]),
        )
        rng2 = np.random.default_rng(i)
        t = estimate_normals(
            PointCloud.create(
                np.asarray(gt.apply(s.xyz))[:n][rng2.permutation(n)],
                capacity=n,
            ),
            k=8,
        )
        srcs.append(s); tgts.append(t); gts.append(gt)
    stack = lambda cs, f: np.stack([np.asarray(f(c)) for c in cs])
    cfg = ICPConfig(max_iters=10, diff_threshold=1e-5, k_normals=8,
                    tile_q=256, tile_r=256)
    res = register_batch(
        jnp.asarray(stack(srcs, lambda c: c.xyz)),
        jnp.asarray(stack(srcs, lambda c: c.mask)),
        jnp.asarray(stack(srcs, lambda c: c.normals)),
        jnp.asarray(stack(tgts, lambda c: c.xyz)),
        jnp.asarray(stack(tgts, lambda c: c.mask)),
        jnp.asarray(stack(tgts, lambda c: c.normals)),
        cfg,
    )
    for i in range(b):
        est = SE3(R=res.transform.R[i], t=res.transform.t[i])
        rot_err, t_err = est.distance_to(gts[i])
        assert float(rot_err) < 5e-3, f"pair {i}"
        assert float(t_err) < 5e-3, f"pair {i}"


def test_failed_registration_reports_not_converged():
    """Zero correspondences (impossible gate) must NOT report converged."""
    xyz = synthetic_surface(500, seed=1)
    src = PointCloud.create(xyz)
    tgt = PointCloud.create(xyz + np.float32(10.0))
    res = register(
        src, tgt, ICPConfig(max_iters=5, max_corr_dist=1e-6)
    )
    assert not bool(res.converged)
    assert int(res.inlier_count) == 0
    assert np.isfinite(np.asarray(res.transform.t)).all()


def test_large_offset_coordinates():
    """Clouds far from the origin register exactly like centred ones
    (register() auto-centers; the block-NN validity heuristics only see
    centred coordinates). The offset magnitude is bounded by fp32 INGEST
    precision, not by the solver: at 2e4 the quantization step (~2e-3)
    still resolves the surface detail relative to its ~0.01 point
    spacing; larger magnitudes need f64 centring at ingest."""
    import jax.numpy as jnp

    offset = np.asarray([2.0e3, -1.5e3, 300.0], np.float32)
    xyz = synthetic_surface(40000, seed=2) + offset
    src = PointCloud.create(xyz)
    # rotate about the cloud centroid (a rotation about the world origin
    # would fling a UTM cloud megameters away)
    rot = SE3.from_axis_angle(
        jnp.asarray([0.0, 0.0, 1.0]), 0.1, jnp.asarray([0.05, 0.02, 0.0])
    )
    c = SE3.identity().replace(t=jnp.asarray(offset))
    gt = c @ rot @ c.inverse()
    rng2 = np.random.default_rng(3)
    n = 40000
    tgt = PointCloud.create(
        np.asarray(gt.apply(src.xyz))[:n][rng2.permutation(n)]
    )
    # n >= 32768 -> auto block path (the one with validity heuristics)
    res = register(src, tgt, ICPConfig(max_iters=12, diff_threshold=0.0,
                                       rmse_change_tol=1e-6))
    rot_err, t_err = res.transform.distance_to(gt)
    assert bool(res.converged)
    assert float(rot_err) < 5e-3, float(rot_err)
    assert float(t_err) < 5e-2, float(t_err)


def test_block_nn_chunking_non_divisible():
    """Prime-ish tile counts go through the padded-chunk path."""
    from icpx.kernels.blocknn import block_nn, build_tile_index
    from icpx.kernels.knn import _nearest_neighbor_jnp
    import jax.numpy as jnp

    r = synthetic_surface(9000, seed=0)
    q = synthetic_surface(8320, seed=1)  # 130 tiles of 64
    ridx = build_tile_index(r, tile_size=256)
    qidx = build_tile_index(q, tile_size=64)
    d_c, i_c = block_nn(qidx.tiles, ridx, k_tiles=8, max_chunk=48)
    d_f, i_f = block_nn(qidx.tiles, ridx, k_tiles=8)
    valid = np.asarray(qidx.order) >= 0
    assert np.allclose(
        np.asarray(d_c)[valid], np.asarray(d_f)[valid], atol=1e-6
    )
    assert np.array_equal(np.asarray(i_c)[valid], np.asarray(i_f)[valid])


def test_xyz_header_line_skipped(tmp_path):
    from icpx.io.xyz import read_xyz_txt

    p = tmp_path / "h.txt"
    p.write_text("x y z\n# comment\n1.0 2.0 3.0\n4.0 5.0 6.0\n")
    out = read_xyz_txt(p)
    assert out.shape == (2, 3)
    assert np.allclose(out[0], [1.0, 2.0, 3.0])


def test_xyz_ragged_row_raises(tmp_path):
    from icpx.io.xyz import read_xyz_txt

    p = tmp_path / "r.txt"
    p.write_text("1 2 3\n4 5\n6 7 8\n")
    with pytest.raises(Exception):
        read_xyz_txt(p)  # numpy fallback raises; never silent misalignment


def test_metrics_nonfinite_is_valid_json(tmp_path):
    import json as _json

    from icpx.utils.metrics import MetricsLogger

    path = tmp_path / "m.jsonl"
    with MetricsLogger(path) as m:
        m.log(rmse=float("inf"), arr=[1.0, float("nan")])
    rec = _json.loads(path.read_text(), parse_constant=lambda c: 1 / 0)
    assert rec["rmse"] is None and rec["arr"][1] is None


def test_ply_leading_nonvertex_element(tmp_path, rng):
    from icpx.io.ply import read_ply

    xyz = rng.normal(size=(4, 3)).astype(np.float32)
    body = "".join(" ".join(f"{v:.5f}" for v in row) + "\n" for row in xyz)
    p = tmp_path / "e.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element meta 2\nproperty float value\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
        "7.0\n8.0\n" + body
    )
    rec = read_ply(p)
    assert np.allclose(rec["xyz"], xyz, atol=1e-4)


def test_checkpoint_structure_mismatch_raises(tmp_path, key):
    import jax.numpy as jnp

    from icpx.utils.checkpoint import load_checkpoint, save_checkpoint

    state = {"a": jnp.ones(3), "b": jnp.zeros(3)}
    p = tmp_path / "s.npz"
    save_checkpoint(p, state)
    wrong = (jnp.ones(3), jnp.zeros(3))  # same leaf count, different tree
    with pytest.raises(ValueError):
        load_checkpoint(p, wrong)


def test_heartbeat_recovers_and_rearms():
    import time as _t

    from icpx.distributed.fault import HeartbeatMonitor

    hits = []
    mon = HeartbeatMonitor(timeout_s=0.25, on_stall=lambda: hits.append(1))
    with mon:
        _t.sleep(0.6)          # first stall
        assert mon.stalled
        mon.beat()             # recovery clears the flag
        assert not mon.stalled
        _t.sleep(0.6)          # second stall must fire again
    assert mon.stalled and len(hits) >= 2


def test_ate_ignores_scale_correctly(key):
    """ATE alignment is rigid: a scaled trajectory shows real error, a
    rigidly-moved one shows none."""
    import jax

    from icpx.odometry.evaluate import ate_rmse

    import jax.numpy as jnp

    gt = [SE3.identity().replace(t=jnp.asarray([float(i), 0.0, 0.0]))
          for i in range(6)]
    off = SE3.random(key)
    moved = [off @ p for p in gt]
    assert ate_rmse(moved, gt) < 1e-4
    scaled = [p.replace(t=p.t * 0.9) for p in gt]
    assert ate_rmse(scaled, gt) > 0.05
